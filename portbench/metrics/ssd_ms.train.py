"""Device ms per traced step launched inside the ``portbench.scan`` range:
the SSD's chunked scan (``models/ssm.py ssd_chunked``, swapped by
``drivers/train_ranges``), in the forward and remat's recompute; a part of
``ssm_ms.train``."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or "portbench.scan" not in t.get("ranges", {}):
        return None
    ms = 1e3 * t["ranges"]["portbench.scan"][1] / t["steps"]
    return ms if ms > 0 else None
