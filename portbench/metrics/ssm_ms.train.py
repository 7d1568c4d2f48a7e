"""Device ms per traced step launched inside the ``portbench.ssm`` range:
the Mamba-2 mixers (``models/ssm.py mamba2_apply``, swapped by
``drivers/train_ranges``), their forward and remat's recompute; their
backward, which autograd's device thread launches, is not in it."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or "portbench.ssm" not in t.get("ranges", {}):
        return None
    ms = 1e3 * t["ranges"]["portbench.ssm"][1] / t["steps"]
    return ms if ms > 0 else None
