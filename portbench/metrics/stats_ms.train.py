"""Device ms per traced step launched inside the ``portbench.stats`` range."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or "portbench.stats" not in t.get("ranges", {}):
        return None
    ms = 1e3 * t["ranges"]["portbench.stats"][1] / t["steps"]
    return ms if ms > 0 else None
