"""Device ms per traced step launched inside the ``portbench.optim`` range."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or "portbench.optim" not in t.get("ranges", {}):
        return None
    ms = 1e3 * t["ranges"]["portbench.optim"][1] / t["steps"]
    return ms if ms > 0 else None
