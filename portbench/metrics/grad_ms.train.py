"""Device ms per traced step outside the optimizer's, the bus's and the
statistics' ranges: the vmapped gradient of the loss (and the token feed)."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or not t.get("n_device_events"):
        return None
    inside = sum(t["ranges"].get(f"portbench.{n}", [0, 0.0])[1] for n in ("optim", "mix", "stats"))
    return 1e3 * (t["device_s"] - inside) / t["steps"]
