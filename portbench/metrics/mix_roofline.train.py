"""The consensus mix's share of its memory roofline: the least bytes a mix
of M replicas and their updates must move (params and updates read once,
the result written once: 3·M·P elements of the configured dtype, counted
from the configuration's shapes) at 3.35 TB/s, over the device time of
everything launched inside ``core.bus.mix_bus`` per traced step."""
from portbench import yardstick as Y


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or "portbench.mix" not in t.get("ranges", {}):
        return None
    count, device_s = t["ranges"]["portbench.mix"]
    if not device_s:
        return None
    bound_s = Y.mix_bytes(run["cfg"], run["mix"]["workers"]) / Y.HBM_BYTES_PER_S
    return 100.0 * bound_s * count / device_s
