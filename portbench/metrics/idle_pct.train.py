"""Share of a timed step in which no operation ran on the card, training:
1 − (the card's busy seconds per step, from a traced window in which only
the card's activity is recorded, ``trace.device_only``) ÷ (the timed
window's seconds per step). The timed window sets the step's length, since
even a trace of the card alone slows the host's launches; the trace sets
only how long the card was busy. Where the card never idles, the profiler's
own cost on each kernel can take the reading a few tenths of a percent
below zero."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "train" or not t or not t["busy"].get("n_device_events"):
        return None
    busy_per_step = t["busy"]["busy_s"] / t["steps"]
    return 100.0 * (1.0 - busy_per_step / (run["window_s"] / run["steps"]))
