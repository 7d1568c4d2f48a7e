"""``max_memory_allocated`` over the window, after ``reset_peak_memory_stats``, in GB."""


def read(run):
    if run["kind"] != "train":
        return None
    return run["peak_bytes"] / 1e9
