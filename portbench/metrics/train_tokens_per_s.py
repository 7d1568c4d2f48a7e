"""Tokens of all M workers in the window's steps over the window's wall time,
which ends in a synchronize (host clock)."""


def read(run):
    if run["kind"] != "train":
        return None
    return run["tokens"] / run["window_s"]
