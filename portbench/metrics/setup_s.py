"""Set-up time: process start to the start of the measured window (host clock)."""


def read(run):
    return run["setup_s"]
