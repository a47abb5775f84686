"""Seconds from the start of the process to the window: imports, the
kernels' build where it is not cached, the load, the settle and the
warm rounds."""


def read(rec):
    return rec["setup_s"]
