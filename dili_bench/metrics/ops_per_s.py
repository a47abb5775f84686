"""Ops answered in the window per second of the window (host clock)."""


def read(rec):
    return rec["window_ops"] / rec["window_s"] if rec["window_ops"] else None
