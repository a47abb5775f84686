"""Megabytes (10**6 bytes) the host read from the card (``timing.crossed``),
per round of the traced window's timer stretch, summed over the spans and
the servers: the program's ``to_host_bytes`` counter on the newest
``timing.PhaseTimer``, the stretch's own."""


def read(rec):
    try:
        from repro_torch.timing import latest
    except ImportError:                 # a program without counters
        return None
    timer = latest()
    if timer is None or not rec.get("timer_rounds") \
            or dict(timer.seconds) != rec.get("spans"):
        return None
    n = timer.total("to_host_bytes")
    return None if n is None else n / 1e6 / rec["timer_rounds"]
