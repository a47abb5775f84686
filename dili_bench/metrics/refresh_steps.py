"""Steps of the packed-block refresh walk (``blocks.refresh_blocks``; each
step one host read of its early exit), per round of the traced window's
timer stretch, summed over the servers: the program's ``refresh_steps``
counter on the newest ``timing.PhaseTimer``, the stretch's own."""


def read(rec):
    try:
        from repro_torch.timing import latest
    except ImportError:                 # a program without counters
        return None
    timer = latest()
    if timer is None or not rec.get("timer_rounds") \
            or dict(timer.seconds) != rec.get("spans"):
        return None
    n = timer.total("refresh_steps")
    return None if n is None else n / rec["timer_rounds"]
