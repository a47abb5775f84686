"""Reads of a card's tensor by the host, each of which waits for the card
(``timing.crossed``: the walks' early exits, the round's transfers, the
serial loop's and the balancer's column copies), per round of the traced
window's timer stretch, summed over the spans and the servers: the
program's ``host_reads`` counter on the newest ``timing.PhaseTimer``, the
stretch's own."""


def read(rec):
    try:
        from repro_torch.timing import latest
    except ImportError:                 # a program without counters
        return None
    timer = latest()
    if timer is None or not rec.get("timer_rounds") \
            or dict(timer.seconds) != rec.get("spans"):
        return None
    n = timer.total("host_reads")
    return None if n is None else n / rec["timer_rounds"]
