"""Helpers the metric readers share."""
from __future__ import annotations


def per_round_ms(rec: dict, *spans: str):
    """Milliseconds a round spent in ``spans`` (summed over the servers)
    in the traced window's timer stretch, or None where none ran."""
    seconds = rec.get("spans", {})
    if not rec.get("timer_rounds") or not any(s in seconds for s in spans):
        return None
    return 1e3 * sum(seconds.get(s, 0.0) for s in spans) \
        / rec["timer_rounds"]
