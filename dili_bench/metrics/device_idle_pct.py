"""The share of the profiler stretch in which no operation ran on the
card, averaged over the cell's cards."""


def read(rec):
    p = rec.get("profile")
    if not p or p["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
