"""``hybrid_search``'s share of its roofline in the profiler stretch:
the mean least time of the calls the program made (``roofline.py``, from
each call's own inputs) over the mean device time of one
``hybrid_search_kernel``. Means, so that a trace that drops events does
not bias the share."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["hs_calls"] or not p["hs_kernel_events"] \
            or p["hs_kernel_s"] <= 0:
        return None
    least = p["hs_least_s"] / p["hs_calls"]
    return 100.0 * least / (p["hs_kernel_s"] / p["hs_kernel_events"])
