"""Pre-pass lanes answered from packed blocks by the ``hybrid_search``
kernel (the backend's ``blk_hits``), as a share of the ops answered in
the traced window."""


def read(rec):
    if not rec["window_ops"] or "blk_hits" not in rec["stats"]:
        return None
    return 100.0 * rec["stats"]["blk_hits"] / rec["window_ops"]
