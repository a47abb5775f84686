"""Per-phase step functions of the background engine (Split on this slice)."""
