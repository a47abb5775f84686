"""95th percentile, over every op answered in the window, of the time
from its submission to the end of the round that answered it (host
clock)."""
import numpy as np


def read(rec):
    lat = rec["latency_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat.size else None
