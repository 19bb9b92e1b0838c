"""The 95th percentile of the window's search latencies, taken by each
client from sending to its answer (all searches of the traced run)."""

import numpy as np


def read(r):
    lat = r.host.get("latencies_ms") or []
    if len(lat) < 200:
        return None
    return float(np.percentile(np.asarray(lat), 95))
