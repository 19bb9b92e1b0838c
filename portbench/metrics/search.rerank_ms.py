"""Host milliseconds a flush spends in the re-rank and the results
(stage spans ``rerank`` and ``results``, ``index/device_index.py``)
over the window's ``pipelined_flushes``."""


def read(r):
    flushes = r.counters.get("pipelined_flushes", 0)
    if not flushes or "results" not in r.spans:
        return None
    spent = sum(r.spans.get(s, (0, 0.0))[1] for s in ("rerank", "results"))
    return 1e3 * spent / flushes
