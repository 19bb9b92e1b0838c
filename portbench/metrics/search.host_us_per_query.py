"""Host microseconds a query spends in the serving path's stages: the
stage spans ``lock_wait``, ``tokenize``, ``dispatch``, ``resolve``,
``format`` and ``deliver`` (``utils/stageprof.py``, on in traced runs)
summed over the window, over the engine's ``searches`` counter."""

STAGES = ("lock_wait", "tokenize", "dispatch", "resolve", "format",
          "deliver")


def read(r):
    searches = r.counters.get("searches", 0)
    if not searches or not all(s in r.spans for s in STAGES):
        return None
    return 1e6 * sum(r.spans[s][1] for s in STAGES) / searches
