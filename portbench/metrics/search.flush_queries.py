"""Queries a coalesced flush carries: the engine's ``searches`` counter
over its ``pipelined_flushes`` counter, across the window (the
coalescer's layer, ``engine/batching.py``)."""


def read(r):
    flushes = r.counters.get("pipelined_flushes", 0)
    if not flushes:
        return None
    return r.counters.get("searches", 0) / flushes
