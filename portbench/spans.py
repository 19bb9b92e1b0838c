"""Reading the program's own spans (``video_quierer_tpu_torch/utils/
stageprof.py``, on in traced runs) for per-layer metrics: a span's host
time per ingest batch or training step, and the share of the traced
slice's device-idle time that fell inside given spans.

The program logs each span's start and end in ``time.time_ns()`` units,
the clock of the profiler's Kineto events, so a span and the slice's
device operations (``Slice.ops``, microseconds on that clock) compare
directly. A program that logs no events (``stageprof.events`` missing),
a span never logged, and a slice whose stretch the log no longer holds
whole all read None.
"""

from __future__ import annotations

import collections

from portbench.trace import _busy

STEP = ("train.forward", "train.backward", "train.optimizer",
        "train.loss_fetch")
LAUNCH = STEP[:3]


def ms_per_batch(r, name: str):
    """Host milliseconds per ingest batch in span ``name``: its seconds in
    the window's span delta over the window's batches."""
    n = r.host.get("batches", 0)
    calls, seconds = r.spans.get(name, (0, 0.0))
    if not n or not calls:
        return None
    return 1e3 * seconds / n


def _log():
    """``stageprof.events`` of the program, or None where it has none."""
    try:
        from video_quierer_tpu_torch.utils import stageprof
    except ImportError:
        return None
    return getattr(stageprof, "events", None)


def slice_events(r):
    """``(events, lo_ns, hi_ns)``: the logged events that overlap the
    traced slice's device operations, from the first one's start to the
    last one's end; None without device operations or a log, or where
    the log dropped events that ended after ``lo_ns``."""
    s = r.slice
    events = _log()
    if s is None or not s.ops or events is None:
        return None
    lo = s.ops[0].start_us * 1e3
    hi = max(o.end_us for o in s.ops) * 1e3
    evs, dropped = events()
    # the log drops its oldest first: what it dropped ended before the
    # first event it holds
    if dropped and (not evs or evs[0].t1_ns > lo):
        return None
    return [e for e in evs if e.t1_ns >= lo and e.t0_ns <= hi], lo, hi


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(gaps, spans) -> float:
    """Length of the parts of ``gaps`` inside ``spans``: both sorted
    lists of disjoint ``(start, end)``."""
    total, j = 0.0, 0
    for a, b in gaps:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            total += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return total


def idle_inside_pct(r, names):
    """Of the slice's device-idle time (the gaps between its device
    operations), the share inside spans ``names`` on the thread that
    logged most of them (the loop's or the trainer's)."""
    got = slice_events(r)
    if got is None:
        return None
    mine = [e for e in got[0] if e.name in names]
    if not mine:
        return None
    thread = collections.Counter(e.thread for e in mine).most_common(1)[0][0]
    spans = _merged((e.t0_ns / 1e3, e.t1_ns / 1e3) for e in mine
                    if e.thread == thread)
    _, gaps = _busy(r.slice.ops)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    return 100.0 * _overlap(gaps, spans) / idle


def step_ms(r, names):
    """Host milliseconds a training step spends in spans ``names``, over
    the steps whose four spans (``STEP``) all lie within the slice's
    device operations, told apart by their step number."""
    got = slice_events(r)
    if got is None:
        return None
    evs, lo, hi = got
    steps = collections.defaultdict(dict)
    for e in evs:
        if e.name in STEP and e.unit is not None and lo <= e.t0_ns \
                and e.t1_ns <= hi:
            steps[e.unit][e.name] = e.t1_ns - e.t0_ns
    whole = [s for s in steps.values() if len(s) == len(STEP)]
    if not whole:
        return None
    return sum(s[n] for s in whole for n in names) / 1e6 / len(whole)
