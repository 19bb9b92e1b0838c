"""Host spans of the port's hot paths: per-name accumulators and a
bounded event log, on the clock of ``torch.profiler``'s trace.

Off by default: a span is then one module-level check that returns a
shared no-op context, cheap enough to leave in every hot path. It is on
when ``VQT_SERVING_PROFILE=1`` is set at import, or after
:func:`enable` (``/api/profiler/start`` turns it on for a trace).

An enabled span adds its seconds to ``snapshot()``'s ``{name: (calls,
seconds)}`` and logs one :class:`Event`: its name, its start and end in
``time.time_ns()`` units (the clock of the profiler's Kineto events, so
the log lines up with the kernels of a trace taken at the same time),
the thread, the enclosing span on that thread, and the unit of work the
thread is on (:func:`unit`: an ingest batch, a training step, a
coalesced flush). The log keeps the last ``LOG_CAP`` events and counts
those it dropped; :func:`events` reads it, :func:`write_chrome_trace`
writes it for Perfetto.

Spans, by module:

engine/batching.py (the coalescer; unit: its flush number)
  lock_wait      the dispatcher blocking on the engine's read lock
  resolve        the flush's results fetched and rows built
  format         result shaping per flush
  deliver        the futures answered
engine/system.py
  tokenize       BPE encode and id preparation of a flush's chunk
  dispatch       the chunk's device work enqueued (host cost only)
  ingest.next    the ingest loop waiting on the frame pipeline for its
                 next batch (unit: the engine's batch number)
  ingest.append  a batch's per-video host appends and its device append
ingest/pipeline.py (``batched_frames``' assembler thread; no unit)
  frames.stack   a batch's frames copied into one array, ahead of the
                 loop's ``ingest.next`` that takes the batch
  frames.fresh   inside ``frames.stack``: a new array made for the batch,
                 a ring slot's first fill or, with no slot free, a fresh
                 ``np.stack``; 1 - its count over ``frames.stack``'s is
                 the share of batches built in a reused slot
models/clip/embedder.py
  embed.fetch    the host waiting for the vision tower and copying the
                 batch's rows back (``embed_frames_device``)
index/device_index.py (``search_batch_fused_async``: host time, the
device work is enqueued; ``results`` waits for the device)
  mirror_sync    the device mirror and re-rank store synced
  encode         ids upload, text tower, normalisation
  scan           the mirror's scan and merge
  rerank         the device exact f32 re-rank
  results        device-to-host copies and row building
train/trainer.py (``CLIPTrainer.step``; unit: the step number)
  train.forward    the towers and the loss enqueued
  train.backward   autograd's backward enqueued
  train.optimizer  the AdamW update (and EMA) enqueued
  train.loss_fetch the loss copied to the host: the step's one wait on
                   the device
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

ENABLED = os.environ.get("VQT_SERVING_PROFILE") == "1"
LOG_CAP = 65_536


class Event(NamedTuple):
    name: str
    t0_ns: int                  # time.time_ns() at the span's start
    t1_ns: int                  # ... and at its end
    thread: int                 # threading.get_native_id()
    parent: Optional[str]       # the enclosing span on that thread
    unit: Optional[int]         # the unit of work the thread was on


_lock = threading.Lock()
_stats: Dict[str, list] = {}
_log: "collections.deque[Event]" = collections.deque(maxlen=LOG_CAP)
_dropped = 0


class _Thread(threading.local):
    """A thread's id, its open spans (names, innermost last) and its
    unit."""

    def __init__(self):
        self.id = threading.get_native_id()
        self.stack: List[str] = []
        self.unit: Optional[int] = None


_tls = _Thread()


class _Span:
    __slots__ = ("name", "t0", "parent")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _tls.stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.time_ns()
        tls = _tls
        tls.stack.pop()
        ev = Event(self.name, self.t0, t1, tls.id, self.parent, tls.unit)
        dt = (t1 - self.t0) / 1e9
        with _lock:
            s = _stats.get(self.name)
            if s is None:
                _stats[self.name] = [1, dt]
            else:
                s[0] += 1
                s[1] += dt
            if len(_log) == LOG_CAP:
                _dropped += 1
            _log.append(ev)
        return False


class _Unit:
    __slots__ = ("id", "prev")

    def __init__(self, uid: int):
        self.id = uid

    def __enter__(self):
        self.prev, _tls.unit = _tls.unit, self.id
        return self

    def __exit__(self, *exc):
        _tls.unit = self.prev
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def enable(on: bool) -> None:
    """Switch spans on or off for the whole process."""
    global ENABLED
    ENABLED = bool(on)


def span(name: str):
    """Context manager timing the block under ``name`` (a shared no-op
    while spans are off)."""
    return _Span(name) if ENABLED else _NULL


def unit(uid: int):
    """Context manager: the spans this thread records inside carry
    ``uid`` (a no-op while spans are off)."""
    return _Unit(uid) if ENABLED else _NULL


def snapshot() -> Dict[str, Tuple[int, float]]:
    """``{name: (calls, seconds)}`` since the last :func:`reset`."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _stats.items()}


def events(since_ns: int = 0) -> Tuple[List[Event], int]:
    """The logged events that ended at or after ``since_ns``, oldest end
    first, and how many events the full log has dropped since the last
    :func:`reset` (every dropped event ended before the first event the
    log still holds)."""
    with _lock:
        evs, dropped = list(_log), _dropped
    return [e for e in evs if e.t1_ns >= since_ns], dropped


def reset() -> None:
    """Clear the accumulators, the log and its dropped count."""
    global _dropped
    with _lock:
        _stats.clear()
        _log.clear()
        _dropped = 0


def write_chrome_trace(path, evs: List[Event], base_ns: int = 0) -> None:
    """``evs`` as a Chrome trace (complete events, microseconds after
    ``base_ns``, this process's id, the native thread ids). Given the
    ``baseTimeNanoseconds`` of a ``torch.profiler`` trace, the events'
    times are that trace's, and its ``traceEvents`` and these load as one
    timeline."""
    pid = os.getpid()
    trace = {"displayTimeUnit": "ms", "baseTimeNanoseconds": base_ns,
             "traceEvents": [
                 {"ph": "X", "cat": "stageprof", "name": e.name, "pid": pid,
                  "tid": e.thread, "ts": (e.t0_ns - base_ns) / 1e3,
                  "dur": (e.t1_ns - e.t0_ns) / 1e3,
                  "args": {"parent": e.parent, "unit": e.unit}}
                 for e in evs]}
    Path(path).write_text(json.dumps(trace))
