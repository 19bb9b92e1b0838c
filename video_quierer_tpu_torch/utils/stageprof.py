"""Opt-in serving-path stage profiler (``VQT_SERVING_PROFILE=1``).

Copy of ``video_quierer_tpu/utils/stageprof.py`` for the PyTorch
port, which cannot import the JAX package (its ``__init__`` imports
jax); keep the two in step.

Round-4 VERDICT weak item 4: engine-true serving runs at ~1/5 of the
device ceiling on a 1-core host and no per-stage host profile existed.
cProfile is per-thread (the coalescer spans three thread roles) and
py-spy isn't in the image, so the serving path carries its own
cumulative wall-clock accumulators: cheap enough to leave compiled in
(a disabled span is one module-bool check returning a shared no-op
context), precise enough to name where each µs/query goes.

Spans (wired in engine/system.py + engine/batching.py):
  lock_wait      dispatcher blocking on the engine read lock
  tokenize       BPE encode + id prep for one flush
  dispatch       fused-executable enqueue (async — host cost only)
  resolve        device-result materialization + row building
  format         reference result shaping per flush
  deliver        future set_result fan-out (waker wake-ups)

and inside index/device_index.py:search_batch_fused_async (host time:
the device work is enqueued, so these show host-side costs such as
allocator growth or a kernel's first load; ``results`` waits for the
device):
  mirror_sync    device mirror / re-rank store sync under the sync lock
  encode         ids upload, text tower, normalisation
  scan           the mirror's scan and merge
  rerank         the device exact f32 re-rank
  results        device-to-host copies and row building
and engine/system.py:_warm_up:
  warm_up        startup's run of the fused search path
and index/device_index.py:save_to_disk (the pickle cache's write):
  save_payload   the v1.0 payload (a row array and a dict per frame)
  save_pickle    pickle.dumps of it
  save_write     the file written
  save_checksum  its SHA-256 sidecar

``snapshot()`` returns {name: (calls, seconds)}; serving_bench prints
per-phase deltas as µs/query.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Tuple

ENABLED = os.environ.get("VQT_SERVING_PROFILE") == "1"

_lock = threading.Lock()
_stats: Dict[str, list] = {}


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        with _lock:
            s = _stats.get(self.name)
            if s is None:
                _stats[self.name] = [1, dt]
            else:
                s[0] += 1
                s[1] += dt
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str):
    """Context manager accumulating wall time under ``name`` (no-op
    unless VQT_SERVING_PROFILE=1)."""
    return _Span(name) if ENABLED else _NULL


def snapshot() -> Dict[str, Tuple[int, float]]:
    with _lock:
        return {k: (v[0], v[1]) for k, v in _stats.items()}


def reset() -> None:
    with _lock:
        _stats.clear()
