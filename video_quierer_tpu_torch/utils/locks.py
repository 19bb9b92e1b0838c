"""Reader-writer lock for the engine's search/mutation discipline.

Copy of ``video_quierer_tpu/utils/locks.py`` for the PyTorch
port, which cannot import the JAX package (its ``__init__`` imports
jax); keep the two in step.

The reference serialized nothing (it ran two unsynchronized engine
singletons, SURVEY.md §3.1); round 1 of this rebuild serialized
*everything* behind one RLock, so concurrent searches queued even though
they only read the index. Searches are reads — they can safely pipeline
on the device — while ingest/delete/load must be exclusive.

``RWLock`` is writer-preferring (arriving readers wait once a writer is
queued, so bulk ingest can't be starved by a search stream) and
write-reentrant (mutation paths nest: ``rebuild`` → ``_ingest``). A thread
holding the write lock may take the read lock as a no-op.

Read holds are thread-agnostic (a plain reader count), so a read lock MAY
be handed across threads: the serving coalescer's dispatcher acquires it
and its resolver thread releases it, keeping index rows pinned while
device results are in flight (engine/batching.py). Reads are NOT
reentrant per-thread — a thread already holding a read must not
re-acquire (a queued writer would deadlock against it); the engine's
``_search_batch_impl`` split exists for that reason.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writers_waiting = 0
        self._write_owner: int | None = None
        self._write_depth = 0

    # -- read side -------------------------------------------------------

    def acquire_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._write_owner == me:
                return  # write lock already grants read access
            while self._write_owner is not None or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._write_owner == me:
                return
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    # -- write side ------------------------------------------------------

    def acquire_write(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._write_owner == me:
                self._write_depth += 1
                return
            self._writers_waiting += 1
            try:
                while self._write_owner is not None or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._write_owner = me
            self._write_depth = 1

    def release_write(self) -> None:
        with self._cond:
            if self._write_owner != threading.get_ident():
                raise RuntimeError("release_write by non-owner thread")
            self._write_depth -= 1
            if self._write_depth == 0:
                self._write_owner = None
                self._cond.notify_all()

    # -- context managers --------------------------------------------------

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()

    # ``with lock:`` == exclusive (write) access, so pre-RWLock call sites
    # keep their semantics.
    def __enter__(self):
        self.acquire_write()
        return self

    def __exit__(self, *exc):
        self.release_write()
        return False
