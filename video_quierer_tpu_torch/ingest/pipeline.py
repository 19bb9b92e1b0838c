"""Host-side ingest pipeline: parallel decode → cross-video batches
(counterpart of ``video_quierer_tpu/ingest/pipeline.py``).

- videos decode concurrently in a thread pool (OpenCV releases the GIL in
  its C++ decode), or in an opt-in spawn-context process pool;
- sampled frames flow in deterministic video order into fixed-size
  cross-video batches, so device batches stay full even when a video
  yields few frames;
- at most ``prefetch`` videos are in flight, bounding host memory;
- the pool keeps decoding batch t+1 while the engine embeds batch t, and
  one assembler thread builds the batches ahead of the engine, into a
  reused ring of slots (page-locked where CUDA is present).

Frame order — and so ``frame_id`` assignment — matches the reference's
sequential semantics: frames of video i all precede those of video i+1,
in timestamp order.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import multiprocessing
import pickle
import queue
import sys
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from video_quierer_tpu_torch.ingest.frames import extract_frames
from video_quierer_tpu_torch.utils.stageprof import span

logger = logging.getLogger(__name__)


def _interval_extract(path: Path, max_frames: int, sampling_mode: str):
    """Module-level default extractor (picklable, so the process pool can
    ship it to decode workers)."""
    return extract_frames(path, max_frames=max_frames,
                          sampling_mode=sampling_mode)


def strategy_extract(path: Path, **kw):
    """Module-level strategy extractor (picklable, as the process pool
    needs): ``ingest/samplers.py:extract_frames_strategy``."""
    from video_quierer_tpu_torch.ingest.samplers import \
        extract_frames_strategy
    return extract_frames_strategy(path, **kw)


def _make_pool(num_workers: int, num_procs: int, extract_fn):
    """Decode pool: threads by default, or a spawn-context PROCESS pool
    when ``num_procs > 0`` (spawned workers import no CUDA state; decode
    is numpy/OpenCV only). An extractor that cannot be pickled (a
    closure) keeps the thread pool, with a warning."""
    if num_procs > 0:
        try:
            pickle.dumps(extract_fn)
        except Exception:
            logger.warning(
                "decode_processes=%d requested but the extractor is not "
                "picklable (%r) — using the thread pool", num_procs,
                extract_fn)
        else:
            return ProcessPoolExecutor(
                max_workers=num_procs,
                mp_context=multiprocessing.get_context("spawn"))
    return ThreadPoolExecutor(max_workers=num_workers)


@dataclasses.dataclass
class FrameBatch:
    frames: np.ndarray          # [B, S, S, 3] uint8 RGB
    video_indices: List[int]    # index into the input ``video_paths`` list
    timestamps: List[float]

    def __len__(self) -> int:
        return self.frames.shape[0]


ExtractFn = Callable[[Path], Tuple[np.ndarray, List[float]]]

# Batch arrays the assembler reuses: the batch the consumer holds, the one
# it held before (until its next ``next()`` returns), the one waiting in
# the hand-off and the one being filled.
RING_SLOTS = 4

_END = object()


class _Ring:
    """Up to ``RING_SLOTS`` reused ``[batch_size, *frame]`` uint8 arrays,
    page-locked where CUDA is present, so that the embedder's upload of a
    batch is a pinned copy. A slot is filled again only when nothing views
    it: its owning array's reference count is back to what it read before
    any view. NumPy points the ``base`` of every view, and of every view
    of a view, at that owner, so a view a consumer keeps, however derived,
    holds its slot."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.frame_shape: Optional[Tuple[int, ...]] = None
        self.slots: List[np.ndarray] = []
        self.free_refs = 0

    def _refs(self, i: int) -> int:
        return sys.getrefcount(self.slots[i])

    def _new_slot(self) -> np.ndarray:
        # imported here: spawned decode workers import this module and need
        # no torch
        import torch
        shape = (self.batch_size, *self.frame_shape)
        if torch.cuda.is_available():
            return torch.empty(shape, dtype=torch.uint8,
                               pin_memory=True).numpy()
        return np.empty(shape, np.uint8)

    def _free_slot(self) -> Optional[np.ndarray]:
        for i in range(len(self.slots)):
            if self._refs(i) == self.free_refs:
                return self.slots[i]
        if len(self.slots) == RING_SLOTS:
            return None
        with span("frames.fresh"):
            self.slots.append(self._new_slot())
        self.free_refs = self._refs(len(self.slots) - 1)
        return self.slots[-1]

    def stack(self, pieces: List[np.ndarray], take: int) -> np.ndarray:
        """The batch's ``take`` frames, given as per-video blocks, in one
        array: copied block by block into a free slot or, where none is
        free or the frames are not the slot's uint8 frames, a fresh
        ``np.stack`` of them (with its errors)."""
        if self.frame_shape is None:
            self.frame_shape = pieces[0].shape[1:]
        slot = None
        if all(p.dtype == np.uint8 and p.shape[1:] == self.frame_shape
               for p in pieces):
            slot = self._free_slot()
        if slot is None:
            with span("frames.fresh"):
                return np.stack([f for p in pieces for f in p])
        out = slot[:take]
        a = 0
        for p in pieces:
            out[a:a + len(p)] = p
            a += len(p)
        return out


def _assembled(video_paths: Sequence[Path], pool, extract_fn: ExtractFn,
               batch_size: int, prefetch: int, stop: threading.Event
               ) -> Iterator[FrameBatch]:
    """The assembler's loop: decode results taken in submission order and
    cut into cross-video batches of ``batch_size`` (the last one ragged);
    it ends early once ``stop`` is set."""
    ring = _Ring(batch_size)
    # [frames, timestamps, video index, first frame not yet batched]
    blocks: "collections.deque[list]" = collections.deque()
    held = 0

    def cut(take: int) -> FrameBatch:
        pieces, vidx, ts = [], [], []
        need = take
        while need:
            block = blocks[0]
            frames, stamps, v, j0 = block
            j1 = min(frames.shape[0], j0 + need)
            pieces.append(frames[j0:j1])
            vidx += [v] * (j1 - j0)
            ts += stamps[j0:j1]
            need -= j1 - j0
            if j1 == frames.shape[0]:
                blocks.popleft()
            else:
                block[3] = j1
        with span("frames.stack"):
            return FrameBatch(frames=ring.stack(pieces, take),
                              video_indices=vidx, timestamps=ts)

    futures = {}
    next_submit = 0
    next_consume = 0

    def submit_upto(limit: int):
        nonlocal next_submit
        while (next_submit < len(video_paths)
               and next_submit - next_consume < limit):
            futures[next_submit] = pool.submit(
                extract_fn, Path(video_paths[next_submit]))
            next_submit += 1

    submit_upto(prefetch)
    while next_consume < len(video_paths) and not stop.is_set():
        fut = futures.pop(next_consume)
        try:
            frames, stamps = fut.result()
        except Exception:
            logger.exception("Failed to extract %s — skipping",
                             video_paths[next_consume])
        else:
            n = frames.shape[0]
            if n:
                blocks.append([frames, [stamps[j] for j in range(n)],
                               next_consume, 0])
                held += n
        next_consume += 1
        submit_upto(prefetch)
        while held >= batch_size:
            yield cut(batch_size)
            held -= batch_size
    while held and not stop.is_set():
        take = min(batch_size, held)
        yield cut(take)
        held -= take


def batched_frames(video_paths: Sequence[Path],
                   max_frames: int = 300,
                   sampling_mode: str = "high",
                   batch_size: int = 256,
                   num_workers: int = 4,
                   prefetch: int = 8,
                   extract_fn: Optional[ExtractFn] = None,
                   num_procs: int = 0,
                   ) -> Iterator[FrameBatch]:
    """Yield cross-video ``FrameBatch``es in deterministic video order;
    consumption follows submission order, never completion order, under
    either pool. A video whose extraction fails is logged and skipped.

    One assembler thread takes the decode results and builds the batches
    (``_assembled``), each video's frames copied as blocks into a reused
    slot (``_Ring``), at most two batches ahead of the consumer: one
    waiting in the hand-off, one finished. So ``next()`` mostly returns a
    batch built while the consumer embedded the last one. An error on that
    thread is raised at the consumer's next ``next()``. Closing the
    generator stops the thread and shuts the pool; videos not yet started
    are not decoded."""
    if not video_paths:
        return
    if extract_fn is None:
        extract_fn = functools.partial(_interval_extract,
                                       max_frames=max_frames,
                                       sampling_mode=sampling_mode)
    handoff: "queue.Queue" = queue.Queue(maxsize=1)
    stop = threading.Event()

    def put(item) -> bool:
        """Hand ``item`` over; False once the consumer has stopped."""
        while not stop.is_set():
            try:
                handoff.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def assemble():
        try:
            with _make_pool(num_workers, num_procs, extract_fn) as pool:
                try:
                    for batch in _assembled(video_paths, pool, extract_fn,
                                            batch_size, prefetch, stop):
                        if not put(batch):
                            return
                finally:
                    pool.shutdown(wait=False, cancel_futures=True)
        except BaseException as e:      # raised again on the consumer's side
            put(e)
        else:
            put(_END)

    thread = threading.Thread(target=assemble, name="frames-assembler",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = handoff.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()


def group_by_video(batch: FrameBatch
                   ) -> Iterator[Tuple[int, np.ndarray, List[float]]]:
    """Split a batch into contiguous same-video runs (order-preserving)."""
    if len(batch) == 0:
        return
    start = 0
    for i in range(1, len(batch) + 1):
        if i == len(batch) or batch.video_indices[i] != \
                batch.video_indices[start]:
            yield (batch.video_indices[start], batch.frames[start:i],
                   batch.timestamps[start:i])
            start = i
