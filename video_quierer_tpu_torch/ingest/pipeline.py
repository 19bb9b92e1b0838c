"""Host-side ingest pipeline: parallel decode → cross-video batches
(counterpart of ``video_quierer_tpu/ingest/pipeline.py``).

- videos decode concurrently in a thread pool (OpenCV releases the GIL in
  its C++ decode), or in an opt-in spawn-context process pool;
- sampled frames flow in deterministic video order into fixed-size
  cross-video batches, so device batches stay full even when a video
  yields few frames;
- at most ``prefetch`` videos are in flight, bounding host memory;
- the pool keeps decoding batch t+1 while the engine embeds batch t.

Frame order — and so ``frame_id`` assignment — matches the reference's
sequential semantics: frames of video i all precede those of video i+1,
in timestamp order.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import multiprocessing
import pickle
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
    either pool. A video whose extraction fails is logged and skipped."""
    if not video_paths:
        return
    if extract_fn is None:
        extract_fn = functools.partial(_interval_extract,
                                       max_frames=max_frames,
                                       sampling_mode=sampling_mode)

    buf_frames: List[np.ndarray] = []
    buf_vidx: List[int] = []
    buf_ts: List[float] = []

    def drain(force: bool) -> Iterator[FrameBatch]:
        nonlocal buf_frames, buf_vidx, buf_ts
        while len(buf_frames) >= batch_size or (force and buf_frames):
            take = min(batch_size, len(buf_frames))
            with span("frames.stack"):
                batch = FrameBatch(frames=np.stack(buf_frames[:take]),
                                   video_indices=buf_vidx[:take],
                                   timestamps=buf_ts[:take])
            yield batch
            buf_frames = buf_frames[take:]
            buf_vidx = buf_vidx[take:]
            buf_ts = buf_ts[take:]

    with _make_pool(num_workers, num_procs, extract_fn) as pool:
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
        while next_consume < len(video_paths):
            fut = futures.pop(next_consume)
            try:
                frames, stamps = fut.result()
            except Exception:
                logger.exception("Failed to extract %s — skipping",
                                 video_paths[next_consume])
                frames = np.zeros((0, 224, 224, 3), np.uint8)
                stamps = []
            for j in range(frames.shape[0]):
                buf_frames.append(frames[j])
                buf_vidx.append(next_consume)
                buf_ts.append(stamps[j])
            next_consume += 1
            submit_upto(prefetch)
            yield from drain(force=False)
        yield from drain(force=True)


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
