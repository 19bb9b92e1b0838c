"""Sampling strategies beyond the interval rule (a copy of
``video_quierer_tpu/ingest/samplers.py``, on the port's
``ops/preprocess.py``):

- :class:`UniformSampler` — seek-based fixed count over the duration.
- :class:`AdaptiveSampler` — scene-change detection (mean-squared frame
  difference + χ² histogram distance) with a minimum-interval gate.
- :class:`HybridSampler` — union of both, de-duplicated by timestamp.
- :func:`passes_quality_filter` — brightness band + Laplacian-variance
  blur rejection.
- :func:`choose_strategy` — duration heuristic: short videos sample
  uniformly, very long ones adaptively, medium hybrid.

All samplers yield ``(rgb_224 uint8, timestamp)`` like
``frames.iter_sampled_frames`` so the batching pipeline is agnostic.
``cv2`` is imported inside the functions that decode: the port imports
no OpenCV until a video is opened.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from video_quierer_tpu_torch.ops.preprocess import resize_shorter_side_and_crop

logger = logging.getLogger(__name__)

FramePair = Tuple[np.ndarray, float]


def passes_quality_filter(gray: np.ndarray,
                          min_brightness: float = 20.0,
                          max_brightness: float = 235.0,
                          blur_threshold: float = 100.0) -> bool:
    """Reject washed-out and blurry frames (the quality gate)."""
    import cv2
    mean = float(gray.mean())
    if mean < min_brightness or mean > max_brightness:
        return False
    return cv2.Laplacian(gray, cv2.CV_64F).var() >= blur_threshold


class UniformSampler:
    """Seek to ``count`` evenly spaced frame positions."""

    def __init__(self, count: int = 100, target_size: int = 224,
                 quality_filter: bool = False):
        self.count = count
        self.target_size = target_size
        self.quality_filter = quality_filter

    def sample(self, video_path: Path) -> Iterator[FramePair]:
        import cv2
        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            return
        try:
            fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if total <= 0:
                return
            positions = np.linspace(0, total - 1, min(self.count, total),
                                    dtype=np.int64)
            for pos in positions:
                cap.set(cv2.CAP_PROP_POS_FRAMES, int(pos))
                ok, frame = cap.read()
                if not ok:
                    continue
                if self.quality_filter:
                    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                    if not passes_quality_filter(gray):
                        continue
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                ts = float(pos) / (fps if fps > 0 else 30.0)
                yield resize_shorter_side_and_crop(rgb, self.target_size), ts
        finally:
            cap.release()


class AdaptiveSampler:
    """Keep frames at scene changes.

    A decoded frame is kept when either detector fires — mean-squared
    difference of downscaled grayscale, or χ² distance between gray
    histograms — and at least ``min_interval_s`` has passed since the last
    kept frame. The first frame is always kept.
    """

    def __init__(self, mse_threshold: float = 500.0,
                 chi2_threshold: float = 0.25,
                 min_interval_s: float = 0.5,
                 max_frames: int = 1000,
                 target_size: int = 224,
                 decode_stride: int = 2,
                 quality_filter: bool = False):
        self.mse_threshold = mse_threshold
        self.chi2_threshold = chi2_threshold
        self.min_interval_s = min_interval_s
        self.max_frames = max_frames
        self.target_size = target_size
        self.decode_stride = max(1, decode_stride)
        self.quality_filter = quality_filter

    @staticmethod
    def _chi2(h1: np.ndarray, h2: np.ndarray) -> float:
        denom = h1 + h2
        denom[denom == 0] = 1.0
        return float(0.5 * ((h1 - h2) ** 2 / denom).sum())

    def sample(self, video_path: Path) -> Iterator[FramePair]:
        import cv2
        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            return
        try:
            fps = cap.get(cv2.CAP_PROP_FPS)
            fps_eff = fps if fps > 0 else 30.0
            prev_small: Optional[np.ndarray] = None
            prev_hist: Optional[np.ndarray] = None
            last_kept_ts = -1e9
            kept = 0
            frame_number = 0
            while kept < self.max_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                if frame_number % self.decode_stride == 0:
                    ts = frame_number / fps_eff
                    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                    small = cv2.resize(gray, (64, 64)).astype(np.float32)
                    hist = cv2.calcHist([gray], [0], None, [32],
                                        [0, 256]).ravel()
                    hist = hist / max(1.0, hist.sum())
                    is_change = prev_small is None
                    if prev_small is not None:
                        mse = float(((small - prev_small) ** 2).mean())
                        chi2 = self._chi2(hist, prev_hist)
                        is_change = (mse > self.mse_threshold
                                     or chi2 > self.chi2_threshold)
                    keep = (is_change
                            and ts - last_kept_ts >= self.min_interval_s)
                    if keep and self.quality_filter:
                        keep = passes_quality_filter(gray)
                    if keep:
                        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                        yield (resize_shorter_side_and_crop(
                            rgb, self.target_size), ts)
                        last_kept_ts = ts
                        kept += 1
                    prev_small, prev_hist = small, hist
                frame_number += 1
        finally:
            cap.release()


class HybridSampler:
    """Uniform coverage + adaptive scene peaks, deduped by timestamp."""

    def __init__(self, uniform_count: int = 50,
                 adaptive: Optional[AdaptiveSampler] = None,
                 dedup_window_s: float = 0.25,
                 target_size: int = 224,
                 quality_filter: bool = False):
        self.uniform = UniformSampler(uniform_count,
                                      target_size=target_size,
                                      quality_filter=quality_filter)
        self.adaptive = adaptive or AdaptiveSampler(
            target_size=target_size, quality_filter=quality_filter)
        self.dedup_window_s = dedup_window_s

    def sample(self, video_path: Path) -> Iterator[FramePair]:
        frames: List[FramePair] = list(self.uniform.sample(video_path))
        frames.extend(self.adaptive.sample(video_path))
        frames.sort(key=lambda p: p[1])
        last_ts = -1e9
        for frame, ts in frames:
            if ts - last_ts >= self.dedup_window_s:
                yield frame, ts
                last_ts = ts


def choose_strategy(duration_s: float):
    """Duration heuristic: < 5 min →
    uniform; > 1 h → adaptive; otherwise hybrid."""
    if duration_s < 300:
        return UniformSampler()
    if duration_s > 3600:
        return AdaptiveSampler()
    return HybridSampler()


def _auto_strategy_name(video_path: Path) -> str:
    """Resolve "auto" to a concrete strategy via the duration heuristic."""
    import cv2
    cap = cv2.VideoCapture(str(video_path))
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        total = cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0
    finally:
        cap.release()
    duration = total / fps if fps > 0 else 0.0
    if duration < 300:
        return "uniform"
    if duration > 3600:
        return "adaptive"
    return "hybrid"


def build_sampler(strategy: str, max_frames: int, target_size: int = 224,
                  quality_filter: bool = False):
    """Instantiate a sampler for an engine-config strategy name, sized to
    the API tier's ``max_frames`` budget."""
    if strategy == "uniform":
        return UniformSampler(count=max_frames, target_size=target_size,
                              quality_filter=quality_filter)
    if strategy == "adaptive":
        return AdaptiveSampler(max_frames=max_frames,
                               target_size=target_size,
                               quality_filter=quality_filter)
    if strategy == "hybrid":
        return HybridSampler(uniform_count=max(1, max_frames // 2),
                             adaptive=AdaptiveSampler(
                                 max_frames=max_frames,
                                 target_size=target_size,
                                 quality_filter=quality_filter),
                             target_size=target_size,
                             quality_filter=quality_filter)
    raise ValueError(f"unknown sampling strategy {strategy!r}")


def extract_frames_strategy(video_path: Path, strategy: str,
                            max_frames: int = 300,
                            sampling_mode: str = "high",
                            target_size: int = 224,
                            quality_filter: bool = False
                            ) -> Tuple[np.ndarray, List[float]]:
    """Array-returning façade matching ``frames.extract_frames`` so the
    batching pipeline (ingest/pipeline.py) can consume any strategy.

    This is the engine's entry point for ``ingest.sampling_strategy``
    (engine/config.py). ``interval`` keeps the interval rule
    (ingest/frames.py) and applies the quality gate post-hoc on the 224px
    crops; the other strategies decode via OpenCV on the host.
    """
    if strategy == "auto":
        strategy = _auto_strategy_name(Path(video_path))
    if strategy == "interval":
        from video_quierer_tpu_torch.ingest.frames import extract_frames
        frames, stamps = extract_frames(video_path, max_frames=max_frames,
                                        sampling_mode=sampling_mode)
        if quality_filter and frames.shape[0]:
            import cv2
            keep = [i for i in range(frames.shape[0])
                    if passes_quality_filter(
                        cv2.cvtColor(frames[i], cv2.COLOR_RGB2GRAY))]
            frames = frames[keep]
            stamps = [stamps[i] for i in keep]
        return frames, stamps
    sampler = build_sampler(strategy, max_frames, target_size,
                            quality_filter)
    out_frames: List[np.ndarray] = []
    out_ts: List[float] = []
    for frame, ts in sampler.sample(Path(video_path)):
        out_frames.append(frame)
        out_ts.append(ts)
        if len(out_frames) >= max_frames:
            break
    if not out_frames:
        return np.zeros((0, target_size, target_size, 3), np.uint8), []
    return np.stack(out_frames), out_ts
