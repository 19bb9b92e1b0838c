"""Frame extraction with the reference's sampling semantics (counterpart of
``video_quierer_tpu/ingest/frames.py``).

====================  =========================================
mode                  interval
====================  =========================================
``ultra_high``        ``max(1, total_frames // (max_frames * 2))``
``high``              ``max(1, total_frames // max_frames)``
``medium``            ``max(1, total_frames // (max_frames // 2))``
``low`` (default)     ``max(1, total_frames // (max_frames // 4))``
====================  =========================================

A frame is kept when ``frame_number % interval == 0``; extraction stops
once ``max_frames`` are collected; ``timestamp = frame_number / fps`` with
the reference's ``fps <= 0 → 30`` fallback. Each kept frame is converted
BGR→RGB and resized to the CLIP input geometry at once (shortest-edge
bicubic + centre crop, ``ops/preprocess.py``), so decode emits fixed-shape
uint8 RGB frames ready for the device.

``extract_frames`` has two decode tiers, as in the JAX package: the
OpenCV streaming path (the default) and the native FFmpeg/C++ tier
(``ingest/native.py`` over ``native/decoder.cpp``), taken with
``use_native=True`` or ``VQT_NATIVE_DECODE=1``; where the library cannot
be built or loaded, or a video does not probe or decode there, the OpenCV
path serves.

``cv2`` is imported inside the functions that decode: the port imports no
OpenCV until a video is opened.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from video_quierer_tpu_torch.ops.preprocess import resize_shorter_side_and_crop

logger = logging.getLogger(__name__)

SAMPLING_MODES = ("ultra_high", "high", "medium", "low")


def sampling_interval(total_frames: int, max_frames: int,
                      sampling_mode: str) -> int:
    """The reference's mode → frame-interval mapping (module docstring);
    unknown modes behave like ``low``, as in the reference."""
    if sampling_mode == "ultra_high":
        return max(1, total_frames // (max_frames * 2))
    if sampling_mode == "high":
        return max(1, total_frames // max_frames)
    if sampling_mode == "medium":
        return max(1, total_frames // max(1, max_frames // 2))
    return max(1, total_frames // max(1, max_frames // 4))


def video_identity_hash(video_path: Path) -> str:
    """md5 of name+size+mtime — the cache's staleness key."""
    stat = Path(video_path).stat()
    key = f"{Path(video_path).name}_{stat.st_size}_{stat.st_mtime}"
    return hashlib.md5(key.encode()).hexdigest()


@dataclasses.dataclass
class VideoMeta:
    path: Path
    fps: float
    total_frames: int

    @property
    def duration(self) -> float:
        fps = self.fps if self.fps > 0 else 30.0
        return self.total_frames / fps


def probe_video(video_path: Path) -> Optional[VideoMeta]:
    import cv2
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        return None
    meta = VideoMeta(path=Path(video_path), fps=cap.get(cv2.CAP_PROP_FPS),
                     total_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
    cap.release()
    return meta


def iter_sampled_frames(video_path: Path, max_frames: int = 300,
                        sampling_mode: str = "high", target_size: int = 224,
                        ) -> Iterator[Tuple[np.ndarray, float]]:
    """Yield ``(rgb uint8 [target, target, 3], timestamp)`` pairs by the
    reference's sampling rules, streaming (never the whole video)."""
    import cv2
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        logger.error("Cannot open %s", video_path)
        return
    try:
        fps = cap.get(cv2.CAP_PROP_FPS)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        interval = sampling_interval(total, max_frames, sampling_mode)
        kept = 0
        frame_number = 0
        while kept < max_frames:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            if frame_number % interval == 0:
                ts = frame_number / fps if fps > 0 else frame_number / 30
                rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
                yield resize_shorter_side_and_crop(rgb, target_size), ts
                kept += 1
            frame_number += 1
    finally:
        cap.release()


def _native_default() -> bool:
    return os.environ.get("VQT_NATIVE_DECODE") == "1"


def extract_frames(video_path: Path, max_frames: int = 300,
                   sampling_mode: str = "high", target_size: int = 224,
                   use_native: Optional[bool] = None
                   ) -> Tuple[np.ndarray, List[float]]:
    """Materialised variant: ``([N, target, target, 3] uint8 RGB,
    timestamps)``. ``use_native`` (None: ``VQT_NATIVE_DECODE == "1"``)
    tries the native tier first (module docstring)."""
    if use_native is None:
        use_native = _native_default()
    if use_native:
        from video_quierer_tpu_torch.ingest import native
        if native.available():
            probed = native.probe(Path(video_path))
            if probed is not None:
                interval = sampling_interval(probed[1], max_frames,
                                             sampling_mode)
                out = native.decode_sampled(Path(video_path), interval,
                                            max_frames, target_size)
                if out is not None:
                    return out
    frames, stamps = [], []
    for rgb, ts in iter_sampled_frames(video_path, max_frames, sampling_mode,
                                       target_size):
        frames.append(rgb)
        stamps.append(ts)
    if not frames:
        return np.zeros((0, target_size, target_size, 3), np.uint8), []
    return np.stack(frames), stamps


def frame_at_timestamp(video_path: Path, timestamp: float
                       ) -> Optional[np.ndarray]:
    """Seek and read one full-resolution BGR frame (the frame preview
    route): the frame at ``int(timestamp * fps)``, None when the video
    does not open or the read fails."""
    import cv2
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        return None
    try:
        fps = cap.get(cv2.CAP_PROP_FPS)
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(timestamp * fps))
        ok, frame = cap.read()
        return frame if ok else None
    finally:
        cap.release()
