"""Image preprocessing for the vision towers (counterpart of
``video_quierer_tpu/ops/preprocess.py``).

The host decodes and resizes (OpenCV); the uint8 ``[B, 224, 224, 3]`` RGB
batch goes to the device once, where :func:`normalize_images` runs the
cast + scale + CLIP mean/std normalisation as one multiply-add. The
rounding is the JAX package's: the scale and shift are rounded to the
tower dtype, then ``x.to(dtype) * scale - shift`` in that dtype.

Constants are CLIP's published normalisation and SigLIP's ``[-1, 1]``
one (mean = std = 0.5). ``cv2`` is imported inside
:func:`resize_shorter_side_and_crop` only: the port imports no OpenCV
until a frame is decoded.
"""

from __future__ import annotations

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def normalize_images(frames_u8: torch.Tensor, dtype=torch.float32,
                     mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """``[B, H, W, 3] uint8 RGB`` → normalised ``[B, H, W, 3]`` in
    ``dtype``, on the frames' device: ``x * (1/(255*std)) - mean/std``."""
    dev = frames_u8.device
    scale = torch.tensor([1.0 / (255.0 * s) for s in std],
                         dtype=torch.float64).to(dev, dtype)
    shift = torch.tensor([m / s for m, s in zip(mean, std)],
                         dtype=torch.float64).to(dev, dtype)
    return frames_u8.to(dtype) * scale - shift


def resize_shorter_side_and_crop(frame: np.ndarray, size: int = 224
                                 ) -> np.ndarray:
    """Host-side: resize the shortest edge to ``size`` (bicubic) + centre
    crop. Input ``H x W x 3`` uint8 RGB."""
    import cv2
    h, w = frame.shape[:2]
    if h < w:
        nh, nw = size, max(size, round(w * size / h))
    else:
        nh, nw = max(size, round(h * size / w)), size
    resized = cv2.resize(frame, (nw, nh), interpolation=cv2.INTER_CUBIC)
    top = (nh - size) // 2
    left = (nw - size) // 2
    return resized[top: top + size, left: left + size]
