"""Per-row symmetric quantization of the embedding matrix (counterpart of
``video_quierer_tpu/ops/quantize.py``, plus the int8 host quantizer that
the reference keeps in ``index/device_index.py``).

``device_dtype='int8'`` stores the corpus as int8 codes + per-row f32
scales (1 byte/element for the scan instead of 4); ``'int4'`` packs two
4-bit codes per byte in the SPLIT-HALVES layout (byte j carries feature j
in its low nibble and feature ``j + D/2`` in its high nibble), so the scan
unpacks two contiguous half-depth code blocks. Every returned row is
re-ranked exactly in f32, so the codes only feed the candidate stage.

Codes and scales are bit-identical to the reference's: the scale is the
f32 reciprocal multiply ``absmax * float32(1/127)`` (``1/7`` for int4),
the codes round half to even, and the nibble pack is the same. The tensor
functions run on any device; the ``*_np`` twins are the host copies the
index quantizes with.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_INV127 = np.float32(1.0 / 127.0)
_INV7 = np.float32(1.0 / 7.0)


def _quantize(emb: torch.Tensor, inv: np.float32, qmax: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    emb = emb.float()
    absmax = emb.abs().amax(dim=-1, keepdim=True)
    scale = absmax * torch.tensor(inv, device=emb.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(emb / safe), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_rows(emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[N, D] f32`` → ``([N, D] int8, [N, 1] f32 scales)``; zero rows get
    scale 0 and all-zero codes."""
    return _quantize(emb, _INV127, 127)


def _pack_halves(q, half: int):
    lo, hi = q[..., :half], q[..., half:]
    return (hi << 4) | (lo & 0xF)


def quantize_rows_int4(emb: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[N, D] f32`` → ``([N, D/2] int8 packed, [N, 1] f32 scales)``:
    codes in [-7, 7], split-halves pack. D must be even."""
    q, scale = _quantize(emb, _INV7, 7)
    return _pack_halves(q, emb.shape[-1] // 2), scale


def _quantize_np(emb, inv: np.float32, qmax: int):
    emb = np.asarray(emb, np.float32)
    absmax = np.abs(emb).max(axis=-1, keepdims=True)
    scale = absmax * inv
    safe = np.where(scale > 0, scale, np.float32(1.0))
    q = np.clip(np.round(emb / safe), -qmax, qmax).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_rows_np(emb) -> Tuple[np.ndarray, np.ndarray]:
    """Host twin of :func:`quantize_rows` (the reference's
    ``DeviceVideoIndex._quantize_host`` for int8)."""
    return _quantize_np(emb, _INV127, 127)


def quantize_rows_int4_np(emb) -> Tuple[np.ndarray, np.ndarray]:
    """Host twin of :func:`quantize_rows_int4`."""
    q, scale = _quantize_np(emb, _INV7, 7)
    return _pack_halves(q, q.shape[-1] // 2), scale


def unpack_int4_np(packed) -> np.ndarray:
    """``[..., D/2] int8`` packed → ``[..., D] int8`` codes (host)."""
    packed = np.asarray(packed, np.int8)
    lo = (packed << np.int8(4)) >> np.int8(4)
    hi = packed >> np.int8(4)
    return np.concatenate([lo, hi], axis=-1)
