"""The encoders of ``api.use_clip = false`` (a copy of
``video_quierer_tpu/engine/fallback.py``; numpy and OpenCV, no device):

- :class:`VisualStatsEmbedder`: 36 handcrafted statistics per frame —
  grayscale mean/std/median, Canny edge density, a 32-bin histogram —
  zero-padded to ``dim`` and L2-normalized.
- :class:`KeywordQueryEncoder`: keyword → feature-position mapping,
  unit-normalized, a random unit vector for a query with no keyword (drawn
  from one seeded generator, so a vector depends on the call order).

They serve ``use_clip = false`` only: a failed CLIP encode raises
(``engine/system.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

EMBED_DIM = 512


class VisualStatsEmbedder:
    """Handcrafted per-frame statistics as a ``dim``-d embedding
    (zero-padded; 512, or 768 for the SigLIP family's index width)."""

    def __init__(self, dim: int = EMBED_DIM):
        self.dim = dim

    def embed_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        import cv2
        n = frames_u8.shape[0]
        out = np.zeros((n, self.dim), np.float32)
        for i in range(n):
            gray = cv2.cvtColor(frames_u8[i], cv2.COLOR_RGB2GRAY)
            feats: List[float] = [
                float(gray.mean()),
                float(gray.std()),
                float(np.median(gray)),
            ]
            edges = cv2.Canny(gray, 50, 150)
            feats.append(float((edges > 0).sum()) / edges.size)
            hist = cv2.calcHist([gray], [0], None, [32], [0, 256]).ravel()
            feats.extend(hist.tolist())
            v = np.asarray(feats, np.float32)
            out[i, : v.size] = v[: self.dim]
            norm = np.linalg.norm(out[i])
            if norm > 0:
                out[i] /= norm
        return out


# keyword → (position, weight)
_KEYWORD_POSITIONS = (
    (("bright",), 0, 0.8),
    (("dark",), 0, 0.2),
    (("phone", "app"), 10, 0.9),
    (("car", "vehicle"), 20, 0.9),
    (("goal", "football"), 30, 0.9),
)


class KeywordQueryEncoder:
    """Keyword-bucket text encoder."""

    def __init__(self, seed: int = 0, dim: int = EMBED_DIM):
        self._rng = np.random.default_rng(seed)
        self.dim = dim

    def embed_text(self, query: str) -> np.ndarray:
        feats = np.zeros(self.dim, np.float32)
        q = query.lower()
        for words, pos, weight in _KEYWORD_POSITIONS:
            if any(w in q for w in words):
                feats[pos] = weight
        norm = np.linalg.norm(feats)
        if norm > 0:
            return feats / norm
        rand = self._rng.normal(0, 0.1, self.dim).astype(np.float32)
        return rand / np.linalg.norm(rand)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.embed_text(t) for t in texts])
