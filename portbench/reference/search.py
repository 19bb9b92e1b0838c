"""Exact cosine top-k in f32 over the library, chunk by chunk, and the
reference's scores of given rows.

The library arrives as ``(first row, rows)`` chunks (``portbench/gen.py:
corpus_chunks``), so the whole of it is never held at once. Order is
(score descending, row ascending).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


def topk_and_scores(chunks: Iterable[Tuple[int, torch.Tensor]],
                    q: torch.Tensor, k: int, rows: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``q [B, D]`` f32 unit queries. Returns the exact top-``k`` scores
    and rows ``[B, k]`` of each query, and ``q_b . x_r`` for every row
    ``r`` of ``rows [B, m]`` (``nan`` for a row past the library)."""
    b = q.shape[0]
    best_v = torch.full((b, 0), float("-inf"), device=q.device)
    best_i = torch.zeros((b, 0), dtype=torch.int64, device=q.device)
    picked = torch.full(rows.shape, float("nan"), device=q.device)
    for lo, chunk in chunks:
        scores = q @ chunk.t()
        hi = lo + chunk.shape[0]
        inside = (rows >= lo) & (rows < hi)
        if inside.any():
            local = torch.clamp(rows - lo, 0, chunk.shape[0] - 1)
            got = torch.gather(scores, 1, local)
            picked = torch.where(inside, got, picked)
        v, i = torch.topk(scores, min(k, scores.shape[1]), dim=1)
        cand_v = torch.cat([best_v, v], dim=1)
        cand_i = torch.cat([best_i, i + lo], dim=1)
        # rows ascending, then a stable sort by score descending
        order = torch.argsort(cand_i, dim=1, stable=True)
        cand_v, cand_i = (torch.gather(cand_v, 1, order),
                          torch.gather(cand_i, 1, order))
        order = torch.argsort(-cand_v, dim=1, stable=True)[:, :k]
        best_v = torch.gather(cand_v, 1, order)
        best_i = torch.gather(cand_i, 1, order)
    return best_v, best_i, picked
