"""Retrieval quality evaluation: recall@k across index modes (counterpart
of ``video_quierer_tpu/evaluation.py``).

``recall_at_k`` compares any search callable against the exact f32 scan
(:func:`~video_quierer_tpu_torch.ops.topk.cosine_topk`, kernel B8 on the
card) as ground truth.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from video_quierer_tpu_torch.ops.topk import cosine_topk
from video_quierer_tpu_torch.utils.env import resolve_device


def exact_topk_ids(emb: np.ndarray, queries: np.ndarray, k: int,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Ground-truth neighbor ids via the exact f32 scan on ``device``."""
    dev = resolve_device(device)
    _, idxs = cosine_topk(
        torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev),
        emb.shape[0], k=k)
    return idxs.cpu().numpy()


def recall_at_k(truth_ids: np.ndarray, got_ids: np.ndarray) -> float:
    """Mean |truth ∩ got| / |truth| over queries.

    Pads are ignored on both sides: ``got`` may contain -1, ``truth`` may
    contain the scan's 2**31-1 sentinel when k exceeds the corpus.
    """
    b, _ = truth_ids.shape
    hits = 0
    denom = 0
    for i in range(b):
        truth = {int(x) for x in truth_ids[i] if 0 <= x < 2**31 - 1}
        got = {int(x) for x in got_ids[i] if x >= 0}
        hits += len(truth & got)
        denom += len(truth)
    return hits / denom if denom else 1.0


def evaluate_modes(emb: np.ndarray, queries: np.ndarray, k: int,
                   searchers: Dict[str, Callable[[np.ndarray, int],
                                                 np.ndarray]],
                   device: str | torch.device = "cuda"
                   ) -> Dict[str, float]:
    """Run each named searcher (``fn(queries, k) -> ids [B, k]``) and
    report recall@k against the exact scan."""
    truth = exact_topk_ids(emb, queries, k, device)
    return {name: recall_at_k(truth, fn(queries, k))
            for name, fn in searchers.items()}
