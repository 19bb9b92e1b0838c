"""Held-out retrieval metrics for dual-encoder fine-tuning (counterpart
of ``video_quierer_tpu/train/eval.py``).

Encode aligned (frame, caption) pairs, score all-pairs cosine similarity
and report recall@k and the median rank both ways (image → text and
text → image), the standard CLIP evaluation. The towers run under
``torch.no_grad()`` on the module's device, with the parameters given
(a trainer's ``serving_params``: its EMA when tracked); the pairwise
math runs on the host in numpy.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call


def _encode(model: torch.nn.Module, params: Mapping[str, torch.Tensor],
            images: np.ndarray, ids: np.ndarray, batch_size: int = 64
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Unit-norm image and text features, in chunks of one fixed batch
    shape: a short last chunk is padded by repeating its last row, and
    the pad rows are dropped."""
    device = next(model.parameters()).device
    imgs, txts = [], []
    for lo in range(0, images.shape[0], batch_size):
        im = images[lo: lo + batch_size]
        tk = ids[lo: lo + batch_size]
        pad = batch_size - im.shape[0]
        if pad:
            im = np.concatenate([im, np.repeat(im[-1:], pad, axis=0)])
            tk = np.concatenate([tk, np.repeat(tk[-1:], pad, axis=0)])
        with torch.no_grad():
            fi, ft = functional_call(
                model, dict(params),
                (torch.as_tensor(im, device=device),
                 torch.as_tensor(tk, device=device).long()))[:2]
        m = batch_size - pad
        imgs.append(fi.cpu().numpy()[:m])
        txts.append(ft.cpu().numpy()[:m])
    return np.concatenate(imgs), np.concatenate(txts)


def _ranks(sim: np.ndarray) -> np.ndarray:
    """For each row i, the 0-based rank of column i by descending score,
    ties pessimistic: an equal score ahead of the match counts against
    it, so the metrics never flatter a collapsed model."""
    diag = sim[np.arange(sim.shape[0]), np.arange(sim.shape[0])]
    return (sim >= diag[:, None]).sum(axis=1) - 1


def retrieval_metrics(model: torch.nn.Module,
                      params: Mapping[str, torch.Tensor], images: np.ndarray,
                      ids: np.ndarray, ks: Sequence[int] = (1, 5, 10),
                      batch_size: int = 64) -> Dict[str, float]:
    """Recall@k and median rank on aligned (image, caption) pairs.

    ``images``: float ``[N, S, S, 3]`` already normalised for the family;
    ``ids``: ``[N, ctx]`` tokenized captions; pair i is the positive."""
    if images.shape[0] != ids.shape[0]:
        raise ValueError("images and ids must pair 1:1")
    if images.shape[0] == 0:
        return {}
    img, txt = _encode(model, params, np.asarray(images), np.asarray(ids),
                       batch_size=batch_size)
    sim = img @ txt.T
    out: Dict[str, float] = {}
    for name, ranks in (("i2t", _ranks(sim)), ("t2i", _ranks(sim.T))):
        for k in ks:
            out[f"{name}_recall@{k}"] = float((ranks < k).mean())
        out[f"{name}_median_rank"] = float(np.median(ranks) + 1)
    return out


def evaluate_trainer(trainer, images: np.ndarray, ids: np.ndarray,
                     ks: Sequence[int] = (1, 5, 10),
                     batch_size: int = 64) -> Dict[str, float]:
    """Retrieval metrics with the trainer's serving parameters (the EMA
    when tracked)."""
    return retrieval_metrics(trainer.model, trainer.serving_params,
                             images, ids, ks=ks, batch_size=batch_size)
