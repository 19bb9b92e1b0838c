"""The contrastive fine-tuning step, in plain PyTorch: CLIP's symmetric
InfoNCE over the batch's all-pairs logits (times ``exp(logit_scale)``,
unclamped), gradients by autograd, then AdamW as optax writes it (b1 0.9,
b2 0.999, eps 1e-8, bias correction by the step count, weight decay
decoupled and applied to every parameter, a constant learning rate).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference import clip

B1, B2, EPS = 0.9, 0.999, 1e-8


def loss(sd: Dict[str, torch.Tensor], cfg: dict, pixels: torch.Tensor,
         ids: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    img = clip.encode_image(sd, cfg, pixels, prec)
    txt = clip.encode_text(sd, cfg, ids, prec)
    logits = sd["logit_scale"].exp() * clip.matmul(img, txt.t(), prec)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.t(), labels)) / 2


class AdamW:
    """From a fresh state, or from moments ``mu``, ``nu`` after ``count``
    steps."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, mu=None, nu=None, count: int = 0):
        self.params = params
        self.lr, self.wd = lr, weight_decay
        self.mu = mu if mu is not None else {
            k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = nu if nu is not None else {
            k: torch.zeros_like(p) for k, p in params.items()}
        self.count = count

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        bc1, bc2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[k].mul_(B2).add_(g * g, alpha=1 - B2)
            u = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + EPS)
            p.add_(u + self.wd * p, alpha=-self.lr)


def run_steps(params: Dict[str, torch.Tensor], cfg: dict,
              batches: List[tuple], lr: float, weight_decay: float,
              prec: str = "f32", opt: AdamW = None) -> dict:
    """Train ``params`` (f32 leaves, updated in place) on ``batches`` of
    ``(pixels, ids)``, with ``opt`` (default: a fresh AdamW over
    ``params``): each step's loss, the first step's gradient norm of each
    leaf, and the optimizer (``"opt"``) as the steps leave it."""
    for p in params.values():
        p.requires_grad_(True)
    opt = opt or AdamW(params, lr, weight_decay)
    names = list(params)
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for pixels, ids in batches:
        value = loss(params, cfg, pixels, ids, prec)
        grads = torch.autograd.grad(value, [params[k] for k in names])
        losses.append(float(value.detach()))
        if not grad_norms:
            grad_norms = {k: float(torch.linalg.vector_norm(g))
                          for k, g in zip(names, grads)}
        opt.step(dict(zip(names, grads)))
        del value, grads
    for p in params.values():
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": grad_norms, "opt": opt}
