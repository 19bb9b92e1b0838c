"""Contrastive fine-tuning of the dual towers on one card (counterpart of
``video_quierer_tpu/train/trainer.py``).

One process, one device: the JAX trainer's single-device path. Meshes
(data, tensor and expert parallelism, ``param_partition_spec``/
``shard_params``) are the port's ROADMAP A11b and raise here. Switch-MoE
towers (``vision.moe_experts > 0``) train on the one device.

- :func:`build_lr_schedule` gives optax's values at every count, in f32:
  ``constant``, ``constant`` after a linear warmup from 0, and ``cosine``
  (``optax.warmup_cosine_decay_schedule`` from 0 to the peak over
  ``warmup_steps``, then down to 0 at ``total_steps``, the total).
- :func:`loss_fn` runs the module's training forward: CLIP's ``(img,
  txt, scale)`` into :func:`clip_contrastive_loss` (symmetric InfoNCE
  over the batch's all-pairs logits, the scale unclamped), SigLIP's
  ``(img, txt, scale, bias)`` into ``siglip_sigmoid_loss``; an MoE
  tower's load-balance losses are added with the Switch weight
  :data:`MOE_AUX_WEIGHT` (JAX ``:136-170``). The module carries its
  parameters (JAX's ``loss_fn`` takes them as a tree).
- :class:`CLIPTrainer` owns the module (f32 parameters; its compute
  dtype and remat are the module's, ``models/clip/model.py``) and a state
  of ``step``, ``params``, ``opt_state`` and ``ema_params``. A step is
  ``torch.autograd.grad`` of the loss, then optax's update in optax's
  order (written out here, without ``torch.optim``): the clip of the
  global norm (unchanged below ``max_grad_norm``, else ``g / norm *
  max_norm``: not ``clip_grad_norm_``, whose 1e-6 is another function);
  AdamW (b1 0.9, b2 0.999, eps 1e-8, bias correction by the incremented
  count, decay decoupled and applied to every parameter, the LayerNorms,
  biases and logit scale included, since optax's ``adamw`` has no mask);
  the learning rate at the count before the step; then the EMA ``e *
  decay + p * (1 - decay)`` of the updated parameters, started from a
  copy of the initial ones.

Build the trainer outside ``torch.inference_mode()``, and never hand it an
embedder's module: an inference tensor cannot be saved for backward or
updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from video_quierer_tpu_torch.models.clip import bridge as clip_bridge
from video_quierer_tpu_torch.models.clip.config import CLIPConfig
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.models.siglip import bridge as siglip_bridge
from video_quierer_tpu_torch.models.siglip.model import (
    SigLIP,
    siglip_sigmoid_loss,
)
from video_quierer_tpu_torch.utils.env import resolve_device

# optax.adamw's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

_f32 = np.float32
Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# Learning-rate schedules (optax's, in f32)
# ---------------------------------------------------------------------------

def _linear_schedule(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``: ``(init - end) * (1 - c / steps) + end``
    with ``c`` the count clipped to ``[0, steps]``."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = _f32(1) - _f32(min(max(count, 0), steps)) / _f32(steps)
        return _f32(init - end) * frac + _f32(end)
    return schedule


def _cosine_schedule(init: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` with ``alpha`` 0 and exponent 1:
    ``init * 0.5 * (1 + cos(pi * min(c, T) / T))``."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        c = _f32(min(count, decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c
                                               / _f32(decay_steps)))
        return _f32(init) * cosine
    return schedule


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    """``optax.join_schedules([first, then], [boundary])``: ``then``
    counts from the boundary."""
    def schedule(count: int) -> float:
        return _f32(first(count) if count < boundary
                    else then(count - boundary))
    return schedule


def build_lr_schedule(learning_rate: float, schedule: str = "constant",
                      warmup_steps: int = 0,
                      total_steps: Optional[int] = None) -> Schedule:
    """``constant`` (optionally after a linear warmup from 0) or
    ``cosine`` (a linear warmup from 0, then a cosine decay to 0 at
    ``total_steps``, which counts the warmup): count → learning rate."""
    if schedule == "cosine":
        if not total_steps:
            raise ValueError("cosine schedule requires total_steps")
        return _join(_linear_schedule(0.0, learning_rate, warmup_steps),
                     _cosine_schedule(learning_rate,
                                      total_steps - warmup_steps),
                     warmup_steps)
    if schedule != "constant":
        raise ValueError(f"unknown schedule {schedule!r}")
    if warmup_steps:
        return _join(_linear_schedule(0.0, learning_rate, warmup_steps),
                     lambda count: learning_rate, warmup_steps)
    return lambda count: learning_rate


# ---------------------------------------------------------------------------
# Objective
# ---------------------------------------------------------------------------

def clip_contrastive_loss(image_feats: torch.Tensor, text_feats: torch.Tensor,
                          logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch: f32 all-pairs logits times the
    scale, cross entropy against the diagonal both ways."""
    logits = logit_scale * (image_feats.float() @ text_feats.float().t())
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.t(), labels)) / 2.0


MOE_AUX_WEIGHT = 0.01  # the standard Switch load-balance coefficient


def is_moe(model: torch.nn.Module) -> bool:
    """Whether ``model``'s vision tower has Switch-MoE blocks."""
    vision = getattr(getattr(model, "cfg", None), "vision", None)
    return bool(getattr(vision, "moe_experts", 0))


def loss_fn(model: torch.nn.Module, images: torch.Tensor,
            input_ids: torch.Tensor) -> torch.Tensor:
    """The family's objective on the module's training forward: three
    outputs (CLIP) → :func:`clip_contrastive_loss`, four (SigLIP) →
    ``siglip_sigmoid_loss``; plus ``MOE_AUX_WEIGHT`` times the sum of an
    MoE tower's ``aux`` losses."""
    if is_moe(model):
        aux: List[torch.Tensor] = []
        out = model(images, input_ids, aux=aux)
    else:
        aux, out = [], model(images, input_ids)
    loss = (siglip_sigmoid_loss(*out) if len(out) == 4
            else clip_contrastive_loss(*out))
    if aux:
        loss = loss + MOE_AUX_WEIGHT * torch.stack(aux).sum()
    return loss


# ---------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, adamw), written out
# ---------------------------------------------------------------------------

def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: the gradients as they are when
    their global L2 norm is below ``max_norm``, else ``g / norm *
    max_norm`` (selected on the device: no host sync)."""
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 mu: List[torch.Tensor], nu: List[torch.Tensor], count: int,
                 lr: float, weight_decay: float) -> None:
    """One ``optax.adamw`` step in place (``params``, ``mu``, ``nu``):
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, ``u = (mu /
    (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) + wd * p`` with ``n =
    count + 1``, then ``p + (-lr) * u``."""
    n = count + 1
    bc1 = float(_f32(1) - np.power(_f32(ADAM_B1), _f32(n)))
    bc2 = float(_f32(1) - np.power(_f32(ADAM_B2), _f32(n)))
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - ADAM_B1))
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - ADAM_B2))
    update = torch._foreach_div(mu, bc1)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    torch._foreach_div_(update, den)
    del den
    torch._foreach_add_(update, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(update, -float(lr))
    torch._foreach_add_(params, update)


def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor],
               decay: float) -> None:
    """``e * decay + p * (1 - decay)``, in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """``step``; ``params``: the module's parameters by name (the live
    tensors); ``opt_state``: ``{"count", "mu", "nu"}``, the moments by
    name; ``ema_params``: the EMA by name, or None when not tracked."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def _seeded_params(model: torch.nn.Module, seed: int
                  ) -> Dict[str, torch.Tensor]:
    """The port's seeded f32 init for ``model``'s family."""
    gen = torch.Generator().manual_seed(seed)
    if isinstance(model, SigLIP):
        return siglip_bridge.init_params(model.cfg, gen)
    return clip_bridge.init_params(model.cfg, gen)


class CLIPTrainer:
    """Owns the module, its optimizer state and the step, on one device.

    Any dual-encoder module whose ``forward(images, ids)`` returns ``(img,
    txt, scale[, bias])`` trains: pass a built ``model`` (a SigLIP, say)
    in place of the default ``CLIP(cfg, dtype, remat)``. ``params`` is a
    state dict of the port's (``bridge.params_from_jax`` of a JAX tree,
    or ``convert.py``'s); without one the family's seeded init is drawn
    from ``seed``. The parameters are f32 on ``device`` whatever the
    compute dtype.
    """

    def __init__(self, cfg: Optional[CLIPConfig] = None, mesh=None,
                 learning_rate: float = 1e-5, weight_decay: float = 0.01,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 model: Optional[torch.nn.Module] = None,
                 schedule: str = "constant", warmup_steps: int = 0,
                 total_steps: Optional[int] = None,
                 max_grad_norm: Optional[float] = None,
                 ema_decay: Optional[float] = None,
                 device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh training (data, tensor and expert parallelism) is "
                "not ported: ROADMAP A11b")
        self.cfg = cfg if model is None else model.cfg
        self.device = resolve_device(device)
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.ema_decay = ema_decay
        if model is None:
            with torch.device("meta"):
                model = CLIP(cfg, dtype=dtype, remat=remat)
        if params is None:
            params = _seeded_params(model, seed)
        model = model.to_empty(device=self.device).float()
        model.load_state_dict(params)
        self.model = model.train()
        self._schedule = build_lr_schedule(learning_rate, schedule,
                                           warmup_steps, total_steps)
        live = dict(model.named_parameters())
        zeros = lambda: {k: torch.zeros_like(p) for k, p in live.items()}
        ema = ({k: p.detach().clone() for k, p in live.items()}
               if ema_decay is not None else None)
        self.state = TrainState(
            step=0, params=live,
            opt_state={"count": 0, "mu": zeros(), "nu": zeros()},
            ema_params=ema)

    def current_lr(self) -> float:
        """Learning rate the next step will use."""
        return float(self._schedule(self.state.step))

    @property
    def serving_params(self) -> Dict[str, torch.Tensor]:
        """Params to serve or export: the EMA when tracked, else live."""
        return (self.state.ema_params if self.state.ema_params is not None
                else self.state.params)

    def step(self, images, input_ids) -> float:
        """One optimizer step on a ``[B, H, W, 3]`` float batch (numpy or
        a tensor) and its ``[B, S]`` ids; returns the loss."""
        images = torch.as_tensor(images, device=self.device)
        input_ids = torch.as_tensor(input_ids, device=self.device).long()
        names = list(self.state.params)
        params = [self.state.params[k] for k in names]
        loss = loss_fn(self.model, images, input_ids)
        grads = torch.autograd.grad(loss, params)
        self.apply_gradients(dict(zip(names, grads)))
        return float(loss.detach())

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        """The optimizer step for ``grads`` (by parameter name), then the
        EMA; advances ``step`` and the optimizer's count."""
        st, opt = self.state, self.state.opt_state
        names = list(st.params)
        g = [grads[k] for k in names]
        if self.max_grad_norm is not None:
            g = clip_by_global_norm(g, self.max_grad_norm)
        count = opt["count"]
        adamw_update([st.params[k] for k in names], g,
                     [opt["mu"][k] for k in names],
                     [opt["nu"][k] for k in names], count,
                     self._schedule(count), self.weight_decay)
        opt["count"] = count + 1
        st.step += 1
        if st.ema_params is not None:
            ema_update([st.ema_params[k] for k in names],
                       [st.params[k] for k in names], self.ema_decay)
