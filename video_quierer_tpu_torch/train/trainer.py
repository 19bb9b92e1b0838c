"""Contrastive fine-tuning of the dual towers on one card or on a mesh
(counterpart of ``video_quierer_tpu/train/trainer.py``).

One process: on one device, or, with ``mesh=`` (a ``parallel/mesh.py:
DataMesh``), over a ``(data, model)`` or ``(data, expert)`` grid, as the
JAX trainer is one controller over its mesh. Switch-MoE towers
(``vision.moe_experts > 0``) train on either.

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

On a mesh (the JAX step under GSPMD, which keeps the global batch's
semantics under any sharding):

- the parameters are placed by :func:`param_partition_spec` (Megatron
  column splits of ``q/k/v_proj`` and ``fc1``, row splits of
  ``out_proj`` and ``fc2``, expert stacks on ``expert``, the rest
  replicated; a rule whose axis the mesh lacks replicates) as a
  ``ShardedTree``: a split tensor's part ``c`` lives on ``grid[0][c]``, a
  replicated one on ``grid[0][0]``; the moments and the EMA likewise;
- a step splits the global batch over ``data`` (a batch the axis does
  not divide raises) and runs the rows in order, each on its own
  per-row module whose replicated parameters are differentiable copies
  (``to``) of the masters on its first device, so autograd's backward
  sums each gradient over the rows onto its master. A row's split blocks
  go through a :class:`RowPlan`: each part runs its ``H/tp`` heads (B3)
  and its MLP columns on ``grid[r][c]``, and the partial sums add onto
  the row's first device, where the second bias is added once;
- an MoE layer routes the global batch as one device does (capacity of
  the global N, slots offset by the earlier rows' counts:
  ``parallel/moe.py:SwitchMoEMLP.mesh_forward``); its aux loss is formed
  from the rows' sums after the last row;
- the rows' features are gathered onto ``grid[0][0]``, where the loss is
  taken once over the global batch (CLIP's all-pairs InfoNCE, SigLIP's
  mean over all n² pairs); the clip of the global norm counts each
  master once, then AdamW and the EMA run on each part in place;
- ``state.params`` (and ``serving_params``, the moments, the EMA) give
  whole tensors by the one-device names, gathered from the parts;
  ``model`` is the module's skeleton on the meta device.

Build the trainer outside ``torch.inference_mode()``, and never hand it an
embedder's module: an inference tensor cannot be saved for backward or
updated in place.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

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
from video_quierer_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    DataMesh,
    ShardedTree,
)
from video_quierer_tpu_torch.parallel.moe import (
    EXPERT_AXIS,
    MoEEncoderBlock,
    expert_partition_spec,
    switch_aux,
)
from video_quierer_tpu_torch.utils.env import resolve_device
from video_quierer_tpu_torch.utils.stageprof import span, unit

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
# Partitioning rules (tensor and expert parallelism)
# ---------------------------------------------------------------------------

# the Megatron splits, by the module that owns the weight
COLUMN_SPLIT = ("q_proj", "k_proj", "v_proj", "fc1")
ROW_SPLIT = ("out_proj", "fc2")

Spec = Tuple[Optional[str], ...]


def param_partition_spec(name: str, leaf: torch.Tensor) -> Spec:
    """Megatron-style specs by parameter name (JAX ``:70-96``) in the
    port's layouts: the ``q/k/v_proj`` and ``fc1`` weights ``[out, in]``
    split their output rows ``(model, None)`` and their biases ``(model,)``;
    the ``out_proj`` and ``fc2`` weights split their input columns
    ``(None, model)``, their biases replicated; the expert stacks
    ``w1/b1/w2/b2`` split on ``expert`` (``parallel/moe.py:
    expert_partition_spec``); everything else replicated, ``()``. The
    rules match by name, so they cover SigLIP's MAP head too."""
    names = name.split(".")
    if expert_partition_spec(names, leaf):
        return expert_partition_spec(names, leaf)
    owner = names[-2] if len(names) > 1 else ""
    if names[-1] == "weight":
        if owner in COLUMN_SPLIT:
            return (MODEL_AXIS, None)
        if owner in ROW_SPLIT:
            return (None, MODEL_AXIS)
    if names[-1] == "bias" and owner in COLUMN_SPLIT:
        return (MODEL_AXIS,)
    return ()


def _spec_for_mesh(spec: Spec, mesh: DataMesh) -> Spec:
    """Drop axes the mesh doesn't have (a TP rule on a (data, expert)
    mesh degrades to replicated, and vice versa)."""
    return tuple(ax if ax in mesh.shape else None for ax in spec)


def param_shardings(params: Mapping[str, torch.Tensor], mesh: DataMesh
                    ) -> Dict[str, Spec]:
    """Each parameter's spec on ``mesh`` (JAX's ``NamedSharding`` tree)."""
    return {k: _spec_for_mesh(param_partition_spec(k, v), mesh)
            for k, v in params.items()}


def shard_params(params: Mapping[str, torch.Tensor], mesh: DataMesh
                 ) -> ShardedTree:
    """Place a state dict on the mesh per the partition rules."""
    return ShardedTree.place(params, mesh, param_shardings(params, mesh))


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
    max_norm`` (selected on the device: no host sync). The gradients may
    lie on several devices (a mesh's parts): the norm is summed on the
    first's."""
    dev = grads[0].device
    norm = torch.sqrt(torch.stack([torch.sum(g * g).to(dev)
                                   for g in grads]).sum())
    keep = norm < max_norm
    return [torch.where(keep.to(g.device), g,
                        g / norm.to(g.device) * max_norm) for g in grads]


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
# One data row of a mesh step
# ---------------------------------------------------------------------------

_QKV = ("q_proj.weight", "q_proj.bias", "k_proj.weight", "k_proj.bias",
        "v_proj.weight", "v_proj.bias")
_ATTN = _QKV + ("out_proj.weight",)
_MLP = ("fc1.weight", "fc1.bias", "fc2.weight")


def bind_tensors(module: torch.nn.Module,
                 tensors: Mapping[str, torch.Tensor]) -> None:
    """Make each ``tensors[name]`` the attribute its parameter name points
    at in ``module`` (a plain tensor in the parameter's place), so the
    module's own forward computes with it and gradients flow to it."""
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        sub._parameters.pop(leaf, None)
        setattr(sub, leaf, t)


def _sum_onto(terms: List[torch.Tensor], dev: torch.device) -> torch.Tensor:
    total = terms[0].to(dev)
    for t in terms[1:]:
        total = total + t.to(dev)
    return total


class RowPlan:
    """One data row of a mesh step (the ``plan`` the towers take): its
    devices ``row`` (``grid[r]``), the split parameters' parts copied to
    them (``parts``: name → one tensor per device), and its MoE layers'
    routing state: ``offsets`` (layer → the ``[E]`` counts of the earlier
    rows' tokens) in, ``moe`` (layer → ``(counts, prob_sums, dropped,
    global tokens)``) out. Unsplit modules run as they are, on the row's
    first device."""

    def __init__(self, row, names: Dict[torch.nn.Module, str],
                 parts: Dict[str, List[torch.Tensor]], data_rows: int,
                 offsets: Dict[str, torch.Tensor]):
        self.row = row
        self.names = names
        self.parts = parts
        self.data_rows = data_rows
        self.offsets = offsets
        self.moe: Dict[str, tuple] = {}

    def _split(self, module: torch.nn.Module, leaves: tuple):
        """The parts of ``module``'s split parameters, one dict of
        ``leaves`` per device, or None when ``module`` is not split."""
        pre = self.names[module]
        if f"{pre}.{leaves[0]}" not in self.parts:
            return None
        return [{leaf: self.parts[f"{pre}.{leaf}"][c] for leaf in leaves}
                for c in range(len(self.row))]

    def attention(self, attn, y: torch.Tensor) -> torch.Tensor:
        w = self._split(attn, _ATTN)
        if w is None:
            return attn(y)
        heads = attn.num_heads // len(w)
        out = _sum_onto([attn.part(y.to(dev), wc, heads)
                         for wc, dev in zip(w, self.row)], y.device)
        return out + attn.out_proj.bias.to(out.dtype)

    def mlp(self, mlp, y: torch.Tensor) -> torch.Tensor:
        w = self._split(mlp, _MLP)
        if w is None:
            return mlp(y)
        out = _sum_onto([mlp.part(y.to(dev), wc)
                         for wc, dev in zip(w, self.row)], y.device)
        return out + mlp.fc2.bias.to(out.dtype)

    def moe_layer(self, moe, y: torch.Tensor) -> torch.Tensor:
        name = self.names[moe]
        w = self._split(moe, ("w1", "b1", "w2", "b2"))
        stacks = ([(moe.w1, moe.b1, moe.w2, moe.b2)] if w is None else
                  [(wc["w1"], wc["b1"], wc["w2"], wc["b2"]) for wc in w])
        offset = self.offsets.get(name)
        if offset is None:
            offset = torch.zeros(moe.num_experts, dtype=torch.long,
                                 device=y.device)
        n_global = y.shape[0] * y.shape[1] * self.data_rows
        out, counts, sums, dropped = moe.mesh_forward(y, n_global, offset,
                                                      stacks)
        self.moe[name] = (counts, sums, dropped, n_global)
        return out

    def block(self, block, x: torch.Tensor) -> torch.Tensor:
        """An encoder block (dense or MoE) as its forward computes it,
        its attention and MLP split; an MoE block's aux goes to
        :attr:`moe`, not to the tower's list."""
        x = x + self.attention(block.attn, block.layer_norm1(x))
        y = block.layer_norm2(x)
        if isinstance(block, MoEEncoderBlock):
            return x + self.moe_layer(block.moe, y)
        return x + self.mlp(block.mlp, y)

    def map_head(self, head, tokens: torch.Tensor) -> torch.Tensor:
        """SigLIP's MAP head (``MAPHead.forward``), its attention split by
        heads and its MLP by columns."""
        w = self._split(head, _ATTN)
        if w is None:
            return head(tokens)
        heads = head.num_heads // len(w)
        x = _sum_onto([head.part(tokens.to(dev), wc, heads)
                       for wc, dev in zip(w, self.row)], tokens.device)
        x = x + head.out_proj.bias.to(x.dtype)
        x = x + self.mlp(head.mlp, head.layernorm(x))
        return x[:, 0]


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """``step``; ``params``: the module's parameters by name (the live
    tensors; on a mesh a ``ShardedTree`` over the parts); ``opt_state``:
    ``{"count", "mu", "nu"}``, the moments by name; ``ema_params``: the
    EMA by name, or None when not tracked."""

    step: int
    params: Mapping[str, torch.Tensor]
    opt_state: Dict[str, Any]
    ema_params: Optional[Mapping[str, torch.Tensor]] = None


def _seeded_params(model: torch.nn.Module, seed: int
                  ) -> Dict[str, torch.Tensor]:
    """The port's seeded f32 init for ``model``'s family."""
    gen = torch.Generator().manual_seed(seed)
    if isinstance(model, SigLIP):
        return siglip_bridge.init_params(model.cfg, gen)
    return clip_bridge.init_params(model.cfg, gen)


def _leaves(tree: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
    """The tensors the optimizer updates: a sharded tree's parts, else
    the tree's values, in name order."""
    return tree.flat() if isinstance(tree, ShardedTree) else list(
        tree.values())


def _by_device(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` grouped by device, in order."""
    groups: Dict[torch.device, List[int]] = collections.defaultdict(list)
    for i, t in enumerate(tensors):
        groups[t.device].append(i)
    return list(groups.values())


def _check_mesh(model: torch.nn.Module, mesh: DataMesh) -> None:
    """Refuse a split the mesh cannot make: heads or experts that do not
    divide over its second axis."""
    n = len(mesh.grid[0])
    for name, m in model.named_modules():
        heads = getattr(m, "num_heads", None)
        if mesh.axis == MODEL_AXIS and heads and hasattr(m, "q_proj") \
                and heads % n:
            raise ValueError(f"{name}: {heads} heads do not split over "
                             f"{n} {MODEL_AXIS} parts")
        experts = getattr(m, "num_experts", None)
        if mesh.axis == EXPERT_AXIS and experts and experts % n:
            raise ValueError(f"{name}: {experts} experts do not split over "
                             f"{n} {EXPERT_AXIS} parts")


class CLIPTrainer:
    """Owns the module, its optimizer state and the step, on one device
    or on a mesh.

    Any dual-encoder module whose ``forward(images, ids)`` returns ``(img,
    txt, scale[, bias])`` trains: pass a built ``model`` (a SigLIP, say)
    in place of the default ``CLIP(cfg, dtype, remat)``. ``params`` is a
    state dict of the port's (``bridge.params_from_jax`` of a JAX tree,
    or ``convert.py``'s); without one the family's seeded init is drawn
    from ``seed``. The parameters are f32 on ``device`` whatever the
    compute dtype; with ``mesh`` (a ``DataMesh``, whose second axis is
    ``model`` or ``expert``) they are placed on the mesh instead and the
    towers' forwards take a :class:`RowPlan` (CLIP and SigLIP do).
    """

    def __init__(self, cfg: Optional[CLIPConfig] = None,
                 mesh: Optional[DataMesh] = None,
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
        self.cfg = cfg if model is None else model.cfg
        self.mesh = mesh
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.ema_decay = ema_decay
        if model is None:
            with torch.device("meta"):
                model = CLIP(cfg, dtype=dtype, remat=remat)
        if params is None:
            params = _seeded_params(model, seed)
        self._schedule = build_lr_schedule(learning_rate, schedule,
                                           warmup_steps, total_steps)
        if mesh is None:
            self.device = resolve_device(device)
            model = model.to_empty(device=self.device).float()
            model.load_state_dict(params)
            self.model = model.train()
            live = dict(model.named_parameters())
            zeros = lambda: {k: torch.zeros_like(p)  # noqa: E731
                             for k, p in live.items()}
            ema = ({k: p.detach().clone() for k, p in live.items()}
                   if ema_decay is not None else None)
            mu, nu = zeros(), zeros()
        else:
            self.device = mesh.grid[0][0]
            self.model = model.to_empty(device="meta").train()
            _check_mesh(self.model, mesh)
            names = [k for k, _ in self.model.named_parameters()]
            if sorted(names) != sorted(params):
                raise ValueError("params: the state dict's names differ "
                                 "from the module's "
                                 f"({sorted(set(names) ^ set(params))[:4]})")
            live = shard_params({k: params[k].float() for k in names}, mesh)
            for p in live.flat():
                p.requires_grad_(True)
            self._split = [k for k in live if ShardedTree.split_dim(
                live.specs[k], mesh) is not None]
            self._replicated = [k for k in live if k not in self._split]
            self._rows = [copy.deepcopy(self.model) for _ in mesh.grid]
            self._names = [{m: n for n, m in row.named_modules()}
                           for row in self._rows]
            self.last_dropped: Dict[str, torch.Tensor] = {}
            ema = (live.map(lambda p: p.detach().clone())
                   if ema_decay is not None else None)
            mu, nu = live.map(torch.zeros_like), live.map(torch.zeros_like)
        self.state = TrainState(
            step=0, params=live, opt_state={"count": 0, "mu": mu, "nu": nu},
            ema_params=ema)

    def current_lr(self) -> float:
        """Learning rate the next step will use."""
        return float(self._schedule(self.state.step))

    @property
    def serving_params(self) -> Mapping[str, torch.Tensor]:
        """Params to serve or export: the EMA when tracked, else live."""
        return (self.state.ema_params if self.state.ema_params is not None
                else self.state.params)

    def step(self, images, input_ids) -> float:
        """One optimizer step on a ``[B, H, W, 3]`` float batch (numpy or
        a tensor) and its ``[B, S]`` ids, the global batch on a mesh;
        returns the loss. Its spans (``train.forward``, ``train.backward``,
        ``train.optimizer``, ``train.loss_fetch``) carry the step's number;
        the loss's fetch is the step's one wait on the device and its last
        work: the graph and the gradients are freed in ``train.optimizer``,
        while the device still runs the step."""
        with unit(self.state.step):
            loss, grads = self._loss_and_grads(images, input_ids)
            with span("train.optimizer"):
                self._apply(grads)
                loss, grads = loss.detach(), None
            with span("train.loss_fetch"):
                return float(loss)

    def value_and_grad(self, images, input_ids
                       ) -> Tuple[float, Dict[str, torch.Tensor]]:
        """The loss and the gradient of every parameter (whole tensors by
        name, on the mesh's first device) on a batch, without a step."""
        loss, grads = self._loss_and_grads(images, input_ids)
        names = list(self.state.params)
        if self.mesh is None:
            return float(loss.detach()), dict(zip(names, grads))
        it = iter(grads)
        tree = ShardedTree(self.mesh, self.state.params.specs, {
            k: [next(it) for _ in self.state.params.parts(k)]
            for k in names})
        return float(loss.detach()), dict(tree.items())

    def _loss_and_grads(self, images, input_ids):
        with span("train.forward"):
            if self.mesh is not None:
                loss, leaves = self._mesh_loss(images, input_ids)
            else:
                images = torch.as_tensor(images, device=self.device)
                input_ids = torch.as_tensor(input_ids,
                                            device=self.device).long()
                leaves = list(self.state.params.values())
                loss = loss_fn(self.model, images, input_ids)
        with span("train.backward"):
            return loss, list(torch.autograd.grad(loss, leaves))

    def _mesh_loss(self, images, input_ids):
        """The global batch's loss over the mesh's rows, and every part it
        is differentiated for (``ShardedTree.flat`` order)."""
        grid, st = self.mesh.grid, self.state.params
        images, input_ids = torch.as_tensor(images), torch.as_tensor(
            input_ids)
        b, dp = images.shape[0], len(grid)
        if b % dp or input_ids.shape[0] != b:
            raise ValueError(f"a batch of {b} images and "
                             f"{input_ids.shape[0]} texts does not split "
                             f"over {dp} data rows")
        rows, outs, offsets = b // dp, [], {}
        moe: Dict[str, List[tuple]] = {}
        for r, row in enumerate(grid):
            dev = row[0]
            module = self._rows[r]
            bind_tensors(module, {k: st.parts(k)[0].to(dev)
                                  for k in self._replicated})
            plan = RowPlan(row, self._names[r], {
                k: [p.to(d) for p, d in zip(st.parts(k), row)]
                for k in self._split}, dp, offsets)
            sl = slice(r * rows, (r + 1) * rows)
            outs.append(module(images[sl].to(dev),
                               input_ids[sl].to(dev).long(), plan=plan))
            nxt = grid[r + 1][0] if r + 1 < dp else dev
            offsets = {}
            for name, layer in plan.moe.items():
                moe.setdefault(name, []).append(layer)
                counts = layer[0]
                if name in plan.offsets:
                    counts = plan.offsets[name] + counts
                offsets[name] = counts.to(nxt)
        dev = self.device
        img = torch.cat([o[0].to(dev) for o in outs])
        txt = torch.cat([o[1].to(dev) for o in outs])
        loss = (siglip_sigmoid_loss(img, txt, *outs[0][2:])
                if len(outs[0]) == 4 else
                clip_contrastive_loss(img, txt, *outs[0][2:]))
        if moe:
            # each layer's aux from the rows' sums, in layer order
            aux = [switch_aux(layers[0][0].shape[0], layers[0][3],
                              _sum_onto([x[0] for x in layers], dev),
                              _sum_onto([x[1] for x in layers], dev))
                   for layers in moe.values()]
            loss = loss + MOE_AUX_WEIGHT * torch.stack(aux).sum()
            self.last_dropped = {name: _sum_onto([x[2] for x in layers], dev)
                                 for name, layers in moe.items()}
        return loss, st.flat()

    @torch.no_grad()
    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> None:
        """The optimizer step for ``grads`` (by parameter name, whole
        tensors), then the EMA; advances ``step`` and the optimizer's
        count."""
        st = self.state
        if isinstance(st.params, ShardedTree):
            self._apply([c for k in st.params
                         for c in st.params.split(k, grads[k])])
        else:
            self._apply([grads[k] for k in st.params])

    @torch.no_grad()
    def _apply(self, g: List[torch.Tensor]) -> None:
        """The optimizer step on the gradients of :func:`_leaves` of the
        parameters: the clip, AdamW on each device's tensors, the EMA."""
        st, opt = self.state, self.state.opt_state
        params, mu, nu = (_leaves(t) for t in (st.params, opt["mu"],
                                               opt["nu"]))
        if self.max_grad_norm is not None:
            g = clip_by_global_norm(g, self.max_grad_norm)
        count = opt["count"]
        lr = self._schedule(count)
        groups = _by_device(params)
        for idx in groups:
            adamw_update([params[i] for i in idx], [g[i] for i in idx],
                         [mu[i] for i in idx], [nu[i] for i in idx], count,
                         lr, self.weight_decay)
        opt["count"] = count + 1
        st.step += 1
        if st.ema_params is not None:
            ema = _leaves(st.ema_params)
            for idx in groups:
                ema_update([ema[i] for i in idx], [params[i] for i in idx],
                           self.ema_decay)
