"""Switch-style mixture-of-experts MLP (counterpart of
``video_quierer_tpu/parallel/moe.py``).

The canonical Switch-Transformer top-1 router with a capacity per expert:

- the router runs in f32 on the tokens cast to f32: softmax over the
  experts, ``gate`` the largest probability, ``expert`` its index (the
  first maximum);
- each token's slot in its expert's buffer is the count of earlier tokens
  (row-major ``b·s`` order) routed to the same expert; an expert takes at
  most ``C = max(1, ceil(capacity_factor · N / E))`` tokens, and the rest
  are dropped (their output is 0: the block's residual carries them);
- each expert is a ``d → ratio·d → d`` feed-forward with tanh-GELU
  (``jax.nn.gelu(approximate=True)``'s chain);
- the output is the expert's row times ``gate`` in f32, cast back to the
  input's dtype; ``aux = E · Σ_e frac_e · mean_p_e`` is the Switch
  load-balance loss (the trainer adds ``0.01 · aux``).

The JAX package dispatches with a dense ``[N, E, C]`` mask and two
einsums. Here each kept token is gathered into an ``[E, C, d]`` buffer at
``(expert, slot)`` (dropped tokens point at a spare slot that is never
read, so no shape depends on the data and nothing syncs with the host),
the two expert products are ``torch.bmm`` over ``[E, C, ·]`` (the JAX
package computes them as XLA einsums outside any Pallas kernel), and the
combine gathers ``y[expert, slot] · gate``. The mask has one non-zero a
token, so dispatch and combine give the einsums' values bit for bit in
f32; only the expert products' summation order differs. The mask would
take 819 MB a layer at a 256-frame ViT-B/32 batch (12,800 tokens, 8
experts, 2,000 slots).

Parameter layout follows the flax tree: ``router`` a ``[E, d]``
:class:`~video_quierer_tpu_torch.models.clip.model.Linear`, the stacks
``w1 [E, d, h]``, ``b1 [E, h]``, ``w2 [E, h, d]``, ``b2 [E, d]``.
:func:`expert_partition_spec` names the expert split of those stacks,
:func:`shard_moe_params` places a state dict by it on an
:func:`expert_mesh` (JAX ``:154-168``).

On the trainer's mesh (``train/trainer.py``) a layer keeps the JAX
step's global routing: under GSPMD the layer sees the global batch's N
tokens. :meth:`SwitchMoEMLP.mesh_forward` runs one data row's tokens
with the capacity of the global N and each token's slot offset by the
tokens of the rows before it routed to its expert (``offset``, an
``[E]`` device tensor: the rows run in order), so the same tokens are
dropped as on one device; it returns the row's per-expert counts and
probability sums, from which the trainer forms the aux loss after the
last row (:func:`switch_aux`). Under expert parallelism each part holds
``E / ep`` experts: it computes only its experts' ``[E/ep, C, d]``
products on its device, and the parts' combines sum onto the row's
device (the tokens are replicated over the expert axis, as the JAX
step splits the batch over ``data`` only): no all-to-all.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

EXPERT_AXIS = "expert"
EXPERT_STACKS = ("w1", "b1", "w2", "b2")


def capacity(n_tokens: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert takes: ``max(1, ceil(capacity_factor · N / E))``."""
    return max(1, math.ceil(capacity_factor * n_tokens / num_experts))


def route(probs: torch.Tensor, cap: int):
    """Top-1 routing of ``[N, E]`` f32 probabilities: ``(gate [N],
    expert [N], slot [N], keep [N])``; ``slot`` is the token's place in
    its expert's buffer, ``keep`` whether it is below ``cap``."""
    e = probs.shape[-1]
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    # [E, N]: the running count scans the inner axis (a scan over the
    # outer axis of [N, E] runs E lanes wide: 2.2 ms a layer at N =
    # 12,800 on the H100)
    assign = nn.functional.one_hot(expert, e).t().contiguous()
    slot = (torch.cumsum(assign, dim=1) - assign).gather(
        0, expert[None])[0]
    return gate, expert, slot, slot < cap


class SwitchMoEMLP(nn.Module):
    """Top-1-routed MoE feed-forward: ``[B, S, d] -> ([B, S, d], aux)``."""

    def __init__(self, d: int, num_experts: int, ratio: int = 4,
                 capacity_factor: float = 1.25):
        super().__init__()
        from video_quierer_tpu_torch.models.clip.model import Linear
        e, h = num_experts, d * ratio
        self.num_experts = e
        self.capacity_factor = capacity_factor
        self.router = Linear(d, e)
        self.w1 = nn.Parameter(torch.zeros(e, d, h))
        self.b1 = nn.Parameter(torch.zeros(e, h))
        self.w2 = nn.Parameter(torch.zeros(e, h, d))
        self.b2 = nn.Parameter(torch.zeros(e, d))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, d = x.shape
        n, e = b * s, self.num_experts
        cap = capacity(n, e, self.capacity_factor)
        xt = x.reshape(n, d)
        probs = torch.softmax(self.router(xt.float()), dim=-1)
        gate, expert, slot, keep = route(probs, cap)
        out = combine(xt, gate, expert, slot, keep, cap, 0,
                      (self.w1, self.b1, self.w2, self.b2))
        frac = nn.functional.one_hot(expert, e).float().mean(dim=0)
        aux = e * torch.sum(frac * probs.mean(dim=0))
        return out.reshape(b, s, d).to(x.dtype), aux

    def mesh_forward(self, x: torch.Tensor, n_global: int,
                     offset: torch.Tensor,
                     parts: Sequence[Sequence[torch.Tensor]]):
        """One data row's ``[b, s, d]`` tokens under the global routing of
        ``n_global`` tokens: capacity ``capacity(n_global, E, cf)``, each
        token's slot offset by ``offset[expert]`` (the tokens of earlier
        rows routed to that expert). ``parts`` are the expert parts'
        ``(w1, b1, w2, b2)``, each on its device, part ``c`` holding
        experts ``[c·E/ep, (c+1)·E/ep)``. Returns ``(out [b, s, d],
        counts [E] int64, prob_sums [E] f32, dropped)``: the row's tokens
        routed to each expert, the sums of their router probabilities
        (differentiable) and the count of its tokens past capacity."""
        b, s, d = x.shape
        n, e = b * s, self.num_experts
        cap = capacity(n_global, e, self.capacity_factor)
        xt = x.reshape(n, d)
        probs = torch.softmax(self.router(xt.float()), dim=-1)
        gate, expert, slot, _ = route(probs, cap)
        slot = slot + offset[expert]
        keep = slot < cap
        out, first = None, 0
        for stacks in parts:
            dev = stacks[0].device
            y = combine(xt.to(dev), gate.to(dev), expert.to(dev),
                        slot.to(dev), keep.to(dev), cap, first,
                        stacks).to(x.device)
            out = y if out is None else out + y
            first += stacks[0].shape[0]
        # no host sync: bincount on a CUDA tensor reads its max back
        counts = nn.functional.one_hot(expert, e).sum(dim=0)
        return (out.reshape(b, s, d).to(x.dtype), counts,
                probs.sum(dim=0), (~keep).sum())


def combine(xt: torch.Tensor, gate: torch.Tensor, expert: torch.Tensor,
            slot: torch.Tensor, keep: torch.Tensor, cap: int, first: int,
            stacks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kept tokens of experts ``[first, first + E_p)`` (``stacks`` =
    their ``w1 [E_p, d, h]``, ``b1``, ``w2``, ``b2``) through those
    experts: each gathered into an ``[E_p, C, d]`` buffer at ``(expert,
    slot)``, the two products ``torch.bmm``, and each token's row times
    its gate, ``[N, d]`` f32; tokens of other experts, and dropped ones,
    get 0."""
    from video_quierer_tpu_torch.models.clip.model import gelu_tanh
    w1, b1, w2, b2 = stacks
    n, d = xt.shape
    e = w1.shape[0]
    mine = keep & (expert >= first) & (expert < first + e)
    # flat slot of each token in the [E_p·C] buffers; other tokens point
    # at the spare slot E_p·C
    spare = e * cap
    flat = torch.where(mine, (expert - first) * cap + slot,
                       torch.full_like(slot, spare))
    # the token each slot holds; empty slots hold the zero row n
    token = torch.full((spare + 1,), n, dtype=torch.long, device=xt.device)
    token.scatter_(0, flat, torch.arange(n, device=xt.device))
    rows = torch.cat([xt, xt.new_zeros(1, d)])
    ein = rows[token[:spare]].reshape(e, cap, d)
    dt = xt.dtype
    z = gelu_tanh(torch.bmm(ein, w1.to(dt)) + b1[:, None].to(dt))
    y = torch.bmm(z, w2.to(dt)) + b2[:, None].to(dt)
    y = torch.cat([y.reshape(spare, d).float(),
                   y.new_zeros(1, d, dtype=torch.float32)])
    return y[flat] * gate[:, None]


def switch_aux(num_experts: int, n_tokens: int, counts: torch.Tensor,
               prob_sums: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance loss of a layer from its tokens' per-expert
    counts and probability sums over all ``n_tokens``: ``E · Σ_e frac_e ·
    mean_p_e``."""
    frac = counts.float() / n_tokens
    return num_experts * torch.sum(frac * (prob_sums / n_tokens))


class MoEEncoderBlock(nn.Module):
    """Pre-LN transformer block whose MLP is a :class:`SwitchMoEMLP`
    (the every-other-layer MoE tower's block). Returns ``(x, aux)``."""

    def __init__(self, c, num_experts: int, capacity_factor: float = 1.25,
                 causal: bool = False):
        super().__init__()
        from video_quierer_tpu_torch.models.clip.model import (
            Attention,
            LayerNorm,
        )
        d = c.hidden_size
        self.layer_norm1 = LayerNorm(d, c.layer_norm_eps)
        self.attn = Attention(d, c.num_heads, causal=causal)
        self.layer_norm2 = LayerNorm(d, c.layer_norm_eps)
        self.moe = SwitchMoEMLP(d, num_experts, ratio=c.mlp_ratio,
                                capacity_factor=capacity_factor)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x + self.attn(self.layer_norm1(x))
        moe_out, aux = self.moe(self.layer_norm2(x))
        return x + moe_out, aux


def expert_partition_spec(path: Union[str, Tuple[str, ...]],
                          leaf: torch.Tensor) -> Tuple:
    """The expert-parallel placement rule: the stacks ``w1/b1/w2/b2``
    split on their leading ``[E, ...]`` axis over :data:`EXPERT_AXIS`,
    the router and everything else replicated (``()``). ``path`` is a
    parameter name (``"vision.layers.1.moe.w1"``) or its parts."""
    names = path.split(".") if isinstance(path, str) else list(path)
    if names and names[-1] in EXPERT_STACKS:
        return (EXPERT_AXIS,) + (None,) * (leaf.ndim - 1)
    return ()


def shard_moe_params(params: Mapping[str, torch.Tensor], mesh):
    """Place a state dict on an expert mesh (a ``DataMesh`` whose second
    axis is :data:`EXPERT_AXIS`, :func:`expert_mesh`) by the EP rules: a
    ``parallel/mesh.py:ShardedTree`` whose expert stacks are split over
    the axis, everything else replicated."""
    from video_quierer_tpu_torch.parallel.mesh import ShardedTree
    specs = {k: tuple(ax if ax in mesh.shape else None
                      for ax in expert_partition_spec(k, v))
             for k, v in params.items()}
    return ShardedTree.place(params, mesh, specs)


def expert_mesh(n_devices: Optional[int] = None, *,
                devices: Optional[Sequence] = None):
    """The ``(expert,)`` mesh over the first ``n_devices`` CUDA devices (or
    of ``devices``), as a ``DataMesh`` of one data row: ``num_experts``
    must divide by its size. Without a card and without ``devices`` it
    raises."""
    from video_quierer_tpu_torch.parallel.mesh import (
        _cuda_devices,
        data_mesh,
    )
    devs = _cuda_devices(n_devices, devices, "an expert mesh")
    return data_mesh(devices=devs, model_parallel=len(devs),
                     axis=EXPERT_AXIS)
