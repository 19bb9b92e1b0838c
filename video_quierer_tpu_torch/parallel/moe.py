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
:func:`expert_partition_spec` names the expert split of those stacks;
placing them over several cards (``shard_moe_params``, ``expert_mesh``)
is a later port (ROADMAP A11b).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

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
        from video_quierer_tpu_torch.models.clip.model import gelu_tanh
        b, s, d = x.shape
        n, e = b * s, self.num_experts
        cap = capacity(n, e, self.capacity_factor)
        xt = x.reshape(n, d)
        probs = torch.softmax(self.router(xt.float()), dim=-1)
        gate, expert, slot, keep = route(probs, cap)
        # flat slot of each token in the [E·C] buffers; dropped tokens
        # point at the spare slot E·C
        spare = e * cap
        flat = torch.where(keep, expert * cap + slot,
                           torch.full_like(slot, spare))
        # the token each slot holds; empty slots hold the zero row n
        token = torch.full((spare + 1,), n, dtype=torch.long,
                           device=x.device)
        token.scatter_(0, flat, torch.arange(n, device=x.device))
        rows = torch.cat([xt, xt.new_zeros(1, d)])
        ein = rows[token[:spare]].reshape(e, cap, d)
        dt = x.dtype
        z = gelu_tanh(torch.bmm(ein, self.w1.to(dt))
                      + self.b1[:, None].to(dt))
        y = torch.bmm(z, self.w2.to(dt)) + self.b2[:, None].to(dt)
        y = torch.cat([y.reshape(spare, d).float(),
                       y.new_zeros(1, d, dtype=torch.float32)])
        out = y[flat] * gate[:, None]
        frac = nn.functional.one_hot(expert, e).float().mean(dim=0)
        aux = e * torch.sum(frac * probs.mean(dim=0))
        return out.reshape(b, s, d).to(dt), aux


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
