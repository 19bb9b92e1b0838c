"""CLIP in PyTorch (counterpart of ``video_quierer_tpu/models/clip/model.py``).

Architecture of ``openai/clip-vit-base-patch32``, both towers:

- vision: patchify (the flax conv as a matmul over NHWC patches, no bias),
  class token, learned positions, pre-LN, non-causal pre-LN encoder
  blocks with quick-GELU, post-LN on the CLS token, linear projection;
- text: token + learned position embedding, causal encoder blocks, final
  LayerNorm, pooling at the EOT token (the highest id), linear
  projection;
- both outputs are L2 normalised in f32.

Module and parameter names follow the flax tree (``models/clip/bridge.py``
maps one onto the other). The q/k/v/out, fc and patch projections are
:class:`Linear`, an ``nn.Linear`` (the JAX package leaves them to XLA
outside any kernel);
attention is kernel B3 (``ops/attention.py``), as the flax towers route
it. LayerNorm keeps f32 statistics and casts to the tower dtype, as
flax's LayerNorm does. Inputs are NHWC images already normalised
(``ops/preprocess.py``), as in the JAX package.

Switch-MoE vision towers (``vision.moe_experts > 0``, JAX ``:130-165``):
layer ``i`` is a ``parallel/moe.py:MoEEncoderBlock`` where ``i %
moe_every == moe_every - 1``, else the dense block. Each MoE block also
returns its load-balance ``aux``: the forwards take an ``aux`` list and
append every MoE block's to it, in layer order, for the trainer's loss
(flax sows it into the ``losses`` collection); serving passes none and the
values are dropped, as flax drops them when ``losses`` is not mutable.

Training (JAX ``CLIP.__call__``, ``:250-284``): ``forward(pixels,
input_ids)`` returns ``(img, txt, exp(logit_scale))``, the scale an f32
parameter initialised to ``cfg.logit_scale_init``. ``CLIP(cfg, dtype,
remat)`` mirrors flax's module fields:

- ``dtype`` is the compute dtype, apart from the parameters' (flax's
  ``dtype`` over f32 ``param_dtype``): the pixels, the embeddings and the
  positions are cast to it where they are used, and each :class:`Linear`
  casts its weight and bias to its input's dtype, so f32 parameters
  train a bf16 tower; LayerNorm statistics stay f32. ``None`` (the
  default) computes in the parameters' dtype: a serving module is cast
  whole by ``embedder.place_module``, and every cast is then a no-op;
- ``remat`` runs each encoder block through ``torch.utils.checkpoint``
  (``use_reentrant=False``) when grad mode is on, as ``nn.remat`` does
  (JAX ``:155-158``): its activations are recomputed in the backward.

Tensor parallelism (the trainer's ``(data, model)`` mesh,
``train/trainer.py``): the forwards take a ``plan``, one data row's
placement, whose ``block(block, x)`` then runs each encoder block in the
block's place (the plan splits attention by heads and the MLP by its
hidden columns over the row's devices). A part of a split block is
:meth:`Attention.part` and :meth:`MLP.part`: the Megatron column slice
of the first products and the matching rows of the second, returned as
a partial sum without the second bias (added once, after the sum).
Without a plan nothing of this runs.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from video_quierer_tpu_torch.models.clip.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from video_quierer_tpu_torch.ops.attention import attention
from video_quierer_tpu_torch.ops.fused_layer import _const, _ln_f32


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: ``x * sigmoid(1.702 x)`` (not tanh-GELU)."""
    return x * torch.sigmoid(_const(1.702, x.dtype) * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """SigLIP's activation, ``jax.nn.gelu(approximate=True)``'s chain:
    ``x · (0.5·(1 + tanh(√(2/π)·(x + 0.044715·x³))))`` with √(2/π) cast
    to the dtype. The fused kernels' sigmoid form is another chain
    (``ops/fused_layer.py:gelu_kernel_form``)."""
    dt = x.dtype
    c = _const(math.sqrt(2 / math.pi), dt)
    inner = c * (x + _const(0.044715, dt) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu_tanh": gelu_tanh}


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias take its input's dtype where
    they are used (flax ``Dense(dtype=...)``); a no-op cast when they
    already have it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def run_blocks(layers: nn.ModuleList, x: torch.Tensor, remat: bool,
               aux: Optional[list] = None, plan=None) -> torch.Tensor:
    """``x`` through each block (through ``plan.block(block, x)`` when a
    tensor-parallel plan is given); with ``remat`` and grad mode on, each
    block's activations are recomputed in the backward. A block that
    returns ``(x, aux)`` (an MoE block) has its ``aux`` appended to
    ``aux`` when a list is given."""
    for block in layers:
        fn = block if plan is None else functools.partial(plan.block, block)
        if remat and torch.is_grad_enabled():
            x = checkpoint(fn, x, use_reentrant=False)
        else:
            x = fn(x)
        if isinstance(x, tuple):
            x, block_aux = x
            if aux is not None:
                aux.append(block_aux)
    return x


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics, output in the input dtype."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ln_f32(x, self.weight, self.bias, self.eps, x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention with separate q/k/v/out projections."""

    def __init__(self, d: int, num_heads: int, causal: bool):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.out_proj = Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                        num_heads=self.num_heads, causal=self.causal)
        return self.out_proj(out)

    def part(self, x: torch.Tensor, w: Dict[str, torch.Tensor],
             num_heads: int) -> torch.Tensor:
        """One tensor-parallel part: ``num_heads`` heads through the column
        slices ``w["q_proj.weight"]``, ``w["q_proj.bias"]`` (and k, v),
        attention (B3), then the out projection's matching input columns
        ``w["out_proj.weight"]`` without its bias: this part's term of
        the output, ``[B, S, D]``."""
        dt = x.dtype
        q, k, v = (F.linear(x, w[f"{n}.weight"].to(dt),
                            w[f"{n}.bias"].to(dt))
                   for n in ("q_proj", "k_proj", "v_proj"))
        out = attention(q, k, v, num_heads=num_heads, causal=self.causal)
        return F.linear(out, w["out_proj.weight"].to(dt))


class MLP(nn.Module):
    def __init__(self, d: int, ratio: int, act: str = "quick_gelu"):
        super().__init__()
        self.act = ACTIVATIONS[act]
        self.fc1 = Linear(d, d * ratio)
        self.fc2 = Linear(d * ratio, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))

    def part(self, x: torch.Tensor, w: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """One tensor-parallel part: the hidden columns ``w["fc1.weight"]``,
        ``w["fc1.bias"]``, the activation, and the matching input columns
        of ``w["fc2.weight"]`` without fc2's bias: a partial sum."""
        dt = x.dtype
        h = self.act(F.linear(x, w["fc1.weight"].to(dt),
                              w["fc1.bias"].to(dt)))
        return F.linear(h, w["fc2.weight"].to(dt))


class EncoderBlock(nn.Module):
    """Pre-LN block; ``causal`` comes from its tower (text True, vision
    False), ``act`` from its family (CLIP quick-GELU, SigLIP tanh-GELU)."""

    def __init__(self, c: CLIPTextConfig | CLIPVisionConfig, causal: bool,
                 act: str = "quick_gelu"):
        super().__init__()
        d = c.hidden_size
        self.layer_norm1 = LayerNorm(d, c.layer_norm_eps)
        self.attn = Attention(d, c.num_heads, causal=causal)
        self.layer_norm2 = LayerNorm(d, c.layer_norm_eps)
        self.mlp = MLP(d, c.mlp_ratio, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class TextTower(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.cfg = c
        self.compute_dtype: Optional[torch.dtype] = None
        self.remat = False
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(c.context_length, c.hidden_size))
        self.layers = nn.ModuleList(EncoderBlock(c, causal=True)
                                    for _ in range(c.num_layers))
        self.final_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, plan=None) -> torch.Tensor:
        """``[B, S]`` ids → pooled features ``[B, hidden]`` at each
        sequence's EOT token (highest id, first occurrence)."""
        dtype = self.compute_dtype or self.token_embedding.weight.dtype
        x = F.embedding(input_ids, self.token_embedding.weight.to(dtype)) \
            + self.position_embedding[: input_ids.shape[1]].to(dtype)[None]
        x = run_blocks(self.layers, x, self.remat, plan=plan)
        x = self.final_layer_norm(x)
        eot = torch.argmax(input_ids, dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot]


def is_moe_layer(c: CLIPVisionConfig, i: int) -> bool:
    """Whether vision layer ``i`` is a Switch-MoE block."""
    return c.moe_experts > 0 and i % c.moe_every == c.moe_every - 1


def vision_block(c: CLIPVisionConfig, i: int) -> nn.Module:
    """Vision layer ``i``: an MoE block or the dense one."""
    if is_moe_layer(c, i):
        from video_quierer_tpu_torch.parallel.moe import MoEEncoderBlock
        return MoEEncoderBlock(c, c.moe_experts, c.moe_capacity)
    return EncoderBlock(c, causal=False)


class VisionTower(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.cfg = c
        self.compute_dtype: Optional[torch.dtype] = None
        self.remat = False
        d, p = c.hidden_size, c.patch_size
        # the flax conv kernel [p, p, 3, D] (HWIO) as a [D, p*p*3] matrix
        # over patches flattened in (row, column, channel) order
        self.patch_embedding = Linear(p * p * 3, d, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Parameter(torch.zeros(c.seq_len, d))
        self.pre_layernorm = LayerNorm(d, c.layer_norm_eps)
        self.layers = nn.ModuleList(vision_block(c, i)
                                    for i in range(c.num_layers))
        self.post_layernorm = LayerNorm(d, c.layer_norm_eps)

    def tokens(self, pixels: torch.Tensor) -> torch.Tensor:
        """NHWC ``[B, H, W, 3]`` normalised pixels → tokens ``[B, S, D]``
        before the pre-LN: patchify, class token, positions."""
        c = self.cfg
        b = pixels.shape[0]
        p, g = c.patch_size, c.image_size // c.patch_size
        dtype = self.compute_dtype or self.class_embedding.dtype
        patches = (pixels.to(dtype).reshape(b, g, p, g, p, 3)
                   .permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3))
        x = torch.cat([self.class_embedding.to(dtype).expand(b, 1, -1),
                       self.patch_embedding(patches)], dim=1)
        return x + self.position_embedding.to(dtype)[None]

    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """NHWC ``[B, H, W, 3]`` normalised pixels → pre-LN tokens
        ``[B, S, D]``: patchify, class token, positions, pre-LN."""
        return self.pre_layernorm(self.tokens(pixels))

    def forward(self, pixels: torch.Tensor, aux: Optional[list] = None,
                plan=None) -> torch.Tensor:
        """Pooled pre-projection features ``[B, hidden]`` (post-LN CLS);
        MoE blocks' ``aux`` appended to ``aux``."""
        x = run_blocks(self.layers, self.embed(pixels), self.remat, aux,
                       plan)
        return self.post_layernorm(x[:, 0])


def _normalize_f32(feats: torch.Tensor, normalize: bool) -> torch.Tensor:
    """Cast to f32 BEFORE the L2 normalise (a bf16 norm leaves rows off
    unit length)."""
    feats = feats.float()
    if normalize:
        feats = feats / torch.linalg.vector_norm(feats, dim=-1,
                                                 keepdim=True)
    return feats


def configure_towers(towers, dtype: Optional[torch.dtype],
                     remat: bool) -> None:
    """Set each tower's compute dtype and remat (the module fields flax
    passes down)."""
    for tower in towers:
        tower.compute_dtype = dtype
        tower.remat = remat


class CLIP(nn.Module):
    """Dual-tower CLIP with projection heads and a trainable logit
    scale."""

    def __init__(self, cfg: CLIPConfig, dtype: Optional[torch.dtype] = None,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg.vision)
        self.text = TextTower(cfg.text)
        self.visual_projection = Linear(cfg.vision.hidden_size,
                                        cfg.projection_dim, bias=False)
        self.text_projection = Linear(cfg.text.hidden_size,
                                      cfg.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init))
        configure_towers((self.vision, self.text), dtype, remat)

    def encode_image(self, pixels: torch.Tensor, normalize: bool = True,
                     aux: Optional[list] = None, plan=None) -> torch.Tensor:
        feats = self.visual_projection(self.vision(pixels, aux, plan))
        return _normalize_f32(feats, normalize)

    def encode_text(self, input_ids: torch.Tensor, normalize: bool = True,
                    plan=None) -> torch.Tensor:
        feats = self.text_projection(self.text(input_ids, plan))
        return _normalize_f32(feats, normalize)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor,
                aux: Optional[list] = None, plan=None):
        """Training forward: ``(image_feats, text_feats, logit_scale)``,
        the features f32 unit rows, the scale ``exp`` of the parameter;
        the MoE blocks' ``aux`` appended to ``aux``; each encoder block
        through ``plan`` when one is given."""
        return (self.encode_image(pixels, aux=aux, plan=plan),
                self.encode_text(input_ids, plan=plan),
                self.logit_scale.exp())
