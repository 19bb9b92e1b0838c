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
``nn.Linear`` (the JAX package leaves them to XLA outside any kernel);
attention is kernel B3 (``ops/attention.py``), as the flax towers route
it. LayerNorm keeps f32 statistics and casts to the tower dtype, as
flax's LayerNorm does. Inputs are NHWC images already normalised
(``ops/preprocess.py``), as in the JAX package. MoE vision towers are not
ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

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
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                        num_heads=self.num_heads, causal=self.causal)
        return self.out_proj(out)


class MLP(nn.Module):
    def __init__(self, d: int, ratio: int, act: str = "quick_gelu"):
        super().__init__()
        self.act = ACTIVATIONS[act]
        self.fc1 = nn.Linear(d, d * ratio)
        self.fc2 = nn.Linear(d * ratio, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


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
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(c.context_length, c.hidden_size))
        self.layers = nn.ModuleList(EncoderBlock(c, causal=True)
                                    for _ in range(c.num_layers))
        self.final_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` ids → pooled features ``[B, hidden]`` at each
        sequence's EOT token (highest id, first occurrence)."""
        x = self.token_embedding(input_ids) \
            + self.position_embedding[: input_ids.shape[1]][None]
        for block in self.layers:
            x = block(x)
        x = self.final_layer_norm(x)
        eot = torch.argmax(input_ids, dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot]


class VisionTower(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        if c.moe_experts:
            raise NotImplementedError("MoE vision towers are not ported")
        self.cfg = c
        d, p = c.hidden_size, c.patch_size
        # the flax conv kernel [p, p, 3, D] (HWIO) as a [D, p*p*3] matrix
        # over patches flattened in (row, column, channel) order
        self.patch_embedding = nn.Linear(p * p * 3, d, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Parameter(torch.zeros(c.seq_len, d))
        self.pre_layernorm = LayerNorm(d, c.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderBlock(c, causal=False)
                                    for _ in range(c.num_layers))
        self.post_layernorm = LayerNorm(d, c.layer_norm_eps)

    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        """NHWC ``[B, H, W, 3]`` normalised pixels → pre-LN tokens
        ``[B, S, D]``: patchify, class token, positions, pre-LN."""
        c = self.cfg
        b = pixels.shape[0]
        p, g = c.patch_size, c.image_size // c.patch_size
        dtype = self.class_embedding.dtype
        patches = (pixels.to(dtype).reshape(b, g, p, g, p, 3)
                   .permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3))
        x = torch.cat([self.class_embedding.expand(b, 1, -1),
                       self.patch_embedding(patches)], dim=1)
        return self.pre_layernorm(x + self.position_embedding[None])

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """Pooled pre-projection features ``[B, hidden]`` (post-LN CLS)."""
        x = self.embed(pixels)
        for block in self.layers:
            x = block(x)
        return self.post_layernorm(x[:, 0])


def _normalize_f32(feats: torch.Tensor, normalize: bool) -> torch.Tensor:
    """Cast to f32 BEFORE the L2 normalise (a bf16 norm leaves rows off
    unit length)."""
    feats = feats.float()
    if normalize:
        feats = feats / torch.linalg.vector_norm(feats, dim=-1,
                                                 keepdim=True)
    return feats


class CLIP(nn.Module):
    """Dual-tower CLIP with projection heads (serving only: no logit
    scale)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg.vision)
        self.text = TextTower(cfg.text)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size,
                                           cfg.projection_dim, bias=False)
        self.text_projection = nn.Linear(cfg.text.hidden_size,
                                         cfg.projection_dim, bias=False)

    def encode_image(self, pixels: torch.Tensor,
                     normalize: bool = True) -> torch.Tensor:
        feats = self.visual_projection(self.vision(pixels))
        return _normalize_f32(feats, normalize)

    def encode_text(self, input_ids: torch.Tensor,
                    normalize: bool = True) -> torch.Tensor:
        feats = self.text_projection(self.text(input_ids))
        return _normalize_f32(feats, normalize)
