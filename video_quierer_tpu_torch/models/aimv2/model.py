"""AIMv2 (LiT) in PyTorch: the module towers of
``transformers/models/aimv2/modeling_aimv2.py``, for serving.

- vision: the 14 x 14 patch projection (with bias) over NHWC patches
  flattened in (row, column, channel) order, RMSNorm, learned positions
  (no class token), pre-norm blocks, the final RMSNorm, the
  attention-pooling head (one learned query over the tokens, no q
  projection, ``output_proj`` with a bias), ``visual_projection``;
- text: token + learned position embedding, causal pre-norm blocks (the
  causal mask ``transformers`` builds from the processor's attention
  mask), the final RMSNorm, pooling at the first EOS, ``text_projection``;
- a block: ``x += o(attn(RMSNorm(x)))``, then ``x += down(silu(gate(z)) ·
  up(z))`` with ``z = RMSNorm(x)``; no biases;
- both outputs L2 normalised in f32.

Parameter names are ``Aimv2Model``'s, except the patch projection, whose
``[D, 3, p, p]`` conv kernel is held as a ``[D, p·p·3]`` matrix over NHWC
patches (``convert.py``). Attention is kernel B3 (``ops/attention.py``,
head width 128). RMSNorm and the gated MLP take the layer halves' forms
(``ops/fused_layer.py``: ``rms_f32``, ``silu_gate_kernel_form``), so the
module tower and the fused encode round alike in bf16; in f32 they are
``transformers``' functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from video_quierer_tpu_torch.models.aimv2.config import (
    AIMv2Config,
    AIMv2TextConfig,
    AIMv2VisionConfig,
)
from video_quierer_tpu_torch.ops.attention import attention
from video_quierer_tpu_torch.ops.fused_layer import (
    rms_f32,
    silu_gate_kernel_form,
)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_f32(x, self.weight, self.eps, x.dtype)


class Attention(nn.Module):
    def __init__(self, d: int, heads: int, causal: bool):
        super().__init__()
        self.num_heads, self.causal = heads, causal
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.out_proj = nn.Linear(d, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                      num_heads=self.num_heads, causal=self.causal)
        return self.out_proj(a)


class MLP(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.gate_proj = nn.Linear(d, f, bias=False)
        self.up_proj = nn.Linear(d, f, bias=False)
        self.down_proj = nn.Linear(f, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(silu_gate_kernel_form(self.gate_proj(x),
                                                    self.up_proj(x)))


class EncoderLayer(nn.Module):
    def __init__(self, c, causal: bool):
        super().__init__()
        self.attention = Attention(c.hidden_size, c.num_heads, causal)
        self.ffn = MLP(c.hidden_size, c.intermediate_size)
        self.rms_norm1 = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.rms_norm2 = RMSNorm(c.hidden_size, c.rms_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.rms_norm1(x))
        return x + self.ffn(self.rms_norm2(x))


class Encoder(nn.Module):
    def __init__(self, c, causal: bool):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(c, causal)
                                    for _ in range(c.num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class VisionEmbeddings(nn.Module):
    def __init__(self, c: AIMv2VisionConfig):
        super().__init__()
        self.cfg = c
        p = c.patch_size
        self.patch_embed = nn.Linear(p * p * 3, c.hidden_size)
        self.rms_norm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.position_embedding = nn.Embedding(c.num_patches, c.hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """NHWC ``[B, H, W, 3]`` normalised pixels → ``[B, S, D]``."""
        c = self.cfg
        b = pixels.shape[0]
        p, g = c.patch_size, c.image_size // c.patch_size
        dtype = self.patch_embed.weight.dtype
        patches = (pixels.to(dtype).reshape(b, g, p, g, p, 3)
                   .permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3))
        x = self.rms_norm(self.patch_embed(patches))
        return x + self.position_embedding.weight[None]


class AttentionPoolingHead(nn.Module):
    """One learned query attends over the tokens (f32 logits and
    softmax; k and v projected without bias, the query without any
    projection), then ``output_proj`` with its bias: ``[B, D]``."""

    def __init__(self, c: AIMv2VisionConfig):
        super().__init__()
        d = c.hidden_size
        self.num_heads = c.num_heads
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.output_proj = nn.Linear(d, d, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        hd = d // h
        k = self.k_proj(x).reshape(b, s, h, hd).float()
        v = self.v_proj(x).reshape(b, s, h, hd).float()
        q = self.cls_token.reshape(h, hd).float()
        w = torch.softmax(torch.einsum("hd,bshd->bhs", q, k) * hd ** -0.5,
                          dim=-1)
        out = torch.einsum("bhs,bshd->bhd", w, v).reshape(b, d)
        return self.output_proj(out.to(x.dtype))


class VisionModel(nn.Module):
    def __init__(self, c: AIMv2VisionConfig):
        super().__init__()
        self.embeddings = VisionEmbeddings(c)
        self.encoder = Encoder(c, causal=False)
        self.rms_norm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.head = AttentionPoolingHead(c)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.encoder(self.embeddings(pixels))
        return self.head(self.rms_norm(x))


def first_eos(input_ids: torch.Tensor, eos: int) -> torch.Tensor:
    """Each row's first EOS position (0 for a row without one, as
    ``transformers``' argmax)."""
    return (input_ids == eos).int().argmax(dim=-1)


class TextEmbeddings(nn.Module):
    def __init__(self, c: AIMv2TextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Embedding(c.context_length,
                                               c.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        return (F.embedding(input_ids, self.token_embedding.weight)
                + self.position_embedding.weight[:s][None])


class TextModel(nn.Module):
    def __init__(self, c: AIMv2TextConfig):
        super().__init__()
        self.cfg = c
        self.embeddings = TextEmbeddings(c)
        self.encoder = Encoder(c, causal=True)
        self.rms_norm = RMSNorm(c.hidden_size, c.rms_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` ids → ``[B, D]``, pooled at the first EOS (RMSNorm
        is per token: pooling before the final norm is exact)."""
        x = self.encoder(self.embeddings(input_ids))
        rows = torch.arange(x.shape[0], device=x.device)
        return self.rms_norm(x[rows, first_eos(input_ids,
                                               self.cfg.eos_token_id)])


def _normalize_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class AIMv2(nn.Module):
    """Both towers, their projections and the logit scale (unused in
    serving, kept as ``Aimv2Model`` has it)."""

    def __init__(self, cfg: AIMv2Config):
        super().__init__()
        self.cfg = cfg
        self.vision_model = VisionModel(cfg.vision)
        self.text_model = TextModel(cfg.text)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size,
                                           cfg.projection_dim, bias=False)
        self.text_projection = nn.Linear(cfg.text.hidden_size,
                                         cfg.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised NHWC pixels → ``[B, projection]`` f32 unit rows."""
        return _normalize_f32(self.visual_projection(
            self.vision_model(pixels)))

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` ids → ``[B, projection]`` f32 unit rows."""
        return _normalize_f32(self.text_projection(
            self.text_model(input_ids)))
