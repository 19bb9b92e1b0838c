"""A plain f32 AIMv2 over ``Aimv2Model``'s state dict (its names and
shapes, the patch projection as the ``[D, 3, p, p]`` conv kernel), for
the tests that hold the port's towers and fused encodes to it. No kernel
of the port runs here; it imports nothing of the port but the
configuration dataclass.

It computes what ``transformers/models/aimv2/modeling_aimv2.py``
computes, in float32 (the tests turn TF32 off), with these departures in
form, none in value:

- pixels come NHWC (the port's layout) and the patch conv is a matmul
  over ``[3, p, p]`` patches;
- the text tower is always causal: ``transformers`` applies the causal
  mask when the processor's attention mask is given, which is how the
  checkpoint is served;
- the final text RMSNorm is taken at the pooled position only (RMSNorm
  is per token);
- the pooling head's attention is written out (f32 softmax) where
  ``transformers`` calls ``scaled_dot_product_attention``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from video_quierer_tpu_torch.models.aimv2.config import AIMv2Config


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    y = x @ w.float().t()
    return y if b is None else y + b.float()


def block(x: torch.Tensor, sd: Dict[str, torch.Tensor], pre: str,
          heads: int, causal: bool, eps: float) -> torch.Tensor:
    bsz, s, d = x.shape
    hd = d // heads
    y = rms_norm(x, sd[pre + "rms_norm1.weight"], eps)

    def proj(name):
        return linear(y, sd[pre + f"attention.{name}.weight"]).reshape(
            bsz, s, heads, hd).transpose(1, 2)

    q, k, v = proj("q_proj"), proj("k_proj"), proj("v_proj")
    logits = q @ k.transpose(-1, -2) / math.sqrt(hd)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    a = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(bsz, s, d)
    x = x + linear(a, sd[pre + "attention.out_proj.weight"])
    z = rms_norm(x, sd[pre + "rms_norm2.weight"], eps)
    g = linear(z, sd[pre + "ffn.gate_proj.weight"])
    u = linear(z, sd[pre + "ffn.up_proj.weight"])
    return x + linear(torch.nn.functional.silu(g) * u,
                      sd[pre + "ffn.down_proj.weight"])


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def vision_features(sd: Dict[str, torch.Tensor], cfg: AIMv2Config,
                    pixels: torch.Tensor) -> torch.Tensor:
    """Normalised NHWC f32 pixels → the pooling head's output ``[B, D]``
    (before ``visual_projection``)."""
    v = cfg.vision
    p, g = v.patch_size, v.image_size // v.patch_size
    b = pixels.shape[0]
    pre = "vision_model."
    patches = (pixels.float().reshape(b, g, p, g, p, 3)
               .permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, 3 * p * p))
    w = sd[pre + "embeddings.patch_embed.weight"].float()
    x = linear(patches, w.reshape(w.shape[0], -1),
               sd[pre + "embeddings.patch_embed.bias"])
    x = rms_norm(x, sd[pre + "embeddings.rms_norm.weight"], v.rms_norm_eps)
    x = x + sd[pre + "embeddings.position_embedding.weight"].float()[None]
    for i in range(v.num_layers):
        x = block(x, sd, f"{pre}encoder.layers.{i}.", v.num_heads, False,
                  v.rms_norm_eps)
    x = rms_norm(x, sd[pre + "rms_norm.weight"], v.rms_norm_eps)
    h, d = v.num_heads, v.hidden_size
    hd = d // h
    s = x.shape[1]
    k = linear(x, sd[pre + "head.k_proj.weight"]).reshape(b, s, h, hd)
    val = linear(x, sd[pre + "head.v_proj.weight"]).reshape(b, s, h, hd)
    q = sd[pre + "head.cls_token"].float().reshape(h, hd)
    w_ = torch.softmax(torch.einsum("hd,bshd->bhs", q, k) / math.sqrt(hd),
                       dim=-1)
    out = torch.einsum("bhs,bshd->bhd", w_, val).reshape(b, d)
    return linear(out, sd[pre + "head.output_proj.weight"],
                  sd[pre + "head.output_proj.bias"])


def encode_image(sd: Dict[str, torch.Tensor], cfg: AIMv2Config,
                 pixels: torch.Tensor) -> torch.Tensor:
    """Normalised NHWC f32 pixels → ``[B, projection]`` unit rows."""
    return _unit(linear(vision_features(sd, cfg, pixels),
                        sd["visual_projection.weight"]))


def text_features(sd: Dict[str, torch.Tensor], cfg: AIMv2Config,
                  ids: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` ids → the pooled, normed ``[B, D]`` (before
    ``text_projection``)."""
    t = cfg.text
    pre = "text_model."
    s = ids.shape[1]
    x = (sd[pre + "embeddings.token_embedding.weight"].float()[ids]
         + sd[pre + "embeddings.position_embedding.weight"].float()[:s][None])
    for i in range(t.num_layers):
        x = block(x, sd, f"{pre}encoder.layers.{i}.", t.num_heads, True,
                  t.rms_norm_eps)
    pos = (ids == t.eos_token_id).int().argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), pos]
    return rms_norm(pooled, sd[pre + "rms_norm.weight"], t.rms_norm_eps)


def encode_text(sd: Dict[str, torch.Tensor], cfg: AIMv2Config,
                ids: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` ids → ``[B, projection]`` unit rows."""
    return _unit(linear(text_features(sd, cfg, ids),
                        sd["text_projection.weight"]))
