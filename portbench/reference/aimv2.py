"""AIMv2 (LiT) in plain PyTorch over ``Aimv2Model``'s state dict (the
names and shapes of ``portbench/gen_aimv2.py``), written from
``transformers/models/aimv2/modeling_aimv2.py``:

- vision: the 14 x 14 patch conv (with bias) as a product over
  ``[3, p, p]`` patches, RMSNorm, learned positions (no class token),
  pre-norm blocks, the final RMSNorm, the attention-pooling head (the
  learned query without projection against bias-free ``k_proj`` and
  ``v_proj``, then ``output_proj`` with its bias), ``visual_projection``;
- text: token + learned position embedding, causal pre-norm blocks, the
  final RMSNorm, pooling at the first EOS, ``text_projection``;
- a block: ``x += o(attn(RMSNorm(x)))``, ``x += down(silu(gate(z)) ·
  up(z))``, ``z = RMSNorm(x)``, no biases; RMSNorm ``x · rsqrt(mean(x²)
  + eps) · w``;
- both outputs L2-normalised.

Departures from ``modeling_aimv2.py``, none in value: pixels come NHWC;
the text tower is always causal (``transformers`` applies the causal
mask when the processor's attention mask is given, which is how the
checkpoint is served); the final text RMSNorm is taken at the pooled
position only (it is per token); the pooling head's attention is written
out where ``transformers`` calls ``scaled_dot_product_attention``.

Every product runs in float32 with TF32 off unless ``prec`` asks for a
lower precision (the control): ``"tf32"`` or ``"fp8"`` operands with f32
accumulation (``portbench/reference/clip.py:round_to``). Everything else
(RMSNorm, softmax, SiLU, sums) stays f32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.clip import linear, matmul


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def block(x, sd, pre, heads, causal, eps, prec):
    bsz, s, d = x.shape
    hd = d // heads
    y = rms_norm(x, sd[pre + "rms_norm1.weight"], eps)

    def proj(name):
        t = linear(y, sd[pre + f"attention.{name}.weight"], None, prec)
        return t.reshape(bsz, s, heads, hd).transpose(1, 2)

    q, k, v = proj("q_proj"), proj("k_proj"), proj("v_proj")
    logits = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    attn = matmul(torch.softmax(logits, dim=-1), v, prec)
    attn = attn.transpose(1, 2).reshape(bsz, s, d)
    x = x + linear(attn, sd[pre + "attention.out_proj.weight"], None, prec)
    z = rms_norm(x, sd[pre + "rms_norm2.weight"], eps)
    g = linear(z, sd[pre + "ffn.gate_proj.weight"], None, prec)
    u = linear(z, sd[pre + "ffn.up_proj.weight"], None, prec)
    return x + linear(F.silu(g) * u, sd[pre + "ffn.down_proj.weight"], None,
                      prec)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def encode_image(sd: Dict[str, torch.Tensor], cfg: dict,
                 pixels: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Normalised NHWC ``[B, H, W, 3]`` f32 pixels → ``[B, projection]``
    unit rows."""
    v = cfg["vision_config"]
    p = v["patch_size"]
    g = v["image_size"] // p
    b = pixels.shape[0]
    eps, heads = v["rms_norm_eps"], v["num_attention_heads"]
    pre = "vision_model."
    patches = (pixels.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)
               .reshape(b, g * g, 3 * p * p))
    w = sd[pre + "embeddings.patch_embed.weight"]
    x = linear(patches, w.reshape(w.shape[0], -1),
               sd[pre + "embeddings.patch_embed.bias"], prec)
    x = rms_norm(x, sd[pre + "embeddings.rms_norm.weight"], eps)
    x = x + sd[pre + "embeddings.position_embedding.weight"].float()[None]
    for i in range(v["num_hidden_layers"]):
        x = block(x, sd, f"{pre}encoder.layers.{i}.", heads, False, eps,
                  prec)
    x = rms_norm(x, sd[pre + "rms_norm.weight"], eps)
    d = x.shape[-1]
    hd = d // heads
    s = x.shape[1]
    k = linear(x, sd[pre + "head.k_proj.weight"], None, prec)
    val = linear(x, sd[pre + "head.v_proj.weight"], None, prec)
    k = k.reshape(b, s, heads, hd).transpose(1, 2)
    val = val.reshape(b, s, heads, hd).transpose(1, 2)
    q = sd[pre + "head.cls_token"].float().reshape(1, heads, 1, hd)
    logits = matmul(q.expand(b, -1, -1, -1), k.transpose(-1, -2),
                    prec) / math.sqrt(hd)
    out = matmul(torch.softmax(logits, dim=-1), val, prec).reshape(b, d)
    out = linear(out, sd[pre + "head.output_proj.weight"],
                 sd[pre + "head.output_proj.bias"], prec)
    return _unit(linear(out, sd["visual_projection.weight"], None, prec))


def encode_text(sd: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
                prec: str = "f32") -> torch.Tensor:
    """``[B, S]`` token ids → ``[B, projection]`` unit rows."""
    t = cfg["text_config"]
    pre = "text_model."
    s = ids.shape[1]
    eps = t["rms_norm_eps"]
    x = (sd[pre + "embeddings.token_embedding.weight"].float()[ids]
         + sd[pre + "embeddings.position_embedding.weight"].float()[:s][None])
    for i in range(t["num_hidden_layers"]):
        x = block(x, sd, f"{pre}encoder.layers.{i}.",
                  t["num_attention_heads"], True, eps, prec)
    pos = (ids == t["eos_token_id"]).int().argmax(dim=-1)
    pooled = rms_norm(x[torch.arange(x.shape[0], device=x.device), pos],
                      sd[pre + "rms_norm.weight"], eps)
    return _unit(linear(pooled, sd["text_projection.weight"], None, prec))
