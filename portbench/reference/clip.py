"""CLIP's two towers, written from the published architecture in plain
PyTorch over a state dict (the leaf names of ``portbench/gen.py``).

- text: token + learned position embedding, pre-LN blocks with causal
  attention and quick-GELU, the final LayerNorm, pooling at the EOT token
  (the highest id, first occurrence), the text projection;
- vision: the 32 x 32 (or 14 x 14) patches flattened in (row, column,
  channel) order and projected without bias, the class token, learned
  positions, the pre-LayerNorm, non-causal pre-LN blocks, the
  post-LayerNorm of the class token, the visual projection;
- both outputs L2-normalised.

Every product runs in float32 with TF32 off, unless ``prec`` asks for a
lower precision, which the control uses: ``"tf32"`` rounds both operands
of every product to TF32's 10-bit mantissa, ``"fp8"`` to float8 e4m3
with one scale per tensor (its absolute maximum over 448), each with f32
accumulation, in the backward pass as in the forward. Everything else
(LayerNorm, softmax, GELU, sums) stays f32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32", "fp8")
_FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` (f32) rounded to ``prec`` and back to f32."""
    if prec == "f32":
        return x
    if prec == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if prec == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / _FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {prec!r}")


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        return torch.matmul(round_to(a, prec), round_to(b, prec))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.prec
        rg = round_to(g, p)
        ga = torch.matmul(rg, round_to(b, p).transpose(-1, -2))
        gb = torch.matmul(round_to(a, p).transpose(-1, -2), rg)
        if gb.dim() > b.dim():
            gb = gb.sum(dim=tuple(range(gb.dim() - b.dim())))
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return torch.matmul(a, b)
    return _RoundedMatmul.apply(a, b, prec)


def linear(x, w, b, prec):
    y = matmul(x, w.float().t(), prec)
    return y if b is None else y + b.float()


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def block(x, sd, pre, heads, causal, prec):
    bsz, s, d = x.shape
    hd = d // heads
    y = layer_norm(x, sd[pre + "layer_norm1.weight"],
                   sd[pre + "layer_norm1.bias"])

    def proj(name):
        t = linear(y, sd[pre + f"attn.{name}.weight"],
                   sd[pre + f"attn.{name}.bias"], prec)
        return t.reshape(bsz, s, heads, hd).transpose(1, 2)

    q, k, v = proj("q_proj"), proj("k_proj"), proj("v_proj")
    logits = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    attn = matmul(torch.softmax(logits, dim=-1), v, prec)
    attn = attn.transpose(1, 2).reshape(bsz, s, d)
    x = x + linear(attn, sd[pre + "attn.out_proj.weight"],
                   sd[pre + "attn.out_proj.bias"], prec)
    z = layer_norm(x, sd[pre + "layer_norm2.weight"],
                   sd[pre + "layer_norm2.bias"])
    h = quick_gelu(linear(z, sd[pre + "mlp.fc1.weight"],
                          sd[pre + "mlp.fc1.bias"], prec))
    return x + linear(h, sd[pre + "mlp.fc2.weight"], sd[pre + "mlp.fc2.bias"],
                      prec)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def encode_text(sd: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
                prec: str = "f32") -> torch.Tensor:
    """``[B, S]`` token ids → ``[B, projection]`` unit rows."""
    t = cfg["text_config"]
    s = ids.shape[1]
    x = (sd["text.token_embedding.weight"].float()[ids]
         + sd["text.position_embedding"].float()[:s][None])
    for i in range(t["num_hidden_layers"]):
        x = block(x, sd, f"text.layers.{i}.", t["num_attention_heads"],
                  True, prec)
    x = layer_norm(x, sd["text.final_layer_norm.weight"],
                   sd["text.final_layer_norm.bias"])
    pooled = x[torch.arange(x.shape[0], device=x.device),
               ids.argmax(dim=-1)]
    return _unit(linear(pooled, sd["text_projection.weight"], None, prec))


def encode_image(sd: Dict[str, torch.Tensor], cfg: dict,
                 pixels: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Normalised NHWC ``[B, H, W, 3]`` f32 pixels → ``[B, projection]``
    unit rows."""
    v = cfg["vision_config"]
    p = v["patch_size"]
    g = v["image_size"] // p
    b = pixels.shape[0]
    patches = (pixels.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
               .reshape(b, g * g, p * p * 3))
    x = linear(patches, sd["vision.patch_embedding.weight"], None, prec)
    cls = sd["vision.class_embedding"].float().expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + sd["vision.position_embedding"].float()
    x = layer_norm(x, sd["vision.pre_layernorm.weight"],
                   sd["vision.pre_layernorm.bias"])
    for i in range(v["num_hidden_layers"]):
        x = block(x, sd, f"vision.layers.{i}.", v["num_attention_heads"],
                  False, prec)
    pooled = layer_norm(x[:, 0], sd["vision.post_layernorm.weight"],
                        sd["vision.post_layernorm.bias"])
    return _unit(linear(pooled, sd["visual_projection.weight"], None, prec))
