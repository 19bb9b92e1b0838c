"""The SigLIP text encode on the layer-half kernels (counterpart of
``video_quierer_tpu/models/siglip/fused.py``).

:func:`fused_siglip_text_encode` is the drop-in for
``SigLIP.encode_text`` on coalesced batches: token + position embedding →
per block kernel B5 (``attn_half``, non-causal) then kernel B6
(``mlp_half``, tanh-GELU) → the pooled LAST token (LayerNorm is per
token, so pooling before the final LN is exact) → final LN → head →
f32 L2 normalise. At SigLIP's 768 width the JAX package runs the same two
halves (its split mode).

The vision tower has no fused encode in either package: the JAX package
deleted its fused twin as slower than the module tower, and the port's
SigLIP vision serves on the module tower too (B3 and ``torch.matmul``).
"""

from __future__ import annotations

from typing import List

import torch

from video_quierer_tpu_torch.ops.fused_layer import (
    LayerOps,
    _ln_f32,
    _normalize_out,
    attn_half,
    mlp_half,
)


def fused_siglip_text_encode(model, input_ids: torch.Tensor,
                             layer_ops: List[LayerOps], attn=attn_half,
                             mlp=mlp_half) -> torch.Tensor:
    """``model`` is the port's ``SigLIP`` module; ``layer_ops`` the
    per-block operands of ``model.text.layers``
    (``ops/fused_layer.py:_layer_operands``); ``attn``/``mlp`` are
    :func:`attn_half_ref`/:func:`mlp_half_ref` where a caller compares the
    kernels with the plain versions on the card. Output ``[B, hidden]``
    f32 unit rows."""
    c = model.cfg.text
    tower = model.text
    dtype = tower.token_embedding.weight.dtype
    b, s = input_ids.shape
    x = tower.token_embedding.weight[input_ids] \
        + tower.position_embedding[:s][None]
    x2 = x.reshape(b * s, -1).contiguous()
    for ops in layer_ops:
        x2 = attn(x2, ops, s=s, heads=c.num_heads, eps=c.layer_norm_eps,
                  causal=False)
        x2 = mlp(x2, ops, eps=c.layer_norm_eps, act="gelu_tanh")
    pooled = x2[torch.arange(b, device=x2.device) * s + (s - 1)]
    fl = tower.final_layer_norm
    pooled = _ln_f32(pooled, fl.weight, fl.bias, c.layer_norm_eps, dtype)
    head = tower.head
    feats = (pooled.float() @ head.weight.float().t()).to(dtype) + head.bias
    return _normalize_out(feats, dtype)
