"""AIMv2's encodes on the gated layer halves (``ops/fused_layer.py``).

Each block is kernel B5 with RMSNorm and bias-free projections
(:func:`rms_attn_half`, B3 at head width 128 inside) then kernel B6 with
RMSNorm and the SiLU-gated epilogue (:func:`gated_mlp_half`):

- :func:`fused_aimv2_vision_encode`, the drop-in for
  ``AIMv2.encode_image``: the module's embedding (patch projection,
  RMSNorm, positions) → the blocks over ``B·256`` tokens, non-causal →
  the final RMSNorm, the attention-pooling head and ``visual_projection``
  (``torch`` GEMMs) → f32 L2 normalise;
- :func:`fused_aimv2_text_encode`, the drop-in for ``AIMv2.encode_text``
  on coalesced batches: token + position embedding → causal blocks →
  the first EOS's row → final RMSNorm → ``text_projection`` → f32 L2
  normalise.

``attn``/``mlp`` are :func:`rms_attn_half_ref`/:func:`gated_mlp_half_ref`
where a caller compares the kernels with the plain versions.
"""

from __future__ import annotations

from typing import List

import torch

from video_quierer_tpu_torch.models.aimv2.model import (
    EncoderLayer,
    _normalize_f32,
    first_eos,
)
from video_quierer_tpu_torch.ops.fused_layer import (
    GatedOps,
    gated_mlp_half,
    interleave_gate_up,
    rms_attn_half,
)


def gated_operands(layer: EncoderLayer, dtype) -> GatedOps:
    """One block's operands (``ops/fused_layer.py:GatedOps``): the two
    RMSNorm scales in f32, the rest ``[in, out]`` in ``dtype``."""
    a, m = layer.attention, layer.ffn
    rms = torch.stack([layer.rms_norm1.weight, layer.rms_norm2.weight])
    wqkv = torch.cat([a.q_proj.weight, a.k_proj.weight, a.v_proj.weight],
                     dim=0).t()
    wgu = interleave_gate_up(m.gate_proj.weight.t(), m.up_proj.weight.t())

    def c(t):
        return t.detach().to(dtype).contiguous()

    return (rms.detach().float().contiguous(), c(wqkv),
            c(a.out_proj.weight.t()), c(wgu), c(m.down_proj.weight.t()))


def _blocks(x2: torch.Tensor, layer_ops: List[GatedOps], c, s: int,
            causal: bool, attn, mlp) -> torch.Tensor:
    for ops in layer_ops:
        x2 = attn(x2, ops, s=s, heads=c.num_heads, eps=c.rms_norm_eps,
                  causal=causal)
        x2 = mlp(x2, ops, eps=c.rms_norm_eps)
    return x2


def fused_aimv2_vision_encode(model, pixels: torch.Tensor,
                              layer_ops: List[GatedOps], attn=rms_attn_half,
                              mlp=gated_mlp_half) -> torch.Tensor:
    """``model`` the port's ``AIMv2``; ``pixels`` normalised NHWC in the
    tower dtype; ``layer_ops`` :func:`gated_operands` of its vision
    blocks. Output ``[B, projection]`` f32 unit rows."""
    c = model.cfg.vision
    vm = model.vision_model
    b = pixels.shape[0]
    x = vm.embeddings(pixels)
    x2 = _blocks(x.reshape(-1, x.shape[-1]).contiguous(), layer_ops, c,
                 c.seq_len, False, attn, mlp)
    x = vm.rms_norm(x2.reshape(b, c.seq_len, -1))
    return _normalize_f32(model.visual_projection(vm.head(x)))


def fused_aimv2_text_encode(model, input_ids: torch.Tensor,
                            layer_ops: List[GatedOps], attn=rms_attn_half,
                            mlp=gated_mlp_half) -> torch.Tensor:
    """``layer_ops`` :func:`gated_operands` of the text blocks. Output
    ``[B, projection]`` f32 unit rows."""
    c = model.cfg.text
    tm = model.text_model
    b, s = input_ids.shape
    x = tm.embeddings(input_ids)
    x2 = _blocks(x.reshape(b * s, -1).contiguous(), layer_ops, c, s, True,
                 attn, mlp)
    rows = torch.arange(b, device=x2.device) * s \
        + first_eos(input_ids, c.eos_token_id)
    return _normalize_f32(model.text_projection(tm.rms_norm(x2[rows])))
