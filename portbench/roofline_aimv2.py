"""Operations and bytes of AIMv2's vision tower, from its shapes
(``transformers/models/aimv2/modeling_aimv2.py``), on the H100 peaks of
``portbench/roofline.py``. Frozen here so that no change to the program
can move the yardstick. As there, a kernel's least time is the larger of
its bytes over the HBM rate and its operations over the bf16 peak, each
input byte counted once and each output byte once.

- the RMSNorm attention half over ``t`` tokens in items of ``s``:
  ``8 t d^2`` (Q, K, V and output projections) ``+ 4 t s d`` (``QK^T``
  and ``PV``) operations; x read and out written (bf16), the four
  matrices (bf16) and the norm's scale (f32) read once, no biases;
- the gated half: ``6 t d f`` operations (gate, up and down); x read,
  out written, the three matrices and the scale read once;
- a frame: the patch projection, the blocks, the attention-pooling head
  (``k_proj`` and ``v_proj`` over the frame's tokens, the query's
  ``QK^T`` and ``PV``, ``output_proj``) and ``visual_projection``.
"""

from __future__ import annotations

from portbench.roofline import PEAK_FLOPS, bound_s  # noqa: F401


def attn_half(t: int, d: int, s: int) -> tuple:
    """``(bytes, operations)`` of the RMSNorm attention half."""
    return (2 * 2 * t * d + 2 * 4 * d * d + 4 * d,
            8 * t * d * d + 4 * t * s * d)


def mlp_half(t: int, d: int, f: int) -> tuple:
    """``(bytes, operations)`` of the SiLU-gated half."""
    return (2 * 2 * t * d + 2 * 3 * d * f + 4 * d, 6 * t * d * f)


def block_flops(s: int, d: int, f: int) -> float:
    """Forward operations of one block over ``s`` positions."""
    return 8 * s * d * d + 4 * s * s * d + 6 * s * d * f


def seq_len(cfg: dict) -> int:
    v = cfg["vision_config"]
    return (v["image_size"] // v["patch_size"]) ** 2


def vision_flops(cfg: dict) -> float:
    """Forward operations of the vision tower for one frame."""
    v = cfg["vision_config"]
    d, p = v["hidden_size"], v["patch_size"]
    s = seq_len(cfg)
    head = 2 * 2 * s * d * d + 2 * 2 * s * d + 2 * d * d
    return (2 * s * p * p * 3 * d
            + v["num_hidden_layers"] * block_flops(s, d,
                                                    v["intermediate_size"])
            + head + 2 * d * cfg["projection_dim"])
