"""The AIMv2 RMSNorm attention half's share of its roofline in the traced
slice: its least time (``roofline_aimv2.attn_half`` over the batch's
frames x 256 tokens) over its kernels' device time (``rms_bf16``, the
bias-free QKV GEMM, B3 at head width 128, the out-projection GEMM;
``readers_aimv2.halves``)."""

from portbench.readers_aimv2 import half_roofline


def read(r):
    return half_roofline(r, "attn")
