"""B5's share of its roofline in the traced slice: the least time of
each fused attention half (``roofline.attn_half`` over the batch's
frames x positions tokens) over its kernels' device time (LN, QKV GEMM,
B3, out-proj GEMM; ``segments.vision_halves``)."""

from portbench.readers import half_roofline


def read(r):
    return half_roofline(r, "attn")
