"""B6's share of its roofline in the traced slice: the least time of
each fused MLP half (``roofline.mlp_half``) over its kernels' device
time (LN, fc1 GEMM with the GELU, fc2 GEMM)."""

from portbench.readers import half_roofline


def read(r):
    return half_roofline(r, "mlp")
