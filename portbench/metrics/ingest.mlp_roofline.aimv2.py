"""The AIMv2 SiLU-gated half's share of its roofline in the traced slice:
its least time (``roofline_aimv2.mlp_half``, ``6 t d f`` operations) over
its kernels' device time (``rms_bf16``, the gate-and-up GEMM with the
gated epilogue, the down GEMM)."""

from portbench.readers_aimv2 import half_roofline


def read(r):
    return half_roofline(r, "mlp")
