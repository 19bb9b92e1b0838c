"""Reading logic of the AIMv2 cell's per-layer metrics
(``portbench/metrics/<metric>.aimv2.py``): its block halves found in a
traced slice, and their shares of the roofline and of the peak, with
``portbench/roofline_aimv2.py``'s arithmetic.

One ingest batch runs, per block, the RMSNorm attention half (kernel
B5: ``rms_bf16``, the bias-free QKV ``gemm_wgmma`` with epilogue code 3,
``attn_bf16`` at head width 128, the bias-free out-projection with the
residual, code 3) and the gated half (kernel B6: ``rms_bf16``, the gate
and up ``gemm_wgmma`` with the SiLU-gated epilogue, code 4, the down
projection, code 3), in launch order on one stream. A program without
these kernels (one that runs no AIMv2 tower) reads None.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench import roofline_aimv2 as rl
from portbench import segments
from portbench.trace import DeviceOp, gemm_act

NO_BIAS, SILU_GATE = 3, 4


def halves(ops: List[DeviceOp]) -> Tuple[list, list]:
    """``(attn, mlp)``: the kernel groups of each half, in launch order;
    a sequence that does not match is skipped."""
    ks = segments.kernels(ops)
    attn, mlp = [], []
    for j, o in enumerate(ks):
        if "attn_bf16" in o.name and 2 <= j < len(ks) - 1:
            grp = ks[j - 2:j + 2]
            if ("rms_bf16" in grp[0].name
                    and gemm_act(grp[1].name) == NO_BIAS
                    and gemm_act(grp[3].name) == NO_BIAS):
                attn.append(grp)
        if gemm_act(o.name) == SILU_GATE and 1 <= j < len(ks) - 1:
            grp = ks[j - 1:j + 2]
            if "rms_bf16" in grp[0].name \
                    and gemm_act(grp[2].name) == NO_BIAS:
                mlp.append(grp)
    return attn, mlp


def half_roofline(r, half: str):
    """The attention (``half`` "attn") or gated ("mlp") half's share of
    its roofline: its least time over the batch's frames x 256 tokens,
    times the halves found, over their kernels' device time."""
    if r.slice is None:
        return None
    attn, mlp = halves(r.slice.ops)
    groups = attn if half == "attn" else mlp
    spent = sum(segments.seconds(g) for g in groups)
    if not groups or spent <= 0:
        return None
    v = r.cfg["vision_config"]
    s = rl.seq_len(r.cfg)
    t = r.traffic["batch_frames"] * s
    counts = (rl.attn_half(t, v["hidden_size"], s) if half == "attn"
              else rl.mlp_half(t, v["hidden_size"], v["intermediate_size"]))
    return 100.0 * len(groups) * rl.bound_s(*counts, "bf16") / spent


def ingest_mfu(r):
    """The tower's operations per frame times the frames of the batches
    begun in the traced slice, over its seconds at 989 TFLOP/s; None
    where the slice ran none of AIMv2's halves."""
    s = r.slice
    if s is None or not s.ops or not s.units or s.window_s <= 0:
        return None
    if not any(halves(s.ops)):
        return None
    frames = s.units * r.traffic["batch_frames"]
    return 100.0 * rl.vision_flops(r.cfg) * frames / (
        s.window_s * rl.PEAK_FLOPS["bf16"])
