"""Operations and bytes from shapes, and the peaks of one NVIDIA H100.

Frozen here so that no change to the program can move the yardstick.
The arithmetic follows ``chip_smoke.py`` (``bound``, ``half_bounds``,
``_scan_bound``): a kernel's least time is the larger of its bytes over
the HBM rate and its operations over the peak of their type; each input
byte is counted once and each output byte once. The tower counts follow
the published CLIP layer equations: a pre-LN block of width ``d``, MLP
width ``f`` and ``s`` positions costs ``8 s d^2`` (Q, K, V and output
projections) ``+ 4 s^2 d`` (``QK^T`` and ``PV``) ``+ 4 s d f`` (the MLP)
operations; a causal text block is counted at the query's own token
count, not its padded bucket.
"""

from __future__ import annotations

from typing import Iterable

# NVIDIA's H100 SXM data sheet, dense, at 700 W
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12

# the candidate scan's winners per bucket and rounds (the reference's scan
# geometry, ops/topk.py: CAND_BUCKET, CAND_ROUNDS)
CAND_BUCKET = 1024
CAND_ROUNDS = 2


def bound_s(bytes_moved: float, ops: float, kind: str) -> float:
    """The least time the card could take, in seconds."""
    return max(bytes_moved / HBM_BYTES_S, ops / PEAK_FLOPS[kind])


def attn_half(t: int, d: int, s: int) -> tuple:
    """``(bytes, operations)`` of B5 over ``t`` tokens in items of ``s``:
    x read and out written (bf16), the half's weights and biases (bf16)
    and LN rows (f32) read once; the QKV and out-proj GEMMs plus ``QK^T``
    and ``PV`` over each item's ``s`` keys."""
    return (2 * 2 * t * d + 2 * (4 * d * d + 4 * d) + 4 * 4 * d,
            8 * t * d * d + 4 * t * s * d)


def mlp_half(t: int, d: int, f: int) -> tuple:
    """``(bytes, operations)`` of B6 over ``t`` tokens: x read, out
    written, fc1 and fc2 with their biases and the LN rows read once."""
    return (2 * 2 * t * d + 2 * (2 * d * f + f + d) + 4 * 4 * d,
            4 * t * f * d)


def block_flops(s: int, d: int, f: int) -> float:
    """Forward operations of one pre-LN encoder block over ``s``
    positions (causal attention counted as full, as the kernels do)."""
    return 8 * s * d * d + 4 * s * s * d + 4 * s * d * f


def vision_flops(cfg: dict) -> float:
    """Forward operations of the vision tower for one frame: the patch
    projection, the blocks and the visual projection."""
    v = cfg["vision_config"]
    d, p = v["hidden_size"], v["patch_size"]
    patches = (v["image_size"] // p) ** 2
    s = patches + 1
    return (2 * patches * p * p * 3 * d
            + v["num_hidden_layers"] * block_flops(s, d,
                                                    v["intermediate_size"])
            + 2 * d * cfg["projection_dim"])


def text_flops(cfg: dict, tokens: int) -> float:
    """Forward operations of the text tower for one query of ``tokens``
    tokens (SOT and EOT included): the blocks and the text projection."""
    t = cfg["text_config"]
    d = t["hidden_size"]
    return (t["num_hidden_layers"] * block_flops(tokens, d,
                                                 t["intermediate_size"])
            + 2 * d * cfg["projection_dim"])


def text_weight_bytes(cfg: dict, elem: int = 2) -> float:
    """Bytes of the text blocks' matrices and the projection, read once
    a pass."""
    t = cfg["text_config"]
    d, f = t["hidden_size"], t["intermediate_size"]
    return elem * (t["num_hidden_layers"] * (4 * d * d + 2 * d * f)
                   + d * cfg["projection_dim"])


def text_pass(cfg: dict, token_counts: Iterable[int]) -> tuple:
    """``(bytes, operations)`` of one text-tower pass over queries of
    these token counts: the weights read once, each query's activations
    read and written once a block (bf16), its operations at its own
    length."""
    t = cfg["text_config"]
    d = t["hidden_size"]
    counts = list(token_counts)
    act = sum(2 * 2 * n * d * t["num_hidden_layers"] for n in counts)
    return (text_weight_bytes(cfg) + act,
            sum(text_flops(cfg, n) for n in counts))


def scan_pass(n_rows: int, dim: int, b: int, elem: int = 2) -> tuple:
    """``(bytes, operations)`` of the candidate scan (B1) of ``b``
    queries over ``n_rows`` rows: the mirror and the queries read once,
    each bucket's winners written once; ``2 dim`` operations per row and
    query."""
    winners = CAND_ROUNDS * (-(-n_rows // CAND_BUCKET))
    return (n_rows * dim * elem + b * dim * 4 + winners * b * 8,
            2 * n_rows * dim * b)


def rerank_pass(b: int, fetch: int, dim: int) -> tuple:
    """``(bytes, operations)`` of the exact f32 re-rank: each query's
    fetched f32 rows read once, its scores written once."""
    return (b * fetch * dim * 4 + b * fetch * 8, 2 * b * fetch * dim)


def train_flops(cfg: dict, text_tokens: int) -> float:
    """Operations of one training pair: three times the forward of both
    towers (forward, and a backward of twice its cost)."""
    return 3 * (vision_flops(cfg) + text_flops(cfg, text_tokens))
