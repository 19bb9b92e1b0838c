"""The numerical argument of the exact f32 scan's tensor-core tile
(kernel B8 on f32 rows at B > 8, ``csrc/block_scan.cu:scan_tf32_kernel``),
emulated in plain PyTorch on the CPU.

The kernel splits each operand into two TF32 parts, ``big = tf32(x)`` and
``small = tf32(x - big)`` (``cvt.rna``: round to nearest, ties away from
zero, on the bit pattern), and sums three products in f32: small.big,
big.small and big.big. Emulated here with the same rounding and f32
products (a product of two TF32 values is exact in f32):

- the scores stay within 1e-6 of f64, relative to ``|q| |e|`` (the
  scale of a dot product's rounding error);
- the per-1,024-row-tile top-k rows equal ``block_scan_ref``'s (the
  plain f32 version the kernel is held to) except where two scores tie
  within ``SCAN_RTOL``, and the merged top-k rows equal the JAX
  package's ``cosine_topk`` (the reference, exact f32) the same way;
- one TF32 product (``tf32(q) . tf32(e)``) fails both checks.

Inputs: seeded unit rows at D = 512, and rows of unnormalised
N(0, 1e3^2); every other row is its neighbour moved by 1e-4 of its norm,
so that many pairs tie to within ~1e-5 relative — apart by more than
``SCAN_RTOL`` but by less than one TF32 product's error.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu_torch.ops import topk

D = 512
N = 4 * 1024 + 300          # a short last tile
VALID = 3 * 1024 + 700      # valid cuts the fourth tile
B, K = 16, 10
TILE = 1024
SCAN_RTOL = 1e-5            # chip_smoke.py's tolerance for the scan kernels
SCORE_RTOL = 1e-6


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, rounding the 13
    dropped bits to nearest with ties away from zero (on the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    big = _tf32(x)
    return big, _tf32(x - big)


def _scores_3xtf32(emb: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    eb, es = _split(emb)
    qb, qs = _split(q)
    return qs @ eb.t() + qb @ es.t() + qb @ eb.t()


def _scores_1xtf32(emb: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return _tf32(q) @ _tf32(emb).t()


SCORES = {"3xtf32": _scores_3xtf32, "1xtf32": _scores_1xtf32}


def _inputs(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "unit":
        emb = rng.standard_normal((N, D))
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    else:
        emb = rng.normal(0.0, 1e3, (N, D))
    noise = rng.standard_normal((N // 2, D))
    noise /= np.linalg.norm(noise, axis=-1, keepdims=True)
    emb[1::2] = emb[0::2] + 1e-4 * np.linalg.norm(
        emb[0::2], axis=-1, keepdims=True) * noise
    q = rng.standard_normal((B, D))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return emb.astype(np.float32), q.astype(np.float32)


def _rows_agree(vals, rows, ref_vals, ref_rows) -> bool:
    """Rows identical except where two neighbouring reference scores tie
    within SCAN_RTOL (lists along the last axis)."""
    gap = torch.full_like(ref_vals, float("inf"))
    gap[..., 1:] = ref_vals[..., :-1] - ref_vals[..., 1:]
    gap[..., :-1] = torch.minimum(gap[..., :-1],
                                  ref_vals[..., :-1] - ref_vals[..., 1:])
    apart = gap > SCAN_RTOL * ref_vals.abs()
    return bool(torch.equal(rows[apart], ref_rows[apart]))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                   # the TF32 step above 1
    x = torch.tensor([1.0 + 2.0 ** -11,      # a tie: away from zero
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20,   # below the tie
                      one + 2.0 ** -12, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0, one, 3.0, 0.0])
    assert torch.equal(_tf32(x), want)
    big, small = _split(x)
    assert torch.equal(big + small, x)       # two parts hold these exactly


@pytest.mark.parametrize("kind", ["unit", "wide"])
@pytest.mark.parametrize("scheme", ["3xtf32", "1xtf32"])
def test_scores_against_f64(kind, scheme):
    emb, q = _inputs(kind)
    got = SCORES[scheme](torch.from_numpy(emb), torch.from_numpy(q))
    q64, emb64 = q.astype(np.float64), emb.astype(np.float64)
    scale = np.outer(np.linalg.norm(q64, axis=-1),
                     np.linalg.norm(emb64, axis=-1))
    err = (np.abs(got.double().numpy() - q64 @ emb64.T) / scale).max()
    assert (err <= SCORE_RTOL) == (scheme == "3xtf32"), err


@pytest.mark.parametrize("kind", ["unit", "wide"])
@pytest.mark.parametrize("scheme", ["3xtf32", "1xtf32"])
def test_tile_lists_against_block_scan_ref(kind, scheme):
    emb, q = (torch.from_numpy(a) for a in _inputs(kind))
    sc = SCORES[scheme](emb, q)
    vals, rows = topk._tile_topk(sc, VALID, k=K, tile_rows=TILE)
    ref_vals, ref_rows = topk.block_scan_ref(emb, q, VALID, k=K,
                                             tile_rows=TILE)
    assert vals.shape == ref_vals.shape == (-(-N // TILE), B, K)
    assert torch.equal(torch.isfinite(vals), torch.isfinite(ref_vals))
    assert _rows_agree(vals, rows, ref_vals, ref_rows) == \
        (scheme == "3xtf32")


@pytest.mark.parametrize("kind", ["unit", "wide"])
@pytest.mark.parametrize("scheme", ["3xtf32", "1xtf32"])
def test_merged_topk_against_jax(kind, scheme):
    emb, q = _inputs(kind)
    sc = SCORES[scheme](torch.from_numpy(emb), torch.from_numpy(q))
    lists = topk._tile_topk(sc, VALID, k=K, tile_rows=TILE)
    vals, rows = topk.merge_topk(
        *(t.transpose(0, 1).reshape(B, -1) for t in lists), k=K)
    jv, ji = jax_topk.cosine_topk(jnp.asarray(emb), jnp.asarray(q), VALID,
                                  k=K)
    ref_vals = torch.from_numpy(np.array(jv))
    ref_rows = torch.from_numpy(np.array(ji))
    assert _rows_agree(vals, rows, ref_vals, ref_rows) == \
        (scheme == "3xtf32")
