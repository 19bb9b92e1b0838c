"""The numerical argument of the exact int8 scan's single-query contract on
the tensor cores (kernel B9 at B = 1 over whole 1,024-row blocks,
``csrc/block_scan.cu:span_kernel``), emulated in plain PyTorch on the CPU.

The reference multiplies the int8 codes by the f32 query (its flat B = 1
layout). A bf16 tensor-core product takes bf16 operands, so the kernel
splits the query into three bf16 parts: ``hi = bf16(q)``, ``mid = bf16(q -
hi)``, ``lo = bf16(q - hi - mid)`` (each difference exact in f32, and
``|q - hi - mid - lo| <= 2^-27 |q|``). A code times a bf16 part is exact in
f32. Each 128-column ring stage sums each part's products into a fresh f32
partial (emulated as the exact sum rounded to f32: the tensor core sums in
its own order), the partials add in stage order in f32, and the score is
``(s_hi + s_mid) + s_lo``, then times the row's scale. Here:

- the scores stay within 1e-6 of f64, relative to ``|q| |e|`` (the scale of
  a dot product's rounding error), and one bf16 part (``hi`` alone) does
  not;
- the per-span top-k lists equal ``block_scan_int8_ref``'s (the plain f32
  version the kernel is held to) except where two scores tie within
  ``SCAN_RTOL``;
- the merged top-k equals the JAX package's ``cosine_topk_int8`` (B = 1,
  its Pallas kernel in interpret mode) the same way.

Inputs: seeded int8 codes of unit rows at D = 512 over two 8,192-row spans;
every other row is its neighbour with one code moved by one, so that many
pairs score within ~1e-4 of each other.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu_torch.ops import topk
from video_quierer_tpu_torch.ops.quantize import quantize_rows

D = 512
N = 2 * topk.SCAN_SPAN_ROWS
VALID = N - 700              # valid cuts the second span
K = 40                       # the hatch's fetch at k = 10
STAGE = 128                  # columns of one int8 ring stage
SCAN_RTOL = 1e-5             # chip_smoke.py's tolerance for the scan kernels
SCORE_RTOL = 1e-6


def _split3(q: torch.Tensor):
    hi = q.bfloat16().float()
    r1 = q - hi
    mid = r1.bfloat16().float()
    return hi, mid, (r1 - mid).bfloat16().float()


def _scores(codes: torch.Tensor, scales: torch.Tensor, q: torch.Tensor,
            parts: int) -> torch.Tensor:
    """Row scores of one query ``q [D]`` as the span tile forms them from the
    first ``parts`` bf16 parts of the query."""
    sums = []
    for part in _split3(q)[:parts]:
        acc = torch.zeros(codes.shape[0])
        for s in range(0, D, STAGE):
            acc = acc + (codes[:, s:s + STAGE].double()
                         @ part[s:s + STAGE].double()).float()
        sums.append(acc)
    score = sums[0]
    for more in sums[1:]:
        score = score + more
    return score * scales[:, 0]


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((N, D))
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    codes, scales = quantize_rows(torch.from_numpy(rows.astype(np.float32)))
    codes = codes.numpy().copy()
    scales = scales.numpy().copy()
    # every odd row: its neighbour with one code moved by one
    codes[1::2] = codes[0::2]
    scales[1::2] = scales[0::2]
    col = rng.integers(0, D, N // 2)
    step = np.where(codes[1::2][np.arange(N // 2), col] < 0, 1, -1)
    codes[1::2][np.arange(N // 2), col] += step.astype(np.int8)
    q = rng.standard_normal(D)
    q /= np.linalg.norm(q)
    return codes, scales, q.astype(np.float32)


def _rows_agree(vals, rows, ref_vals, ref_rows) -> bool:
    """Rows identical except where two neighbouring reference scores tie
    within SCAN_RTOL; ``ref_*`` may hold one entry more than ``vals``, the
    neighbour of the last one (lists along the last axis)."""
    k = vals.shape[-1]
    below = ref_vals[..., k:k + 1]
    ref_vals, ref_rows = ref_vals[..., :k], ref_rows[..., :k]
    gap = torch.full_like(ref_vals, float("inf"))
    gap[..., 1:] = ref_vals[..., :-1] - ref_vals[..., 1:]
    gap[..., :-1] = torch.minimum(gap[..., :-1],
                                  ref_vals[..., :-1] - ref_vals[..., 1:])
    if below.shape[-1]:
        gap[..., -1:] = torch.minimum(gap[..., -1:],
                                      ref_vals[..., -1:] - below)
    apart = gap > SCAN_RTOL * ref_vals.abs()
    return bool(torch.equal(rows[apart], ref_rows[apart]))


def test_three_parts_hold_the_query():
    q = torch.from_numpy(_inputs()[2])
    hi, mid, lo = _split3(q)
    for part in (hi, mid, lo):
        assert torch.equal(part, part.bfloat16().float())
    assert torch.equal(q - hi, (q.double() - hi.double()).float())
    rest = q.double() - hi.double() - mid.double() - lo.double()
    assert (rest.abs() <= 2.0 ** -27 * q.double().abs()).all()


@pytest.mark.parametrize("parts", [3, 1])
def test_scores_against_f64(parts):
    codes, scales, q = _inputs()
    got = _scores(torch.from_numpy(codes), torch.from_numpy(scales),
                  torch.from_numpy(q), parts)
    e64 = codes.astype(np.float64) * scales.astype(np.float64)
    want = e64 @ q.astype(np.float64)
    scale = np.linalg.norm(e64, axis=-1) * np.linalg.norm(q)
    err = (np.abs(got.double().numpy() - want) / scale).max()
    assert (err <= SCORE_RTOL) == (parts == 3), err


def test_span_lists_against_block_scan_int8_ref():
    codes, scales, q = (torch.from_numpy(a) for a in _inputs())
    sc = _scores(codes, scales, q, 3)
    vals, rows = topk._tile_topk(sc[None, :], VALID, k=K,
                                 tile_rows=topk.SCAN_SPAN_ROWS)
    ref_vals, ref_rows = topk.block_scan_int8_ref(
        codes, scales, q[None, :], VALID, k=K + 1,
        tile_rows=topk.SCAN_SPAN_ROWS)
    assert vals.shape == (2, 1, K)
    assert torch.equal(torch.isfinite(vals), torch.isfinite(ref_vals[..., :K]))
    assert _rows_agree(vals, rows, ref_vals, ref_rows)
    live = torch.isfinite(vals)
    torch.testing.assert_close(vals[live], ref_vals[..., :K][live],
                               rtol=SCAN_RTOL, atol=0)


def test_merged_topk_against_jax(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    codes, scales, q = _inputs()
    sc = _scores(torch.from_numpy(codes), torch.from_numpy(scales),
                 torch.from_numpy(q), 3)
    lists = topk._tile_topk(sc[None, :], VALID, k=K,
                            tile_rows=topk.SCAN_SPAN_ROWS)
    vals, rows = topk.merge_topk(
        *(t.transpose(0, 1).reshape(1, -1) for t in lists), k=K)
    jv, ji = jax_topk.cosine_topk_int8(jnp.asarray(codes),
                                       jnp.asarray(scales),
                                       jnp.asarray(q[None, :]), VALID, k=K)
    ref_vals = torch.from_numpy(np.array(jv))
    ref_rows = torch.from_numpy(np.array(ji))
    assert _rows_agree(vals, rows, ref_vals, ref_rows)
    torch.testing.assert_close(vals, ref_vals, rtol=SCAN_RTOL, atol=0)
