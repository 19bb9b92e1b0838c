"""The hatch's exact scans list their top-k per span of 8,192 rows (the
reference's macro block, ``SCAN_SPAN_ROWS``): the merged top-k does not
depend on the lists' span.

``cosine_topk`` over bf16 rows (kernel B8 on bf16 rows) and
``cosine_topk_int8`` (kernel B9) merge per-span lists; their plain versions
(the CPU route of the same wrappers) at 1,024-row and 8,192-row lists give
identical rows and scores, and equal the JAX package's functions (its
Pallas kernels in interpret mode, or its XLA path for a corpus that is not
a whole number of blocks), at k = 1, 10, 40 and 64. Cases: valid cuts the
last span; a span lies wholly past valid (and valid cuts the one before);
valid = 0 (scores alike; rows: the port's lowest rows first, the
reference's row 0 k times); a corpus shorter than k = 64.

Tolerance: none. Rows are multiples of 1/64 below 1/8 and queries
multiples of 1/4096 below 1/4 (rounded to bf16 by the B > 1 contracts),
so every f32 dot product is exact in any summation order; duplicated rows
tie exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu_torch.ops import topk

D = 128
B = 3
SPAN = topk.SCAN_SPAN_ROWS
CASES = {                    # (rows, valid)
    "valid cuts a span": (2 * SPAN + 1024, 2 * SPAN + 500),
    "a span wholly past valid": (2 * SPAN + 1024, SPAN + 3000),
    "valid 0": (SPAN + 1024, 0),
    "fewer rows than k": (48, 40),
}


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    rows = (rng.integers(-8, 9, (n, D)) / 64).astype(np.float32)
    if n > 3200:
        rows[3000:3200] = rows[100:300]      # equal scores
    return rows


def _queries(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1024, 1025, (B, D)) / 4096).astype(np.float32)


def _int8(seed, n):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (n, D)).astype(np.int8)
    if n > 3200:
        codes[3000:3200] = codes[100:300]
    scales = (rng.integers(1, 64, (n, 1)) / 8192).astype(np.float32)
    if n > 3200:
        scales[3000:3200] = scales[100:300]
    return codes, scales


@pytest.mark.parametrize("k", [1, 10, 40, 64])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("rows", ["bf16", "int8"])
def test_span_lists_merge_as_tile_lists_and_jax(monkeypatch, rows, case, k):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    n, valid = CASES[case]
    q = _queries(k)
    tq = torch.from_numpy(q)
    if rows == "bf16":
        emb = torch.from_numpy(_rows(k, n)).bfloat16()

        def scan(tile_rows):
            return lambda qq: topk.block_scan_bf16(emb, qq, valid, k=k,
                                                   tile_rows=tile_rows)

        jv, ji = jax_topk.cosine_topk(
            jnp.asarray(_rows(k, n), jnp.bfloat16), jnp.asarray(q), valid,
            k=k)
    else:
        codes, scales = _int8(k, n)
        tc, ts = torch.from_numpy(codes), torch.from_numpy(scales)

        def scan(tile_rows):
            return lambda qq: topk.block_scan_int8(tc, ts, qq, valid, k=k,
                                                   tile_rows=tile_rows)

        jv, ji = jax_topk.cosine_topk_int8(
            jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(q), valid,
            k=k)
    lists = scan(SPAN)(tq)
    assert lists[0].shape == (-(-n // SPAN), B, k)
    sv, si = topk._exact_topk(scan(SPAN), tq, k)
    tv, ti = topk._exact_topk(scan(topk.SCAN_TILE_ROWS), tq, k)
    assert torch.equal(sv, tv) and torch.equal(si, ti)
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jv))
    if valid == 0:
        # every row dead: the port lists the lowest rows first, as it does
        # for dead rows anywhere; the reference's selection, with nothing
        # above -inf to pick, returns row 0 k times
        first = torch.arange(k, dtype=torch.int32).expand(B, k)
        assert torch.equal(si, first)
        assert not np.asarray(ji).any()
    else:
        np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    # the hatch's entry points take the span lists
    if rows == "bf16":
        cv, ci = topk.cosine_topk(emb, tq, valid, k=k)
    else:
        cv, ci = topk.cosine_topk_int8(tc, ts, tq, valid, k=k)
    assert torch.equal(cv, sv) and torch.equal(ci, si)
