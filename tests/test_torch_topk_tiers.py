"""Port scans of the int8, int4 and float32 tiers
(video_quierer_tpu_torch/ops/topk.py) vs the JAX package's, with its
Pallas kernels in interpret mode and ``CAND_BUCKET`` set to 128 in both
modules.

- int8/int4 candidate stages vs ``_pallas_cand_scan_{int8,int4}_prefix``
  (native int8 queries, orient "row"), no tolerance: a merge cut below
  the winner count gives identical (value, host row) lists, ties at the
  cut included; a fetch of every winner gives the same (value, host row)
  pairs (the JAX top-k over the whole list orders equal values in no
  fixed way). Integer dot products are exact in both packages and the
  scales multiply in the same order, so every score is bit-identical; the
  mirror holds duplicated rows (equal keys), and half of the queries have
  a scale whose true divide differs from the reciprocal multiply.
- the tiny-corpus exact scans vs ``_approx_scan_{int8,int4}``: identical.
- ``cosine_topk`` vs the JAX ``cosine_topk`` (``_pallas_block_scan``):
  k in {1, 10, 64}, B in {1, 5}, ``valid`` cutting a block, duplicated
  rows. The inputs are multiples of 1/64 below 1/8, so every f32 dot
  product is exact whatever the summation order and the comparison is
  exact too (no tolerance): same scores, same rows, lowest row first on
  ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import reciprocal_case_queries, unit_rows
from video_quierer_tpu.ops import quantize as jax_q
from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu_torch.ops import topk as torch_topk

N_PAD, D = 4 * 4096, 128
VALID = 2 * 4096 + 1500


@pytest.fixture
def bucket128(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_topk, "CAND_BUCKET", 128)
    monkeypatch.setattr(torch_topk, "CAND_BUCKET", 128)


def _mirror(tier, seed, n=N_PAD, d=D):
    """Quantized mirror (JAX quantizer) with duplicated and zero rows."""
    rng = np.random.default_rng(seed)
    rows = unit_rows(rng, n, d)
    rows[3000:3200] = rows[100:300]
    rows[9000:9010] = 0
    quant = jax_q.quantize_rows if tier == "int8" else \
        jax_q.quantize_rows_int4
    codes, scales = (np.asarray(a) for a in quant(jnp.asarray(rows)))
    return (np.array(codes), np.array(scales),
            rng.permutation(n).astype(np.int32))


_JAX_FUSED = {"int8": jax_topk._pallas_cand_scan_int8_prefix,
              "int4": jax_topk._pallas_cand_scan_int4_prefix}
_PORT_STAGE = {"int8": torch_topk.candidate_stage_int8,
               "int4": torch_topk.candidate_stage_int4}


@pytest.mark.parametrize("tier", ["int8", "int4"])
@pytest.mark.parametrize("b,fetch", [(1, 256), (6, 128)])
def test_codes_stage_matches_jax(bucket128, tier, b, fetch):
    codes, scales, perm = _mirror(tier, b)
    q = reciprocal_case_queries(b, D, seed=b)
    jv, ji = _JAX_FUSED[tier](
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(perm),
        jnp.asarray(q), jnp.int32(VALID), fetch=fetch, rounds=2,
        bucket=128, native=True, orient="row", select="packb",
        interpret=True)
    tv, ti = _PORT_STAGE[tier](
        torch.from_numpy(codes), torch.from_numpy(scales),
        torch.from_numpy(q), VALID, k=fetch, perm=torch.from_numpy(perm))
    jv, ji, tv, ti = (np.asarray(a) for a in (jv, ji, tv, ti))
    assert tv.shape == ti.shape == (b, fetch)
    if fetch == 2 * (N_PAD // 128):
        for r in range(b):
            assert sorted(zip(tv[r].tolist(), ti[r].tolist())) == \
                sorted(zip(jv[r].tolist(), ji[r].tolist()))
    else:
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)
    live = np.isfinite(tv)
    assert np.isin(ti[live], perm[:VALID]).all()


@pytest.mark.parametrize("tier", ["int8", "int4"])
@pytest.mark.parametrize("live", [100, 5000])
def test_codes_small_corpus_matches_jax(tier, live):
    """Small live counts take the exact scan (prefix_fused_ok), as in the
    reference; both packages return the same scores and host rows."""
    codes, scales, perm = _mirror(tier, 7, n=8192, d=64)
    perm[:live] = np.random.default_rng(1).permutation(live)
    q = reciprocal_case_queries(4, 64, seed=3)
    jax_fn = {"int8": jax_topk.candidate_topk_int8,
              "int4": jax_topk.candidate_topk_int4}[tier]
    port_fn = {"int8": torch_topk.candidate_topk_int8,
               "int4": torch_topk.candidate_topk_int4}[tier]
    jv, ji = jax_fn(jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(q),
                    live, k=128, perm=jnp.asarray(perm), prefix=True,
                    live=live)
    tv, ti = port_fn(torch.from_numpy(codes), torch.from_numpy(scales),
                     torch.from_numpy(q), live, k=128,
                     perm=torch.from_numpy(perm), live=live)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_int4_takes_the_fused_scan_from_one_query(monkeypatch):
    """``VQT_FUSED_MIN_B`` raised: int4 still routes B=1 to the fused
    scan (``min_b=1``), int8 and bf16 do not — in both packages."""
    for mod in (jax_topk, torch_topk):
        monkeypatch.setattr(mod, "FUSED_MIN_B", 8)
    for n_pad in (8192, 65536):
        for b in (1, 7, 8):
            for min_b in (None, 1):
                assert torch_topk._fused_usable(n_pad, 128, b, min_b) == \
                    jax_topk._fused_usable(n_pad, 128, b, min_b)
    assert torch_topk._fused_usable(65536, 128, 1, min_b=1)
    assert not torch_topk._fused_usable(65536, 128, 1)


def _exact_rows(seed, shape):
    """Multiples of 1/64 in [-1/8, 1/8]: exact dot products, many ties."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, shape) / 64).astype(np.float32)


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("b", [1, 5])
def test_cosine_topk_matches_jax(monkeypatch, k, b):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    n, valid = 9 * 1024, 8 * 1024 + 500      # two macro-blocks of the scan
    emb = _exact_rows(k, (n, 64))
    emb[8000:8100] = emb[10:110]             # ties across tiles and macros
    emb[8300:8310] = emb[8200:8210]
    emb[8600:8700] = emb[20:120]             # past valid
    q = _exact_rows(100 + k, (b, 64))
    jv, ji = jax_topk.cosine_topk(jnp.asarray(emb), jnp.asarray(q), valid,
                                  k=k)
    tv, ti = torch_topk.cosine_topk(torch.from_numpy(emb),
                                    torch.from_numpy(q), valid, k=k)
    assert tv.shape == ti.shape == (b, k) and ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the 1-D form squeezes, as in the reference
    v1, i1 = torch_topk.cosine_topk(torch.from_numpy(emb),
                                    torch.from_numpy(q[0]), valid, k=k)
    assert v1.shape == (k,) and torch.equal(i1, ti[0])


def test_cosine_topk_short_corpus_pads_like_jax():
    """Fewer valid rows than k: dead rows follow at -inf, lowest first,
    then pads; k above MAX_K raises."""
    emb = _exact_rows(3, (3000, 64))
    q = _exact_rows(4, (2, 64))
    jv, ji = jax_topk.cosine_topk(jnp.asarray(emb), jnp.asarray(q), 7, k=12)
    tv, ti = torch_topk.cosine_topk(torch.from_numpy(emb),
                                    torch.from_numpy(q), 7, k=12)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.isinf(tv.numpy()[:, 7:]).all()
    with pytest.raises(ValueError):
        torch_topk.cosine_topk(torch.from_numpy(emb), torch.from_numpy(q),
                               7, k=torch_topk.MAX_K + 1)
