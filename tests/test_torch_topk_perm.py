"""The perm-layout candidate stages (kernels B10, B11), the exact int8
scan (B9), the exact scan over bf16 rows (B8) and the candidate dispatch
under ``VQT_CANDIDATE_TOPK`` (video_quierer_tpu_torch/ops/topk.py) vs the
JAX package's, its Pallas kernels in interpret mode, ``CAND_BUCKET`` set
to 128 in both modules.

Tolerance: none. The float inputs are chosen so that every f32 dot
product is exact in any summation order (rows multiples of 1/64 below
1/8; queries multiples of 1/4096 below 1/4, which the bf16 contracts round
to 8 significant bits, so the rounding is exercised; D = 128), and the
int8 scans multiply integer sums by the scales in the reference's order:
the winners and merged lists are bit-identical, ties (duplicated rows) at
the merge cut included. Where a fetch takes every winner the (value, host
row) pairs are compared as sets (the JAX top-k over the whole list orders
equal values in no fixed way).
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
VALID = 2 * 4096 + 1500          # the GLOBAL live count of a shard's perm


@pytest.fixture
def bucket128(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_topk, "CAND_BUCKET", 128)
    monkeypatch.setattr(torch_topk, "CAND_BUCKET", 128)


def _rows(seed, shape):
    """Multiples of 1/64 in [-1/8, 1/8] (exact in bf16), rows 3000-3199
    repeating rows 100-299 (equal scores)."""
    rng = np.random.default_rng(seed)
    rows = (rng.integers(-8, 9, shape) / 64).astype(np.float32)
    if shape[0] > 3200:
        rows[3000:3200] = rows[100:300]
    return rows


def _queries(seed, b, d=D):
    """Multiples of 1/4096 in [-1/4, 1/4]: not all exact in bf16."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-1024, 1025, (b, d)) / 4096).astype(np.float32)


def _shard_perm(seed, n=N_PAD):
    """A shard's perm column: distinct host rows from [0, 2n), so rows at
    or past VALID sit in every bucket."""
    return np.random.default_rng(seed).permutation(2 * n)[:n].astype(
        np.int32)


def _int8_mirror(seed, n=N_PAD, d=D):
    rows = unit_rows(np.random.default_rng(seed), n, d)
    rows[3000:3200] = rows[100:300]
    rows[9000:9010] = 0
    codes, scales = jax_q.quantize_rows(jnp.asarray(rows))
    return np.array(codes), np.array(scales)


def _same(tv, ti, jv, ji, fetch, winners):
    tv, ti, jv, ji = (np.asarray(a) for a in (tv, ti, jv, ji))
    assert tv.shape == ti.shape == jv.shape
    if fetch >= winners:
        for r in range(tv.shape[0]):
            assert sorted(zip(tv[r].tolist(), ti[r].tolist())) == \
                sorted(zip(jv[r].tolist(), ji[r].tolist()))
    else:
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)


WINNERS = 2 * N_PAD // 128


@pytest.mark.parametrize("b,fetch", [(1, 256), (5, 128), (3, 40)])
def test_cand_scan_perm_matches_jax(bucket128, b, fetch):
    """B10's plain version through ``candidate_stage(prefix=False)`` vs
    ``_pallas_cand_scan``: the row-orient merge, perm liveness against the
    global valid, host rows out."""
    emb = _rows(b, (N_PAD, D))
    perm = _shard_perm(b)
    q = _queries(10 + b, b)
    jv, ji = jax_topk._pallas_cand_scan(
        jnp.asarray(emb, jnp.bfloat16), jnp.asarray(perm), jnp.asarray(q),
        jnp.int32(VALID), fetch=fetch, rounds=2, bucket=128,
        select="packb", interpret=True)
    tv, ti = torch_topk.candidate_stage(
        torch.from_numpy(emb).bfloat16(), torch.from_numpy(q), VALID,
        k=fetch, perm=torch.from_numpy(perm), prefix=False)
    _same(tv, ti, jv, ji, fetch, WINNERS)
    live = np.isfinite(tv.numpy())
    assert (ti.numpy()[live] < VALID).all()


def _exact_int8_case(seed, b, n=N_PAD, d=D):
    """Codes with power-of-two row scales, and queries ``c / 1024`` (``c``
    integers, ``max |c| = 127``), whose int8 codes are ``c`` and scale
    ``2^-10``: every score ``raw * row_scale * qscale`` is exact. (XLA's
    CPU backend contracts the interpreted B11's ``score * qscale + 2.0``
    key bias into one fused multiply-add, which on inexact scores can
    floor a packed key one step below the kernel's two roundings; exact
    scores make both agree.)"""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    codes[3000:3200] = codes[100:300]        # equal scores
    scales = (2.0 ** -rng.integers(7, 9, (n, 1))).astype(np.float32)
    scales[9000:9010] = 0
    c = rng.integers(-126, 127, (b, d))
    c[:, 0] = 127
    return codes, scales, (c / 1024).astype(np.float32)


@pytest.mark.parametrize("b,fetch", [(1, 256), (6, 128)])
def test_cand_scan_int8_perm_matches_jax(bucket128, b, fetch):
    """B11's plain version vs ``_pallas_cand_scan_int8`` (native int8
    queries)."""
    codes, scales, q = _exact_int8_case(b, b)
    perm = _shard_perm(20 + b)
    assert np.array_equal(
        torch_topk.quantize_rows(torch.from_numpy(q))[0].numpy(),
        (q * 1024).astype(np.int8))
    jv, ji = jax_topk._pallas_cand_scan_int8(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(perm),
        jnp.asarray(q), jnp.int32(VALID), fetch=fetch, rounds=2,
        bucket=128, native=True, select="packb", interpret=True)
    tv, ti = torch_topk.candidate_stage_int8(
        torch.from_numpy(codes), torch.from_numpy(scales),
        torch.from_numpy(q), VALID, k=fetch, perm=torch.from_numpy(perm),
        prefix=False)
    _same(tv, ti, jv, ji, fetch, WINNERS)


def test_perm_shard_without_live_rows(bucket128):
    """A shard whose perm holds no live row: every candidate scores -inf
    in both packages, its host row past the valid count (the re-rank drops
    it)."""
    emb = _rows(3, (N_PAD, D))
    perm = (VALID + np.arange(N_PAD)).astype(np.int32)
    q = _queries(4, 2)
    jv, ji = jax_topk._pallas_cand_scan(
        jnp.asarray(emb, jnp.bfloat16), jnp.asarray(perm), jnp.asarray(q),
        jnp.int32(VALID), fetch=64, rounds=2, bucket=128, select="packb",
        interpret=True)
    tv, ti = torch_topk.candidate_stage(
        torch.from_numpy(emb).bfloat16(), torch.from_numpy(q), VALID, k=64,
        perm=torch.from_numpy(perm), prefix=False)
    assert np.isneginf(np.asarray(jv)).all() and torch.isneginf(tv).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti >= VALID).all()


@pytest.mark.parametrize("n", [8192, 8192 + 512])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("k", [1, 10, 40])
def test_cosine_topk_int8_matches_jax(monkeypatch, b, k, n):
    """B9's plain version vs ``_pallas_block_scan_int8`` (n a multiple of
    the 1,024-row block: B = 1 the f32-query contract, B > 1 the
    bf16-query one) and vs ``_xla_scan_int8`` (other n: bf16 queries at
    every B)."""
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    codes, scales = _int8_mirror(k, n=n)
    q = _queries(30 + k, b)
    valid = n - 700
    jv, ji = jax_topk.cosine_topk_int8(jnp.asarray(codes),
                                       jnp.asarray(scales), jnp.asarray(q),
                                       valid, k=k)
    tv, ti = torch_topk.cosine_topk_int8(torch.from_numpy(codes),
                                         torch.from_numpy(scales),
                                         torch.from_numpy(q), valid, k=k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_int8_scan_query_contract():
    """The contract the plain version takes: f32 queries for one query
    over whole 1,024-row tiles, bf16-rounded otherwise."""
    q = torch.from_numpy(_queries(5, 2))
    assert torch.equal(torch_topk._int8_scan_queries(q[:1], 8192), q[:1])
    rounded = q.bfloat16().float()
    assert not torch.equal(rounded, q)
    assert torch.equal(torch_topk._int8_scan_queries(q[:1], 8200),
                       rounded[:1])
    assert torch.equal(torch_topk._int8_scan_queries(q, 8192), rounded)


@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("k", [10, 40])
def test_cosine_topk_bf16_matches_jax(monkeypatch, b, k):
    """B8 over bf16 rows (the hatch's scan of the bf16 mirror) vs
    ``_pallas_block_scan`` over the same rows, queries rounded to bf16 in
    both."""
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    n, valid = 9 * 1024, 8 * 1024 + 500
    emb = _rows(k, (n, D))
    emb[8600:8700] = emb[20:120]             # past valid
    q = _queries(40 + k, b)
    jv, ji = jax_topk.cosine_topk(jnp.asarray(emb, jnp.bfloat16),
                                  jnp.asarray(q), valid, k=k)
    tv, ti = torch_topk.cosine_topk(torch.from_numpy(emb).bfloat16(),
                                    torch.from_numpy(q), valid, k=k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_hatch_candidate_topk_matches_jax(bucket128, monkeypatch):
    """``VQT_CANDIDATE_TOPK=pallas``: an identity-layout mirror (no perm)
    takes the exact scans with ``min(k, MAX_K)`` in both packages (bf16:
    B8 on bf16 rows; int8: B9); int4 keeps its fused prefix scan (B7), as
    the reference's code does."""
    monkeypatch.setenv("VQT_CANDIDATE_TOPK", "pallas")
    emb = _rows(7, (N_PAD, D))
    q = _queries(8, 3)
    jv, ji = jax_topk.candidate_topk(jnp.asarray(emb, jnp.bfloat16),
                                     jnp.asarray(q), VALID, k=40)
    tv, ti = torch_topk.candidate_topk(torch.from_numpy(emb).bfloat16(),
                                       torch.from_numpy(q), VALID, k=40)
    assert tv.shape == (3, 40)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    codes, scales = _int8_mirror(9)
    jv, ji = jax_topk.candidate_topk_int8(jnp.asarray(codes),
                                          jnp.asarray(scales),
                                          jnp.asarray(q), VALID, k=128)
    before = torch_topk.cand_scan_int8_prefix.launches
    tv, ti = torch_topk.candidate_topk_int8(torch.from_numpy(codes),
                                            torch.from_numpy(scales),
                                            torch.from_numpy(q), VALID,
                                            k=128)
    assert tv.shape == (3, torch_topk.MAX_K)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert torch_topk.cand_scan_int8_prefix.launches == before
    rows = unit_rows(np.random.default_rng(10), N_PAD, D)
    packed, scales4 = (np.array(a) for a in
                       jax_q.quantize_rows_int4(jnp.asarray(rows)))
    perm = np.random.default_rng(11).permutation(N_PAD).astype(np.int32)
    qr = reciprocal_case_queries(3, D, seed=12)
    jv, ji = jax_topk.candidate_topk_int4(
        jnp.asarray(packed), jnp.asarray(scales4), jnp.asarray(qr), VALID,
        k=40, perm=jnp.asarray(perm), prefix=True, live=VALID)
    tv, ti = torch_topk.candidate_topk_int4(
        torch.from_numpy(packed), torch.from_numpy(scales4),
        torch.from_numpy(qr), VALID, k=40, perm=torch.from_numpy(perm),
        prefix=True, live=VALID)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("prefix", [True, False])
def test_approx_mode_matches_jax(bucket128, monkeypatch, prefix):
    """``VQT_CANDIDATE_TOPK=approx``: every candidate stage takes its
    exact small-corpus scan, in both layouts (the reference's ApproxTopK is
    exact on the CPU)."""
    monkeypatch.setenv("VQT_CANDIDATE_TOPK", "approx")
    emb = _rows(13, (N_PAD, D))
    perm = np.random.default_rng(14).permutation(N_PAD).astype(np.int32)
    q = _queries(15, 4)
    kw = dict(k=128, prefix=prefix, live=VALID)
    jv, ji = jax_topk.candidate_topk(jnp.asarray(emb, jnp.bfloat16),
                                     jnp.asarray(q), VALID,
                                     perm=jnp.asarray(perm), **kw)
    before = torch_topk.cand_scan.launches, torch_topk.cand_scan_prefix.launches
    tv, ti = torch_topk.candidate_topk(torch.from_numpy(emb).bfloat16(),
                                       torch.from_numpy(q), VALID,
                                       perm=torch.from_numpy(perm), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    codes, scales = _int8_mirror(16)
    qr = reciprocal_case_queries(4, D, seed=17)
    jv, ji = jax_topk.candidate_topk_int8(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(qr), VALID,
        perm=jnp.asarray(perm), **kw)
    tv, ti = torch_topk.candidate_topk_int8(
        torch.from_numpy(codes), torch.from_numpy(scales),
        torch.from_numpy(qr), VALID, perm=torch.from_numpy(perm), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the stage routed around the fused scans (CPU tensors count no
    # launches either way; the route is what _fused_route decides)
    assert not torch_topk._fused_route(N_PAD, 128, 4, VALID, prefix=prefix)
    assert (torch_topk.cand_scan.launches,
            torch_topk.cand_scan_prefix.launches) == before
