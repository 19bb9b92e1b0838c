"""Port candidate stage (video_quierer_tpu_torch/ops/topk.py) vs the JAX
package's ``_pallas_cand_scan_prefix`` with its Pallas kernel in
interpret mode, on a 4-block live-prefix mirror with ``CAND_BUCKET``
set to 128 in both modules.

The mirror and queries hold multiples of 1/256 below 1/4 in magnitude:
exact in bf16, and every dot product over D=128 is exact in f32 whatever
the summation order, so both packages see bit-identical scores and the
comparisons are exact (no tolerance): identical (value, host row) winners,
identical merged candidate sets. ``valid`` cuts mid-block; B in {1, 8}.
Kernel B1 is held against its plain version on the card by
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu_torch.ops import topk as torch_topk

N_PAD, D = 4 * 4096, 128
VALID = 2 * 4096 + 1500


@pytest.fixture
def bucket128(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_topk, "CAND_BUCKET", 128)
    monkeypatch.setattr(torch_topk, "CAND_BUCKET", 128)


def _data(seed, b, n=N_PAD, d=D):
    rng = np.random.default_rng(seed)
    emb = (rng.integers(-64, 65, (n, d)) / 256).astype(np.float32)
    q = (rng.integers(-64, 65, (b, d)) / 256).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    return emb, q, perm


def _pairs(vals, rows):
    m = np.isfinite(vals)
    return sorted(zip(vals[m].tolist(), rows[m].tolist()))


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dtype,fetch", [("float32", 256),
                                         ("bfloat16", 128)])
def test_candidate_stage_matches_jax(bucket128, b, dtype, fetch):
    emb, q, perm = _data(b, b)
    jv, ji = jax_topk._pallas_cand_scan_prefix(
        jnp.asarray(emb, getattr(jnp, dtype)), jnp.asarray(perm),
        jnp.asarray(q), jnp.int32(VALID), fetch=fetch, rounds=2,
        bucket=128, orient="col", select="packb", interpret=True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = torch_topk.candidate_stage(
        torch.from_numpy(emb).to(getattr(torch, dtype)),
        torch.from_numpy(q), VALID, k=fetch, perm=torch.from_numpy(perm))
    tv, ti = tv.numpy(), ti.numpy()
    assert tv.shape == ti.shape == (b, fetch)
    for r in range(b):
        if fetch == 2 * (N_PAD // 128):
            # every bucket winner: identical finite (value, row) pairs
            assert _pairs(tv[r], ti[r]) == _pairs(jv[r], ji[r])
        else:
            # merged top-fetch: same values, same rows above the cut
            np.testing.assert_array_equal(np.sort(tv[r]), np.sort(jv[r]))
            cut = tv[r].min()
            assert set(ti[r][tv[r] > cut]) == set(ji[r][jv[r] > cut])
        live = np.isfinite(tv[r])
        assert (ti[r][live] < N_PAD).all()
        assert np.isin(ti[r][live], perm[:VALID]).all()


def test_winner_layout_and_dead_buckets():
    emb, q, _ = _data(3, 2, n=8192, d=64)
    vals, idxs = torch_topk.cand_scan_prefix(
        torch.from_numpy(emb).bfloat16(), torch.from_numpy(q), 4100,
        bucket=1024, rounds=2, block_rows=4096)
    assert vals.shape == idxs.shape == (2, 8, 2)
    # block 1: bucket 0 holds rows 4096..4099 live, buckets 1-3 are dead
    assert torch.isfinite(vals[1, [0, 4]]).all()
    assert torch.isinf(vals[1, [1, 2, 3, 5, 6, 7]]).all()
    # dead winners still carry the lowest positions of their bucket
    assert idxs[1, 1].tolist() == [5120, 5120]
    assert idxs[1, 5].tolist() == [5121, 5121]
    # per-bucket winners are the two best live rows, best first
    sc = emb[4096:4100] @ q.T
    for c in range(2):
        best = np.argsort(-sc[:, c], kind="stable")[:2] + 4096
        assert idxs[1, [0, 4], c].tolist() == best.tolist()


@pytest.mark.parametrize("live", [100, 5000])
def test_candidate_topk_routing_matches_jax(live):
    """Small live counts take the exact scan (prefix_fused_ok), as in the
    reference; both packages return the same host rows."""
    emb, q, perm = _data(7, 3, n=8192, d=64)
    perm[:live] = np.random.default_rng(1).permutation(live)
    jv, ji = jax_topk.candidate_topk(
        jnp.asarray(emb, jnp.bfloat16), jnp.asarray(q), live, k=128,
        perm=jnp.asarray(perm), prefix=True, live=live)
    tv, ti = torch_topk.candidate_topk(
        torch.from_numpy(emb).bfloat16(), torch.from_numpy(q), live, k=128,
        perm=torch.from_numpy(perm), live=live)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_gates_match_jax():
    for live in (0, 1, 64, 100, 65536, 2_000_000):
        for fetch in (10, 128, 1024):
            assert torch_topk.prefix_fused_ok(live, fetch) == \
                jax_topk.prefix_fused_ok(live, fetch)
    for n_pad in (8192, 65536, 2_000_896, 2_007_040):
        for b in (1, 64, 256):
            assert torch_topk._fused_usable(n_pad, 128, b) == \
                jax_topk._fused_usable(n_pad, 128, b)
    for k in (1, 10, 50, 64):
        assert torch_topk._approx_fetch(k) == jax_topk._approx_fetch(k)
