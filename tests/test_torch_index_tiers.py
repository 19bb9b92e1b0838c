"""Port index in the float32, int8 and int4 tiers
(video_quierer_tpu_torch/index/device_index.py, CPU device) vs the JAX
package's ``DeviceVideoIndex`` of the same dtype, with its Pallas kernels
in interpret mode and ``CAND_BUCKET`` set to 128 in both packages (so a
20,000-row corpus takes the fused candidate scans):

- the mirrors: the live-prefix ``perm``, the int8 codes / packed int4
  codes and their scales (bit for bit), and the f32 identity mirror,
  identical after every append of a sequence that scatters incrementally,
  re-places and grows past 8192 rows;
- ``search_batch`` and ``search_batch_fused_async`` (device re-rank on
  and off): the same rows in the same order, scores within 1e-5 (the
  float32 tier returns the scan's own scores);
- the same ``_device_rerank_active`` and ``_rerank_fetch`` decisions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import unit_rows
from video_quierer_tpu.index.device_index import \
    DeviceVideoIndex as JaxIndex
from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.ops import topk as torch_topk

D = 64
TIERS = ["float32", "int8", "int4"]


@pytest.fixture
def bucket128(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_topk, "CAND_BUCKET", 128)
    monkeypatch.setattr(torch_topk, "CAND_BUCKET", 128)


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        key = [(r["video_name"], r["frame_id"], r["timestamp"]) for r in g]
        assert key == [(r["video_name"], r["frame_id"], r["timestamp"])
                       for r in w]
        np.testing.assert_allclose([r["score"] for r in g],
                                   [r["score"] for r in w], atol=1e-5)


def _jax_mirror(idx):
    """(rows or codes, scales, perm) of a JAX index's device mirror."""
    if idx._codes:
        idx._sync_device_int8()
        scales = np.asarray(idx._device_scales)
    else:
        idx._sync_device()
        scales = None
    perm = None if idx._perm_dev is None else np.asarray(idx._perm_dev)
    return np.asarray(idx._device_emb), scales, perm


@pytest.mark.parametrize("tier", TIERS)
def test_mirror_identical_across_appends(tier):
    corpus = unit_rows(np.random.default_rng(5), 12000, D)
    corpus[7000:7300] = corpus[:300]                 # duplicated frames
    jax_idx = JaxIndex(dim=D, device_dtype=tier)
    port = DeviceVideoIndex(dim=D, device_dtype=tier, device="cpu")
    lo = 0
    for size in (300, 7, 1000, 4096, 5000, 1597):    # grows past 8192
        for idx in (jax_idx, port):
            idx.add_batch(corpus[lo:lo + size], "v.mp4",
                          [float(t) for t in range(size)])
        lo += size
        want_emb, want_scales, want_perm = _jax_mirror(jax_idx)
        port._sync_device()
        np.testing.assert_array_equal(port._device_emb.numpy(), want_emb)
        if tier == "float32":
            assert port._perm_dev is None and want_perm is None
            assert port._device_scales is None
            continue
        np.testing.assert_array_equal(port._perm, jax_idx._perm)
        np.testing.assert_array_equal(port._perm_dev.numpy(), want_perm)
        np.testing.assert_array_equal(
            port._device_scales.numpy().view(np.int32),
            want_scales.view(np.int32))
        assert port._device_emb.dtype == torch.int8
        assert port._device_emb.shape[1] == (D // 2 if tier == "int4"
                                             else D)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(9)
    rows = unit_rows(rng, 20000, D)
    rows[15000:15100] = rows[50:150]                 # exact ties
    return rows


def _pair(tier, corpus, device_rerank="auto"):
    jax_idx = JaxIndex(dim=D, device_dtype=tier, device_rerank=device_rerank)
    port = DeviceVideoIndex(dim=D, device_dtype=tier, device="cpu",
                            device_rerank=device_rerank)
    for idx in (jax_idx, port):
        idx.add_batch(corpus[:12000], "a.mp4",
                      [0.5 * t for t in range(12000)])
        idx.add_batch(corpus[12000:], "b.mp4",
                      [0.5 * t for t in range(8000)])
    return jax_idx, port


@pytest.mark.parametrize("tier", TIERS)
def test_search_batch_matches_jax(bucket128, corpus, tier):
    jax_idx, port = _pair(tier, corpus)
    rng = np.random.default_rng(1)
    q = corpus[[3, 60, 11999, 15060]] + 0.05 * rng.standard_normal(
        (4, D)).astype(np.float32)
    got = port.search_batch(q, k=10)
    _same_rows(got, jax_idx.search_batch(q, k=10))
    assert all(len(rows) == 10 for rows in got)
    if tier != "float32":        # the fused scan served, not the exact one
        assert torch_topk._fused_route(
            port._device_emb.shape[0], port._rerank_fetch(10), 4,
            port.count, min_b=1 if tier == "int4" else None)


@pytest.mark.parametrize("device_rerank", ["auto", "off"])
@pytest.mark.parametrize("tier", TIERS)
def test_search_batch_fused_async_matches_jax(bucket128, corpus, tier,
                                              device_rerank):
    """The fused path with a toy encoder (mean of a fixed token table)
    written once per framework."""
    jax_idx, port = _pair(tier, corpus, device_rerank)
    rng = np.random.default_rng(2)
    table = unit_rows(rng, 50, D)
    ids = rng.integers(0, 50, size=(6, 3)).astype(np.int32)

    def jax_encode(params, ids_dev):
        return params[ids_dev].mean(axis=1)

    def torch_encode(params, ids_dev):
        return params[ids_dev].mean(dim=1)

    want = jax_idx.search_batch_fused_async(
        jax_encode, jnp.asarray(table), ids, k=10)()
    got = port.search_batch_fused_async(
        torch_encode, torch.from_numpy(table), ids, k=10)()
    _same_rows(got, want)
    assert port._device_rerank_active() == jax_idx._device_rerank_active()


@pytest.mark.parametrize("tier", ["bfloat16"] + TIERS)
def test_rerank_decisions_match_jax(monkeypatch, tier):
    for mode in ("auto", "on", "off"):
        jax_idx = JaxIndex(dim=D, device_dtype=tier, device_rerank=mode)
        port = DeviceVideoIndex(dim=D, device_dtype=tier, device="cpu",
                                device_rerank=mode)
        for n in (0, 300_000):
            for idx in (jax_idx, port):
                idx.reserve(n)
            for budget in ("12", "0.05"):     # 0.05 GB: 300k rows over
                monkeypatch.setenv("VQT_DEVICE_RERANK_BUDGET_GB", budget)
                assert port._device_rerank_active() == \
                    jax_idx._device_rerank_active(), (mode, n, budget)
            for k in (1, 10, 50, 64):
                assert port._rerank_fetch(k) == jax_idx._rerank_fetch(k)
    monkeypatch.setenv("VQT_RERANK_FETCH", "600")
    assert port._rerank_fetch(10) == jax_idx._rerank_fetch(10)
    # the environment overrides the argument; an unknown value means "auto"
    monkeypatch.setenv("VQT_DEVICE_RERANK_BUDGET_GB", "12")
    for env in ("on", "off", "sometimes"):
        monkeypatch.setenv("VQT_DEVICE_RERANK", env)
        assert port._device_rerank_active() == \
            jax_idx._device_rerank_active(), env
