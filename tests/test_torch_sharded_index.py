"""The port's ``DeviceVideoIndex(mesh=...)`` (eight shards on the CPU, its
plain versions) vs the JAX package's on its eight virtual CPU devices
(Pallas kernels in interpret mode), ``CAND_BUCKET`` 128 and
``VQT_RERANK_FETCH`` 40 in both (so each 4,096-row shard's 64 bucket
winners cover the fetch and the fused perm-layout scans B10/B11 serve):

- ``search_batch`` and ``search_batch_fused_async`` in bfloat16, int8 and
  float32: the same result rows in the same order, scores within rtol
  1e-5;
- the mirror: the fixed full-capacity ``perm`` (numpy seed ``0xC0FFEE +
  cap``) identical, the shards' rows / codes / scales identical to JAX's
  sharded arrays, through appends (capacity growth included) and a
  removal;
- capacity granularity (shards x the kernels' blocks), int4 refused;
- ``VQT_CANDIDATE_TOPK=pallas`` flipped after a build: the mirror moves to
  the identity layout (the exact scans B8 on bf16 rows, B9) and back.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import unit_rows
from video_quierer_tpu.index.device_index import \
    DeviceVideoIndex as JaxIndex
from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu.parallel import mesh as jax_mesh
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.ops import topk as torch_topk
from video_quierer_tpu_torch.parallel import mesh as port_mesh

D = 64
SHARDS = 8
TIERS = ["bfloat16", "int8", "float32"]


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VQT_RERANK_FETCH", "40")
    monkeypatch.delenv("VQT_CANDIDATE_TOPK", raising=False)
    monkeypatch.setattr(jax_topk, "CAND_BUCKET", 128)
    monkeypatch.setattr(torch_topk, "CAND_BUCKET", 128)
    return monkeypatch


def _pair(tier, shards=SHARDS):
    assert jax.device_count() >= shards
    jax_idx = JaxIndex(dim=D, device_dtype=tier,
                       mesh=jax_mesh.corpus_mesh(shards))
    port = DeviceVideoIndex(dim=D, device_dtype=tier,
                            mesh=port_mesh.corpus_mesh(
                                shards, devices=["cpu"] * shards))
    return jax_idx, port


def _add(pair, rows, name, lo=0):
    for idx in pair:
        idx.add_batch(rows, name, [0.5 * (lo + t) for t in range(len(rows))])


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(r["video_name"], r["frame_id"], r["timestamp"]) for r in g] \
            == [(r["video_name"], r["frame_id"], r["timestamp"]) for r in w]
        np.testing.assert_allclose([r["score"] for r in g],
                                   [r["score"] for r in w], rtol=1e-5,
                                   atol=0)


def _queries(corpus, picks, seed):
    rng = np.random.default_rng(seed)
    return corpus[picks] + 0.05 * rng.standard_normal(
        (len(picks), D)).astype(np.float32)


def _check_mirror(jax_idx, port):
    """The port's shards, concatenated, equal the JAX sharded mirror."""
    if port._codes:
        jax_idx._sync_device_int8()
    else:
        jax_idx._sync_device()
    port._sync_device()
    assert port._mirror_layout_cur == jax_idx._mirror_layout_cur
    assert len(port._device_emb) == SHARDS
    got = torch.cat(port._device_emb).float().numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_idx._device_emb).astype(np.float32))
    if port._codes:
        np.testing.assert_array_equal(
            torch.cat(port._device_scales).numpy().view(np.int32),
            np.asarray(jax_idx._device_scales).view(np.int32))
    if port._mirror_layout_cur == "perm":
        np.testing.assert_array_equal(port._perm, jax_idx._perm)
        np.testing.assert_array_equal(torch.cat(port._perm_dev).numpy(),
                                      np.asarray(jax_idx._perm_dev))


@pytest.fixture(scope="module")
def corpus():
    rows = unit_rows(np.random.default_rng(3), 20000, D)
    rows[15000:15100] = rows[50:150]                 # exact ties
    return rows


@pytest.mark.parametrize("tier", TIERS)
def test_search_matches_jax(env, corpus, tier):
    pair = _pair(tier)
    _add(pair, corpus[:12000], "a.mp4")
    _add(pair, corpus[12000:], "b.mp4")
    jax_idx, port = pair
    q = _queries(corpus, [3, 60, 11999, 15060], 1)
    got = port.search_batch(q, k=10)
    _same_rows(got, jax_idx.search_batch(q, k=10))
    assert all(len(r) == 10 for r in got)
    assert port._mirror_layout_cur == ("id" if tier == "float32"
                                       else "perm")
    _check_mirror(jax_idx, port)
    # the fused text-search path, with an embedding lookup as the encoder
    table = unit_rows(np.random.default_rng(4), 32, D)
    ids = np.array([[3], [17], [30]], np.int32)
    want = jax_idx.search_batch_fused_async(
        lambda p, i: p[i[:, 0]], jnp.asarray(table), ids, k=10)()
    got = port.search_batch_fused_async(
        lambda p, i: p[i[:, 0]], torch.from_numpy(table), ids, k=10)()
    _same_rows(got, want)


@pytest.mark.parametrize("tier", TIERS)
def test_appends_and_removal_match_jax(env, tier):
    """Appends re-place the sharded mirror (one growth past the
    32,768-row capacity), a removal compacts; after each the mirror, the
    perm and the results equal JAX's."""
    corpus = unit_rows(np.random.default_rng(5), 34000, D)
    corpus[20000:20200] = corpus[:200]
    pair = _pair(tier)
    jax_idx, port = pair
    lo = 0
    for size, name in ((300, "a.mp4"), (7, "b.mp4"), (16000, "c.mp4"),
                       (17693, "d.mp4")):
        _add(pair, corpus[lo:lo + size], name, lo)
        lo += size
        assert port._emb.shape[0] == jax_idx._emb.shape[0]
        q = _queries(corpus, [0, lo - 1], lo)
        _same_rows(port.search_batch(q, k=10), jax_idx.search_batch(q, k=10))
        _check_mirror(jax_idx, port)
    assert port._emb.shape[0] == 65536
    for idx in pair:
        assert idx.remove_video("c.mp4") == 16000
    q = _queries(corpus, [5, 16500, 33000], 7)
    _same_rows(port.search_batch(q, k=10), jax_idx.search_batch(q, k=10))
    _check_mirror(jax_idx, port)


@pytest.mark.parametrize("shards", [1, 4, 8])
def test_capacity_granularity_matches_jax(shards):
    for tier in ("bfloat16", "int8"):
        jax_idx, port = _pair(tier, shards)
        assert port._granularity == jax_idx._granularity \
            == max(8192, shards * 4096)
        rows = unit_rows(np.random.default_rng(shards), 100, D)
        payload = {"embeddings": list(rows), "metadata": [
            {"video_name": "v.mp4", "timestamp": float(i), "frame_id": i}
            for i in range(100)], "video_hashes": {}, "version": "1.0"}
        for idx in (jax_idx, port):
            idx.load_cache_dict(payload)
        assert port._emb.shape[0] == jax_idx._emb.shape[0] \
            == port._granularity


def test_int4_refuses_a_mesh():
    mesh = port_mesh.corpus_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="int4"):
        DeviceVideoIndex(dim=D, device_dtype="int4", mesh=mesh)


@pytest.mark.parametrize("tier", ["bfloat16", "int8"])
def test_hatch_flip_relays_the_mirror(env, corpus, tier):
    """The hatch flipped after a build: the next search re-places the
    shards in the identity layout (exact per-shard scans, the shallow
    fetch) and back; rows equal JAX's every time."""
    pair = _pair(tier)
    _add(pair, corpus[:12000], "a.mp4")
    jax_idx, port = pair
    q = _queries(corpus, [7, 8000, 11000], 2)
    before = {w: w.launches for w in (torch_topk.cand_scan,
                                      torch_topk.cand_scan_int8)}
    for mode, layout in ((None, "perm"), ("pallas", "id"), (None, "perm")):
        if mode is None:
            env.delenv("VQT_CANDIDATE_TOPK", raising=False)
        else:
            env.setenv("VQT_CANDIDATE_TOPK", mode)
        _same_rows(port.search_batch(q, k=10), jax_idx.search_batch(q, k=10))
        assert port._mirror_layout_cur == layout
        assert port._rerank_fetch(25) == jax_idx._rerank_fetch(25) \
            == (64 if mode else 40)
        _check_mirror(jax_idx, port)
        if layout == "id":
            assert port._perm_arg() is None
            if tier == "bfloat16":
                np.testing.assert_array_equal(
                    torch.cat(port._device_emb)[:len(port)].float().numpy(),
                    torch.from_numpy(corpus[:len(port)]).bfloat16().float()
                    .numpy())
    # CPU shards run the plain versions: no kernel launch is counted
    assert all(w.launches == n for w, n in before.items())
