"""The port's engine on a corpus mesh vs the JAX engine on its eight
virtual CPU devices, through the same tiny f32 CLIP towers (weights moved
with ``params_from_jax``): ``index.corpus_shards = 8`` (the port's mesh
given as ``corpus_mesh=``, eight shards on the CPU), ``CAND_BUCKET`` 128
and ``VQT_RERANK_FETCH`` 40 in both packages so the perm-layout candidate
scans serve, the JAX Pallas kernels in interpret mode.

- bfloat16, int8 and float32 mirrors: text search (module and fused
  towers), batch, coalesced and vector searches return the JAX engine's
  rows (same frames in the same order, scores within 1e-5);
- ``index.corpus_slices = 2``: the hierarchical merge, the same rows;
- ``index.kind = "ivf"`` on the mesh: the tier's clusters spread over the
  eight devices exactly as JAX spreads them (``ann_stats`` with
  ``devices`` and ``tiles_per_device`` equal), the same rows; on two
  slices it keeps one replica; ``IVFIndex.load_built`` of a JAX mesh
  tier's state searches like it.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (
    TINY_FULL_VOCAB,
    ivf_state,
    jax_kmeans_init,
    port_state_dict,
    unit_rows,
)
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.index import ivf as jax_ivf
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxEmbedder
from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu.parallel import mesh as jax_mesh
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index import ivf as port_ivf
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
from video_quierer_tpu_torch.ops import topk as torch_topk
from video_quierer_tpu_torch.parallel import mesh as port_mesh

D = 64
SHARDS = 8
QUERIES = ["a dog in the park", "the same deterministic query",
           "night city " * 30]          # the last takes the 77 bucket


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VQT_RERANK_FETCH", "40")
    monkeypatch.delenv("VQT_CANDIDATE_TOPK", raising=False)
    monkeypatch.setattr(jax_topk, "CAND_BUCKET", 128)
    monkeypatch.setattr(torch_topk, "CAND_BUCKET", 128)
    monkeypatch.setattr(port_ivf, "init_indices", jax_kmeans_init)


@pytest.fixture(scope="module")
def towers():
    jax_emb = JaxEmbedder(TINY_FULL_VOCAB, dtype=jnp.float32)
    port_emb = CLIPEmbedder(TINY_FULL_VOCAB, dtype=torch.float32,
                            device="cpu",
                            state_dict=port_state_dict(jax_emb.params,
                                                       TINY_FULL_VOCAB))
    return jax_emb, port_emb


def _config(mod, videos, dtype, slices, kind):
    cfg = mod.EngineConfig(videos_dir=str(videos),
                           api=mod.ApiConfig(max_frames=10))
    cfg.index.embed_dim = D
    cfg.model.dtype = "float32"
    cfg.index.device_dtype = dtype
    cfg.index.corpus_shards = SHARDS
    cfg.index.corpus_slices = slices
    cfg.index.kind = kind
    cfg.index.ivf_min_rows = 64
    cfg.index.ivf_nlist = 8
    cfg.index.ivf_nprobe = 3
    return cfg


def _port_mesh(slices):
    if slices == 1:
        return port_mesh.corpus_mesh(SHARDS, devices=["cpu"] * SHARDS)
    return port_mesh.multislice_corpus_mesh(slices, SHARDS,
                                            devices=["cpu"] * SHARDS)


def _engines(tmp_path, towers, dtype, slices=1, kind="exact", rows=400):
    """A JAX and a port engine over the same ``rows`` unit rows in four
    videos, on eight shards (the IVF tier built as the engines build it)."""
    jax_emb, port_emb = towers
    emb = unit_rows(np.random.default_rng(0), rows, D)
    emb[300:310] = emb[10:20]                        # equal rows
    out = []
    for name, mod, cls, kw in (
            ("jax", jax_config, JaxEngine, {"embedder": jax_emb}),
            ("port", torch_config, VideoSearchEngine,
             {"embedder": port_emb, "device": "cpu",
              "corpus_mesh": _port_mesh(slices)})):
        videos = tmp_path / name
        videos.mkdir()
        engine = cls(str(videos), config=_config(mod, videos, dtype, slices,
                                                 kind), **kw)
        per = rows // 4
        for v in range(4):
            engine.index.add_batch(emb[v * per:(v + 1) * per], f"vid{v}.mp4",
                                   [float(t) for t in range(per)])
        engine._maybe_build_ivf()
        out.append(engine)
    return out


def _same(got, want):
    assert [(r["video_name"], r["frame_id"]) for r in got] == \
        [(r["video_name"], r["frame_id"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=1e-5)
    assert [r["formatted_time"] for r in got] == \
        [r["formatted_time"] for r in want]


def _drive(jax_engine, port):
    """Text (one query at a time), batch, coalesced and vector searches."""
    for q in QUERIES:
        got, cached = port.search_ex(q, k=5, use_cache=False)
        assert not cached and len(got) == 5
        _same(got, jax_engine.search(q, k=5, use_cache=False))
    batch = [f"batch query {i}" for i in range(5)]
    for g, w in zip(port.search_batch(batch, k=4),
                    jax_engine.search_batch(batch, k=4)):
        _same(g, w)
    coalesced = [f"coalesced query {i}" for i in range(8)]
    try:
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(
                lambda q: port.search_coalesced_ex(q, 5, False)[0],
                coalesced))
    finally:
        port.close()
    for q, g in zip(coalesced, got):
        _same(g, jax_engine.search(q, k=5, use_cache=False))
    vec = np.random.default_rng(3).standard_normal(D).astype(np.float32)
    _same(port.search_by_vector_ex(vec, k=6, use_cache=False)[0],
          jax_engine.search_by_vector_ex(vec, k=6, use_cache=False)[0])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_mesh_engine_matches_jax(tmp_path, towers, dtype):
    jax_engine, port = _engines(tmp_path, towers, dtype)
    index = port.index
    assert index.mesh.n_shards == SHARDS == jax_engine.index._n_shards
    _drive(jax_engine, port)
    assert index._mirror_layout_cur == ("id" if dtype == "float32"
                                        else "perm")
    assert len(index._device_emb) == SHARDS
    assert index._emb.shape[0] == jax_engine.index._emb.shape[0] \
        == SHARDS * 4096
    assert port.accuracy_mode() == jax_engine.accuracy_mode()
    assert port.metrics.counter("fused_search_fallbacks") == 0


def test_two_slice_engine_matches_jax(tmp_path, towers):
    """``corpus_slices = 2``: eight shards as two slices of four, merged
    within each slice and then across."""
    jax_engine, port = _engines(tmp_path, towers, "bfloat16", slices=2)
    assert port.index.mesh.shape == {"dcn": 2, "corpus": 4}
    assert dict(jax_engine.index.mesh.shape) == port.index.mesh.shape
    _drive(jax_engine, port)


def test_mesh_ivf_engine_matches_jax(tmp_path, towers):
    jax_engine, port = _engines(tmp_path, towers, "bfloat16", kind="ivf")
    stats = port.ann_stats()
    assert stats == jax_engine.ann_stats()
    assert stats["devices"] == SHARDS
    assert sum(stats["tiles_per_device"]) == stats["tiles"]
    assert port.stats()["ann"] == jax_engine.stats()["ann"]
    assert len(port._ivf._sh_tiled) == SHARDS and port._ivf._tiled is None
    _drive(jax_engine, port)
    assert port.metrics.counter("ann_searches") > 0
    # appends reach the fresh buffer; a removal rebuilds on the mesh
    more = unit_rows(np.random.default_rng(2), 50, D)
    for engine in (jax_engine, port):
        engine.index.add_batch(more, "vid9.mp4", [float(t) for t in range(50)])
        engine._ivf_absorb_appends()
        assert engine.remove_video("vid0.mp4") == 100
    assert port.ann_stats() == jax_engine.ann_stats()
    _same(port.search_ex("after the rebuild", k=5, use_cache=False)[0],
          jax_engine.search("after the rebuild", k=5, use_cache=False))


def test_two_slice_ivf_keeps_one_replica(tmp_path, towers):
    jax_engine, port = _engines(tmp_path, towers, "int8", slices=2,
                                kind="ivf")
    stats = port.ann_stats()
    assert stats == jax_engine.ann_stats()
    assert "devices" not in stats and port._ivf.mesh is None
    _same(port.search_ex("one replica", k=5, use_cache=False)[0],
          jax_engine.search("one replica", k=5, use_cache=False))


@pytest.mark.parametrize("nprobe", [2, 16])
def test_ivf_load_built_on_a_mesh(nprobe):
    """A JAX mesh tier's state packed onto the port's eight shards: the
    same greedy placement and the same results, fresh rows included."""
    rng = np.random.default_rng(5)
    emb = unit_rows(rng, 3000, D)
    jax_tier = jax_ivf.IVFIndex(nlist=16, nprobe=nprobe,
                                mesh=jax_mesh.corpus_mesh(SHARDS))
    jax_tier.build(emb)
    jax_tier.add(unit_rows(rng, 40, D))
    port = port_ivf.IVFIndex.load_built(
        **ivf_state(jax_tier), mesh=port_mesh.corpus_mesh(
            SHARDS, devices=["cpu"] * SHARDS))
    assert port.stats() == jax_tier.stats()
    np.testing.assert_array_equal(port._cluster_dev, jax_tier._cluster_dev)
    np.testing.assert_array_equal(port._reconstruct_corpus(),
                                  jax_tier._reconstruct_corpus())
    q = emb[[1, 500, 2999, 1200]] + 0.05 * rng.standard_normal(
        (4, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    for k in (1, 10):
        pv, pi = port.search(q, k=k)
        jv, ji = jax_tier.search(q, k=k)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=0)
