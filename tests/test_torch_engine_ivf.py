"""The port's engine with ``index.kind = "ivf"`` vs the JAX engine, on the
CPU: the flows of ``tests/test_engine_ivf.py`` through the same tiny f32
CLIP towers (weights moved with ``params_from_jax``), the port's k-means
started from the JAX package's seed rows.

- the tier builds and serves text, batch, coalesced and vector searches
  with the JAX engine's rows (same frames in the same order, scores within
  1e-5), its ``ann_stats()`` and ``accuracy_mode()`` ("approximate-ivf",
  also under ``/api/stats``);
- full probe equals the exact engine;
- below ``ivf_min_rows`` the mirror's scan serves;
- appended rows go to the fresh buffer, a removal rebuilds the tier;
- startup end to end (synthetic videos → ingest → the tier built);
- the coalescer's flushes take the IVF route, chosen before dispatch;
- ``corpus_shards > 0`` builds its mesh from the CUDA devices (raises
  without a card).
"""

import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_synthetic_video
from tests.torch_parity import (
    TINY_224_FULL_VOCAB,
    TINY_FULL_VOCAB,
    jax_kmeans_init,
    port_state_dict,
    unit_rows,
)
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxEmbedder
from video_quierer_tpu_torch.api.server import create_server
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index import ivf as port_ivf
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
from video_quierer_tpu_torch.parallel.mesh import corpus_mesh

D = 64
QUERIES = ["a dog in the park", "the same deterministic query",
           "night city " * 30]          # the last takes the 77 bucket


def _config(mod, videos, **ivf):
    cfg = mod.EngineConfig(videos_dir=str(videos),
                           api=mod.ApiConfig(max_frames=10))
    cfg.index.embed_dim = D
    cfg.model.dtype = "float32"
    cfg.index.kind = "ivf"
    cfg.index.ivf_min_rows = ivf.get("ivf_min_rows", 64)
    cfg.index.ivf_nlist = ivf.get("ivf_nlist", 8)
    cfg.index.ivf_nprobe = ivf.get("ivf_nprobe", 8)
    return cfg


@pytest.fixture(autouse=True)
def jax_seeds(monkeypatch):
    monkeypatch.setattr(port_ivf, "init_indices", jax_kmeans_init)


@pytest.fixture(scope="module")
def towers():
    """(JAX embedder, port embedder) on the same weights."""
    jax_emb = JaxEmbedder(TINY_FULL_VOCAB, dtype=jnp.float32)
    port_emb = CLIPEmbedder(TINY_FULL_VOCAB, dtype=torch.float32,
                            device="cpu",
                            state_dict=port_state_dict(jax_emb.params,
                                                       TINY_FULL_VOCAB))
    return jax_emb, port_emb


def _engines(tmp_path, towers, rows=400, **ivf):
    """A JAX and a port engine over the same ``rows`` unit rows in four
    videos, the tier built as the JAX fixture builds it."""
    jax_emb, port_emb = towers
    emb = unit_rows(np.random.default_rng(0), rows, D)
    out = []
    for name, mod, cls, kw in (
            ("jax", jax_config, JaxEngine, {"embedder": jax_emb}),
            ("port", torch_config, VideoSearchEngine,
             {"embedder": port_emb, "device": "cpu"})):
        videos = tmp_path / name
        videos.mkdir()
        engine = cls(str(videos), config=_config(mod, videos, **ivf), **kw)
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


@pytest.mark.parametrize("nprobe", [2, 8])
def test_ivf_tier_builds_and_serves(tmp_path, towers, nprobe):
    jax_engine, port = _engines(tmp_path, towers, ivf_nprobe=nprobe)
    assert port._ivf is not None
    stats = port.ann_stats()
    assert stats == jax_engine.ann_stats()
    assert stats["kind"] == "ivf" and stats["active"]
    assert stats["nlist"] == 8 and stats["rows"] == 400
    assert port.accuracy_mode() == jax_engine.accuracy_mode() == \
        "approximate-ivf"
    assert port.stats()["index"]["accuracy_mode"] == "approximate-ivf"
    assert port.stats()["ann"] == jax_engine.stats()["ann"]
    for q in QUERIES:
        got, cached = port.search_ex(q, k=5, use_cache=False)
        assert not cached and len(got) == 5
        _same(got, jax_engine.search(q, k=5, use_cache=False))
    assert port.metrics.counter("ann_searches") == len(QUERIES)
    assert port.metrics.counter("ivf_builds") == 1


def test_ivf_full_probe_matches_exact_engine(tmp_path, towers):
    """nprobe == nlist: the tier returns the exact scan's rows."""
    jax_engine, port = _engines(tmp_path, towers)
    exact_cfg = torch_config.EngineConfig(videos_dir=str(tmp_path / "x"))
    exact_cfg.index.embed_dim = D
    exact_cfg.index.device_dtype = "float32"
    exact = VideoSearchEngine(str(tmp_path / "x"), config=exact_cfg,
                              embedder=towers[1], device="cpu")
    exact.index.load_cache_dict(port.index.to_cache_dict())
    for q in QUERIES:
        got = port.search_ex(q, k=10, use_cache=False)[0]
        _same(got, exact.search_ex(q, k=10, use_cache=False)[0])
        _same(got, jax_engine.search(q, k=10, use_cache=False))


def test_ivf_batch_and_vector_paths(tmp_path, towers):
    jax_engine, port = _engines(tmp_path, towers, ivf_nprobe=3)
    queries = ["query one", "query two", "query three"]
    got = port.search_batch(queries, k=4)
    want = jax_engine.search_batch(queries, k=4)
    assert len(got) == 3 and all(len(r) == 4 for r in got)
    for g, w in zip(got, want):
        _same(g, w)
    vec = np.random.default_rng(3).standard_normal(D).astype(np.float32)
    res, cached = port.search_by_vector_ex(vec, k=3, use_cache=False)
    assert not cached and len(res) == 3
    _same(res, jax_engine.search_by_vector_ex(vec, k=3, use_cache=False)[0])
    # a vector query is cached under its vector, as in the reference
    assert port.search_by_vector_ex(vec, k=3)[1] is False
    assert port.search_by_vector_ex(vec, k=3)[1] is True
    assert port.metrics.counter("ann_searches") == 3 + 2


def test_ivf_below_min_rows_uses_the_mirror(tmp_path, towers):
    jax_engine, port = _engines(tmp_path, towers, rows=128,
                                ivf_min_rows=10_000)
    assert port._ivf is None
    assert port.ann_stats() == jax_engine.ann_stats()
    assert port.ann_stats()["active"] is False
    assert port.accuracy_mode() == "exact-f32-rerank"
    got = port.search_ex("anything", k=3, use_cache=False)[0]
    assert len(got) == 3
    _same(got, jax_engine.search("anything", k=3, use_cache=False))
    assert port.metrics.counter("ann_searches") == 0


def test_ivf_absorbs_appends_and_rebuilds_on_delete(tmp_path, towers):
    engines = _engines(tmp_path, towers, ivf_nprobe=4)
    more = unit_rows(np.random.default_rng(2), 50, D)
    for engine in engines:
        built = engine._ivf_rows
        engine.index.add_batch(more, "vid9.mp4", [float(t) for t in range(50)])
        engine._ivf_absorb_appends()
        assert engine._ivf_rows == built + 50
    jax_engine, port = engines
    assert port.ann_stats() == jax_engine.ann_stats()
    assert port.ann_stats()["fresh_rows"] == 50
    # fresh rows are exact-merged into the results
    res, _ = port.search_by_vector_ex(more[7], k=3, use_cache=False)
    assert res[0]["video_name"] == "vid9.mp4" and res[0]["frame_id"] == 407
    _same(res, jax_engine.search_by_vector_ex(more[7], k=3,
                                              use_cache=False)[0])
    # a removal compacts the row ids: the tier is rebuilt
    for engine in engines:
        assert engine.remove_video("vid0.mp4") == 100
    assert port._ivf is not None
    assert port.ann_stats() == jax_engine.ann_stats()
    assert port.ann_stats()["rows"] == 350
    assert port.ann_stats()["fresh_rows"] == 0
    assert port.metrics.counter("ivf_builds") == 2
    got = port.search_ex("post delete", k=5, use_cache=False)[0]
    assert all(r["video_name"] != "vid0.mp4" for r in got)
    _same(got, jax_engine.search("post delete", k=5, use_cache=False))


def test_ivf_startup_end_to_end(tmp_path):
    """Synthetic videos → startup ingest (224 px tiny towers) → the tier
    built at the end of startup; the same rows as the JAX engine."""
    jax_emb = JaxEmbedder(TINY_224_FULL_VOCAB, dtype=jnp.float32, seed=3)
    port_emb = CLIPEmbedder(TINY_224_FULL_VOCAB, dtype=torch.float32,
                            device="cpu",
                            state_dict=port_state_dict(jax_emb.params,
                                                       TINY_224_FULL_VOCAB))
    engines = []
    for name, mod, cls, kw in (
            ("jax", jax_config, JaxEngine, {"embedder": jax_emb}),
            ("port", torch_config, VideoSearchEngine,
             {"embedder": port_emb, "device": "cpu"})):
        videos = tmp_path / name
        videos.mkdir()
        for i in range(3):
            make_synthetic_video(videos / f"vid{i}.mp4", n_frames=60, seed=i)
        cfg = _config(mod, videos, ivf_min_rows=16, ivf_nlist=4)
        cfg.ingest.batch_size = 16
        engine = cls(str(videos), config=cfg, **kw)
        engine.startup()
        assert engine.ready and engine._ivf is not None
        engines.append(engine)
    jax_engine, port = engines
    assert len(port.index) == len(jax_engine.index) == 30
    assert port.ann_stats() == jax_engine.ann_stats()
    got = port.search_ex("a synthetic scene", k=3, use_cache=False)[0]
    assert len(got) == 3
    _same(got, jax_engine.search("a synthetic scene", k=3, use_cache=False))


def test_coalesced_flushes_take_the_ivf_route(tmp_path, towers, monkeypatch):
    jax_engine, port = _engines(tmp_path, towers, ivf_nprobe=3)
    queries = [f"coalesced query {i}" for i in range(16)]
    want = [jax_engine.search(q, k=5, use_cache=False) for q in queries]

    def mirror_route(*_args):
        raise AssertionError("the mirror's fused route was dispatched")

    monkeypatch.setattr(port, "_dispatch_batch_fused", mirror_route)
    try:
        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(
                lambda q: port.search_coalesced_ex(q, 5, False)[0], queries))
    finally:
        port.close()
    for g, w in zip(got, want):
        _same(g, w)
    assert port.metrics.counter("ann_searches") == 16
    assert port.metrics.counter("fused_search_fallbacks") == 0


def test_api_stats_reports_the_ivf_tier(tmp_path, towers):
    _, port = _engines(tmp_path, towers)
    port._ready = True
    server = create_server(port, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/api/stats"
        with urllib.request.urlopen(url, timeout=60) as r:
            body = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    assert body["index_performance"]["accuracy_mode"] == "approximate-ivf"
    assert body["index_performance"]["kind"] == "ivf"


@pytest.mark.parametrize("kind", ["exact", "ivf"])
def test_corpus_shards_still_raise(tmp_path, kind):
    """``index.corpus_shards`` builds its mesh from the CUDA devices, so
    without a card it still raises (never a silent CPU mesh); an explicit
    ``corpus_mesh`` shards the index."""
    cfg = torch_config.EngineConfig(videos_dir=str(tmp_path))
    cfg.index.kind = kind
    cfg.index.corpus_shards = 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            VideoSearchEngine(str(tmp_path), config=cfg, device="cpu")
    engine = VideoSearchEngine(str(tmp_path), config=cfg, device="cpu",
                               corpus_mesh=corpus_mesh(2, devices=["cpu"] * 2))
    assert engine.index.mesh.n_shards == 2


def test_rebuild_after_a_removed_video_rebuilds_the_tier(tmp_path):
    """``rebuild()`` on an IVF engine above ``ivf_min_rows`` once a video
    file is gone: the tier is rebuilt on the new rows (none of the old
    corpus's ids left), and a search's rows equal the exact scan over the
    rows the tier probes (the same clusters by the same numpy rule, the
    same tile budget). The JAX engine keeps its old tier there (its ingest
    feeds the old tiles only rows past the old count); the port does not
    copy that."""
    jax_emb = JaxEmbedder(TINY_224_FULL_VOCAB, dtype=jnp.float32, seed=3)
    port_emb = CLIPEmbedder(TINY_224_FULL_VOCAB, dtype=torch.float32,
                            device="cpu",
                            state_dict=port_state_dict(jax_emb.params,
                                                       TINY_224_FULL_VOCAB))
    engines = []
    for name, mod, cls, kw in (
            ("jax", jax_config, JaxEngine, {"embedder": jax_emb}),
            ("port", torch_config, VideoSearchEngine,
             {"embedder": port_emb, "device": "cpu"})):
        videos = tmp_path / name
        videos.mkdir()
        for i in range(4):
            make_synthetic_video(videos / f"vid{i}.mp4", n_frames=40, seed=i)
        cfg = _config(mod, videos, ivf_min_rows=16, ivf_nlist=4,
                      ivf_nprobe=2)
        cfg.ingest.batch_size = 16
        engine = cls(str(videos), config=cfg, **kw)
        engine.startup()
        assert engine._ivf is not None and engine._ivf_rows == 40
        (videos / "vid1.mp4").unlink()
        assert engine.rebuild() == 30
        engines.append(engine)
    jax_engine, port = engines
    assert jax_engine._ivf_rows == 40          # the reference's stale tier
    tier = port._ivf
    assert tier is not None and port._ivf_rows == tier._n_built == 30
    assert port.ann_stats()["rows"] == 30 and tier._fresh is None
    ids = tier._row_ids[tier._row_ids >= 0]
    assert sorted(ids.tolist()) == list(range(30))
    assert "vid1.mp4" not in port.index.video_names()
    corpus = port.index._emb[:30]
    budget = tier.tile_budget()
    nprobe = min(tier.nprobe, tier.nlist)
    for query in QUERIES:
        rows = port.search_ex(query, k=8, use_cache=False)[0]
        q = port.index.normalize_query(port.encode_text(query))
        csims = q @ tier._centroids_np.T
        clusters = np.argpartition(-csims, nprobe - 1)[:nprobe]
        cand = np.concatenate([
            tier._row_ids[s: s + min(c, budget)].ravel() for s, c in zip(
                tier._tile_start_np[clusters],
                tier._tile_counts_np[clusters])])
        cand = cand[cand >= 0]
        sc = corpus[cand] @ q
        top = np.lexsort((cand, -sc))[:8]
        assert [r["frame_id"] for r in rows] == cand[top].tolist()
        np.testing.assert_allclose([r["score"] for r in rows], sc[top],
                                   atol=1e-5)
        assert all(r["video_name"] != "vid1.mp4" for r in rows)
    port.close()
