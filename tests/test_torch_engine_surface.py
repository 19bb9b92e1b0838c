"""The port engine's query and maintenance methods against the JAX
engine's, each engine over its own videos dir holding the same seeded
pickle cache (8 videos x 2,048 rows x 64, each video's rows around its own
centre), on the same f32 tiny tower that takes 224 px frames and the full
CLIP vocab (weights moved with ``params_from_jax``):

- ``encode_text`` (vectors within 1e-5), ``search`` and
  ``search_coalesced`` (the same frames in the same order, scores within
  1e-5), ``warm_cache`` (then answered from the query cache);
- ``search_videos`` (the same videos, ``frame_count`` and
  ``best_timestamp``, scores within 1e-5; the ``video_search_latency``
  metric counts it);
- ``search_similar_ex``: the rows of a vector search from the seed
  frame's own row, the seed left out; ``KeyError`` for a video without
  rows;
- ``save``/``clear``/``load`` and ``rebuild`` (two synthetic mp4s in the
  dir: the rows within 1e-4 of JAX's, the same metadata).
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.helpers import make_synthetic_video
from tests.test_torch_slice import _config
from tests.torch_parity import TINY_224_FULL_VOCAB, port_state_dict
from video_quierer_tpu.engine.config import EngineConfig as JaxConfig
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxEmbedder
from video_quierer_tpu_torch.engine.config import EngineConfig
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder

D = 64
N_VIDEOS = 8
ROWS = 2048
MODEL = TINY_224_FULL_VOCAB
SCORE_ATOL = 1e-5
QUERIES = ("a dog on the beach", "night city lights", "snow forest road",
           "kitchen stage goal crowd")


def video_name(v: int) -> str:
    return f"v{v}.mp4"


def write_cache(path, seed: int = 5):
    """The seeded cache: video v's rows scatter around its own centre."""
    rng = np.random.default_rng(seed)
    idx = DeviceVideoIndex(dim=D, device="cpu")
    for v in range(N_VIDEOS):
        rows = rng.standard_normal(D).astype(np.float32) \
            + 1.5 * rng.standard_normal((ROWS, D)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
        idx.add_batch(rows, video_name(v), [0.25 * t for t in range(ROWS)])
    assert idx.save_to_disk(path)


@pytest.fixture(scope="module")
def embedders():
    jax_emb = JaxEmbedder(MODEL, dtype=jnp.float32)
    port_emb = CLIPEmbedder(MODEL, dtype=torch.float32, device="cpu",
                            state_dict=port_state_dict(jax_emb.params,
                                                       MODEL))
    return jax_emb, port_emb


@pytest.fixture(scope="module")
def cache_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("cache") / "video_search_cache.pkl"
    write_cache(path)
    return path


def engine_pair(root, cache_file, embedders, configure=None):
    """The JAX and the port engine, each over its own dir ``root/jax`` and
    ``root/port`` holding a copy of the cache, started; ``configure`` edits
    both configs first."""
    jax_emb, port_emb = embedders
    out = []
    for name, cfg_cls, cls, emb in (("jax", JaxConfig, JaxEngine, jax_emb),
                                    ("port", EngineConfig,
                                     VideoSearchEngine, port_emb)):
        d = root / name
        d.mkdir()
        shutil.copy(cache_file, d / cache_file.name)
        cfg = _config(cfg_cls, d, MODEL)
        if configure is not None:
            configure(cfg)
        kw = {"device": "cpu"} if cls is VideoSearchEngine else {}
        engine = cls(d, config=cfg, embedder=emb, **kw)
        engine.startup()
        assert len(engine.index) == N_VIDEOS * ROWS
        out.append(engine)
    return tuple(out)


@pytest.fixture(scope="module")
def engines(tmp_path_factory, cache_file, embedders):
    jax_engine, port = engine_pair(tmp_path_factory.mktemp("surface"),
                                   cache_file, embedders)
    yield jax_engine, port
    port.close()


def same_rows(got, want):
    assert [(r["video_name"], r["frame_id"], r["timestamp"]) for r in got] \
        == [(r["video_name"], r["frame_id"], r["timestamp"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=0,
                               atol=SCORE_ATOL)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["formatted_time"] == w["formatted_time"]


def same_videos(got, want):
    assert [(r["video_name"], r["frame_count"], r["best_timestamp"])
            for r in got] == [(r["video_name"], r["frame_count"],
                               r["best_timestamp"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("query", QUERIES)
def test_encode_and_search_match_jax(engines, query):
    jax_engine, port = engines
    np.testing.assert_allclose(port.encode_text(query),
                               jax_engine.encode_text(query), rtol=0,
                               atol=1e-5)
    same_rows(port.search(query, k=10, use_cache=False),
              jax_engine.search(query, k=10, use_cache=False))
    same_rows(port.search_coalesced(query, 7, False),
              jax_engine.search_coalesced(query, 7, False))


@pytest.mark.parametrize("k", [1, 3, N_VIDEOS + 4])
def test_search_videos_matches_jax(engines, k):
    jax_engine, port = engines
    before = port.metrics.histogram_stats(
        "video_search_latency_ms").get("count", 0)
    for query in QUERIES:
        got = port.search_videos(query, k)
        assert len(got) == min(k, N_VIDEOS)
        same_videos(got, jax_engine.search_videos(query, k))
    assert port.metrics.histogram_stats(
        "video_search_latency_ms")["count"] == before + len(QUERIES)


@pytest.mark.parametrize("seed", [(0, 0.0), (3, 101.3), (7, 1e6), (5, -2)])
def test_search_similar_matches_jax(engines, seed):
    jax_engine, port = engines
    v, t = seed
    got, cached = port.search_similar_ex(video_name(v), t, k=6,
                                         use_cache=False)
    want, _ = jax_engine.search_similar_ex(video_name(v), t, k=6,
                                           use_cache=False)
    assert not cached and len(got) == 6
    same_rows(got, want)
    row = port.index.nearest_frame(video_name(v), t)
    assert (video_name(v), row) not in {(r["video_name"], r["frame_id"])
                                        for r in got}
    assert port.search_similar(video_name(v), t, k=6,
                               use_cache=False) == got
    for engine in engines:
        with pytest.raises(KeyError):
            engine.search_similar_ex("missing.mp4", 0.0)


def test_warm_cache_matches_jax(engines):
    jax_engine, port = engines
    queries = ["warm one", "warm two", "warm three"]
    assert port.warm_cache(queries, k=4) == \
        jax_engine.warm_cache(queries, k=4) == 3
    for q in queries:
        got, cached = port.search_ex(q, k=4)
        want, jax_cached = jax_engine.search_ex(q, k=4)
        assert cached and jax_cached
        same_rows(got, want)


def test_save_clear_load_match_jax(tmp_path, cache_file, embedders):
    engines = engine_pair(tmp_path, cache_file, embedders)
    try:
        q = "a dog on the beach"
        for engine in engines:
            engine.index.remove_video(video_name(2))
            assert engine.save(engine.videos_dir / "copy.pkl")
            engine.clear()
            assert len(engine.index) == 0
            assert not engine.cache_path.exists()
            assert engine.search_videos(q, 3) == []
            assert engine.search(q, 3, use_cache=False) == []
            assert not engine.load(engine.videos_dir / "missing.pkl")
            assert engine.load(engine.videos_dir / "copy.pkl")
            assert len(engine.index) == (N_VIDEOS - 1) * ROWS
        jax_engine, port = engines
        same_videos(port.search_videos(q, 5), jax_engine.search_videos(q, 5))
        same_rows(port.search(q, 8, use_cache=False),
                  jax_engine.search(q, 8, use_cache=False))
        assert port.load() is jax_engine.load() is False   # cache cleared
        assert port.save() and jax_engine.save()
        assert port.load() and jax_engine.load()
        assert port.index.to_cache_dict()["metadata"] == \
            jax_engine.index.to_cache_dict()["metadata"]
    finally:
        engines[1].close()


def test_rebuild_matches_jax(tmp_path, cache_file, embedders):
    def small_ingest(cfg):
        cfg.api.max_frames = 6
        cfg.ingest.batch_size = 8

    engines = engine_pair(tmp_path, cache_file, embedders, small_ingest)
    try:
        for engine in engines:
            for i in range(2):
                make_synthetic_video(engine.videos_dir / f"clip_{i}.mp4",
                                     n_frames=30 + 20 * i, seed=i)
        added = [engine.rebuild() for engine in engines]
        assert added[0] == added[1] == 12
        want, got = (e.index.to_cache_dict() for e in engines)
        assert got["metadata"] == want["metadata"]
        assert got["video_hashes"].keys() == want["video_hashes"].keys()
        np.testing.assert_allclose(np.stack(got["embeddings"]),
                                   np.stack(want["embeddings"]), rtol=1e-4,
                                   atol=1e-4)
        for engine in engines:
            assert engine.cache_path.exists()
            assert engine.index.video_frame_counts() == {
                "clip_0.mp4": 6, "clip_1.mp4": 6}
        same_videos(engines[1].search_videos("a red scene", 2),
                    engines[0].search_videos("a red scene", 2))
    finally:
        engines[1].close()
