"""``api.use_clip = false`` in the port against the JAX package, on the CPU:

- ``engine/fallback.py``: ``VisualStatsEmbedder`` (36 statistics of each
  frame, zero-padded and normalized) and ``KeywordQueryEncoder`` (keyword
  positions, a seeded random unit vector for anything else) at 512 and
  768 wide, equal to the JAX package's (the encoder's draws in the same
  order);
- a keyword engine against the JAX engine over the same synthetic mp4s
  (no tower at all): the ingested rows, text search, batch search, the
  coalesced route, video search and vector search (the same frames in the
  same order, scores within 1e-5; queries sent one at a time, since the
  keyword encoder's draws depend on the call order), the IVF tier over
  the keyword vectors, and over HTTP ``/api/search`` and ``/api/stats``
  (``processor_type`` "Visual");
- with ``use_clip`` on, a failed text encode raises (nothing falls back
  to the keyword encoder) and ``embed_fallbacks`` stays 0.
"""

import json
import shutil

import numpy as np
import pytest

from tests.test_torch_http_surface import port_server, same_answer, send
from tests.test_torch_ingest import videos  # noqa: F401  (a fixture)
from tests.test_torch_slice import _jax_app
from tests.torch_parity import jax_kmeans_init
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine import fallback as jax_fallback
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine import fallback as torch_fallback
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index import ivf as port_ivf

SCORE_ATOL = 1e-5
# keyword queries (known positions) and unknown ones (random draws)
QUERIES = ["a bright phone app", "dark night", "CAR chase", "football goal",
           "a dog on the beach", "vehicle and phone", "something else",
           "bright goal car phone", "xyz"]


@pytest.mark.parametrize("dim", [512, 768])
def test_visual_stats_embedder_matches_jax(dim):
    rng = np.random.default_rng(dim)
    frames = rng.integers(0, 256, (6, 224, 224, 3), dtype=np.uint8)
    frames[1] = 0                          # a black frame: norm 0 kept 0
    frames[2] = frames[2] // 8 * 8         # coarse levels
    got = torch_fallback.VisualStatsEmbedder(dim).embed_frames(frames)
    want = jax_fallback.VisualStatsEmbedder(dim).embed_frames(frames)
    assert got.shape == (6, dim) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim", [512, 768])
def test_keyword_encoder_matches_jax(dim):
    got = torch_fallback.KeywordQueryEncoder(dim=dim)
    want = jax_fallback.KeywordQueryEncoder(dim=dim)
    for q in QUERIES:
        np.testing.assert_array_equal(got.embed_text(q), want.embed_text(q))
    np.testing.assert_array_equal(got.embed_texts(QUERIES),
                                  want.embed_texts(QUERIES))
    seeded = torch_fallback.KeywordQueryEncoder(seed=5, dim=dim)
    np.testing.assert_array_equal(
        seeded.embed_text("xyz"),
        jax_fallback.KeywordQueryEncoder(seed=5, dim=dim).embed_text("xyz"))


def _engines(tmp_path, clips, kind="exact", dtype="bfloat16"):
    out = []
    for name, mod, cls in (("jax", jax_config, JaxEngine),
                           ("port", torch_config, VideoSearchEngine)):
        d = tmp_path / name
        d.mkdir()
        for clip in clips:
            shutil.copy2(clip, d / clip.name)
        cfg = mod.EngineConfig(videos_dir=str(d),
                               api=mod.ApiConfig(use_clip=False))
        cfg.index.device_dtype = dtype
        cfg.index.kind = kind
        cfg.index.ivf_min_rows = 64
        cfg.index.ivf_nlist = 4
        cfg.index.ivf_nprobe = 2
        kw = {"device": "cpu"} if cls is VideoSearchEngine else {}
        engine = cls(d, config=cfg, **kw)
        engine.startup()
        out.append(engine)
    return out


def _same(got, want):
    assert [(r["video_name"], r["frame_id"], r["timestamp"]) for r in got] \
        == [(r["video_name"], r["frame_id"], r["timestamp"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=0,
                               atol=SCORE_ATOL)
    assert [r["formatted_time"] for r in got] == \
        [r["formatted_time"] for r in want]


@pytest.fixture
def pair(tmp_path, videos):  # noqa: F811
    jax_engine, port = _engines(tmp_path, videos[:3])
    yield jax_engine, port
    port.close()


def test_keyword_engine_ingests_the_jax_rows(pair):
    jax_engine, port = pair
    n = len(jax_engine.index)
    assert n > 0 and len(port.index) == n
    assert port._get_embedder() is None and port._embedder is None
    np.testing.assert_array_equal(port.index._emb[:n],
                                  jax_engine.index._emb[:n])
    np.testing.assert_array_equal(port.index._timestamps[:n],
                                  jax_engine.index._timestamps[:n])
    # the mirror followed the host rows batch by batch (no device output)
    assert port.index._device_rows == n
    assert port.stats()["processor_type"] == "Visual"
    assert port.metrics.counter("embed_fallbacks") == 0


def test_keyword_engine_searches_match_jax(pair):
    jax_engine, port = pair
    for q in QUERIES:
        for k in (1, 5, 12):
            _same(port.search(q, k=k, use_cache=False),
                  jax_engine.search(q, k=k, use_cache=False))
    _same(port.search("bright", k=6, dedup_videos=True),
          jax_engine.search("bright", k=6, dedup_videos=True))
    for got, want in zip(port.search_batch(QUERIES, k=7),
                         jax_engine.search_batch(QUERIES, k=7)):
        _same(got, want)
    for q in QUERIES[:4]:                       # one at a time
        _same(port.search_coalesced(q, k=5, use_cache=False),
              jax_engine.search_coalesced(q, k=5, use_cache=False))
    for q in ("car", "something unknown"):
        got, want = port.search_videos(q, 3), jax_engine.search_videos(q, 3)
        assert [r["video_name"] for r in got] == \
            [r["video_name"] for r in want]
    vec = port.index._emb[7]
    _same(port.search_by_vector(vec, k=5), jax_engine.search_by_vector(vec,
                                                                       k=5))


def test_keyword_engine_ivf_tier_matches_jax(tmp_path, videos,  # noqa: F811
                                              monkeypatch):
    monkeypatch.setattr(port_ivf, "init_indices", jax_kmeans_init)
    jax_engine, port = _engines(tmp_path, videos[:3], kind="ivf",
                                dtype="float32")
    try:
        assert port.accuracy_mode() == jax_engine.accuracy_mode() == \
            "approximate-ivf"
        for q in QUERIES:
            _same(port.search(q, k=8, use_cache=False),
                  jax_engine.search(q, k=8, use_cache=False))
        for got, want in zip(port.search_batch(QUERIES[:5], k=4),
                             jax_engine.search_batch(QUERIES[:5], k=4)):
            _same(got, want)
        assert port.metrics.counter("ann_searches") == \
            jax_engine.metrics.counter("ann_searches")
    finally:
        port.close()


def test_keyword_engine_over_http_matches_jax(pair, tmp_path):
    jax_engine, port = pair
    with _jax_app(jax_engine, tmp_path) as jax_base, \
            port_server(port, tmp_path / "cfg.json", tmp_path) as port_base:
        for method, path, body in (
                ("GET", "/api/stats", None),
                ("POST", "/api/search", {"query": "bright car", "k": 5}),
                ("POST", "/api/search", {"query": "unknown", "k": 3}),
                ("POST", "/api/search/batch", {"queries": QUERIES[:3]}),
                ("POST", "/api/search/videos", {"query": "goal"})):
            want = send(jax_base, method, path, body)
            got = send(port_base, method, path, body)
            same_answer(got, want, (method, path, body))
        stats = json.loads(send(port_base, "GET", "/api/stats")[2])
    assert stats["feature_extraction"] == {"processor_type": "Visual"}


def test_failed_text_encode_raises(tmp_path):
    class Broken:
        pretrained = False

        def embed_text(self, text):
            raise RuntimeError("tower down")

    cfg = torch_config.EngineConfig(videos_dir=str(tmp_path))
    cfg.index.embed_dim = 64
    engine = VideoSearchEngine(tmp_path, config=cfg, embedder=Broken(),
                               device="cpu")
    with pytest.raises(RuntimeError, match="tower down"):
        engine.encode_text("a dog")
    with pytest.raises(RuntimeError, match="tower down"):
        engine.search_videos("a dog", 3)
    assert engine.metrics.counter("embed_fallbacks") == 0
