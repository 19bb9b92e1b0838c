"""The slice end to end: the port's engine vs the JAX engine on the same
tiny f32 tower (weights moved with ``params_from_jax``), the same
2 x 8192-row corpus loaded through the pickle v1.0 cache, and the same
short and 77-token text queries — single searches, a coalesced batch of
32 and ``search_batch`` give the same rows (same frames in the same
order, scores within 1e-5). One real-socket round trip through the
port's HTTP server checks the ``/api/search`` response shape, and a table
of request bodies gets the same status codes from the port's server as
from the JAX package's aiohttp app (422: pydantic's error ``type`` and
``loc``). Image queries go through a second pair of engines on a tower
that takes 224 px frames (``TINY_224_FULL_VOCAB``): a ``data:image/``
URI that decodes to an image is searched by that image
(``search_by_image_ex``), every other query as text, and both servers
give the same status and rows for a table of such queries.
"""

import asyncio
import base64
import contextlib
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from aiohttp import web

from tests.torch_parity import (
    TINY_224_FULL_VOCAB,
    TINY_FULL_VOCAB,
    port_state_dict,
)
from video_quierer_tpu.api.app import create_app
from video_quierer_tpu.engine.config import EngineConfig as JaxConfig
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxEmbedder
from video_quierer_tpu_torch.api.server import create_server
from video_quierer_tpu_torch.engine.config import EngineConfig
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder

D = 64
WORDS = ("dog cat beach city night snow car river crowd bird forest road "
         "sunset kitchen stage goal").split()
ROW_KEYS = {"video_name", "timestamp", "frame_id", "score",
            "formatted_time"}


def _queries(rng, n, words):
    return [" ".join(rng.choice(WORDS, size=words)) + f" {i}"
            for i in range(n)]


def _config(cfg_cls, videos_dir, model=TINY_FULL_VOCAB):
    cfg = cfg_cls(videos_dir=str(videos_dir))
    cfg.index.embed_dim = D
    cfg.model.name = model
    cfg.model.dtype = "float32"
    return cfg


def _engine_pair(videos, rows_per_video, model):
    """The JAX engine and the port's over one seeded corpus of two videos
    (written as the pickle v1.0 cache), on the same f32 tower ``model``."""
    rng = np.random.default_rng(11)
    idx = DeviceVideoIndex(dim=D, device_dtype="bfloat16", device="cpu")
    for name in ("a.mp4", "b.mp4"):
        rows = rng.standard_normal((rows_per_video, D)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
        idx.add_batch(rows, name, [0.25 * t for t in range(rows_per_video)])
    idx.save_to_disk(videos / "video_search_cache.pkl")

    jax_emb = JaxEmbedder(model, dtype=jnp.float32)
    jax_engine = JaxEngine(videos, config=_config(JaxConfig, videos, model),
                           embedder=jax_emb)
    port_emb = CLIPEmbedder(model, dtype=torch.float32, device="cpu",
                            state_dict=port_state_dict(jax_emb.params,
                                                       model))
    port = VideoSearchEngine(videos,
                             config=_config(EngineConfig, videos, model),
                             embedder=port_emb, device="cpu")
    for e in (jax_engine, port):
        e.startup()
        assert len(e.index) == 2 * rows_per_video
    return jax_engine, port


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jax_engine, port = _engine_pair(tmp_path_factory.mktemp("videos"), 8192,
                                    TINY_FULL_VOCAB)
    yield jax_engine, port
    port.close()


@pytest.fixture(scope="module")
def image_engines(tmp_path_factory):
    """Both engines on a tower that takes 224 px frames (image queries
    resize to 224 px) and the full CLIP vocab (text queries)."""
    jax_engine, port = _engine_pair(tmp_path_factory.mktemp("videos224"),
                                    2048, TINY_224_FULL_VOCAB)
    yield jax_engine, port
    port.close()


def _same(got, want):
    assert [(r["video_name"], r["frame_id"]) for r in got] == \
        [(r["video_name"], r["frame_id"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=1e-5)
    for r in got:
        assert set(r) == ROW_KEYS


@pytest.mark.parametrize("words", [3, 90])     # seq buckets 8 and 77
def test_single_search_matches_jax(engines, words):
    jax_engine, port = engines
    q = _queries(np.random.default_rng(words), 1, words)[0]
    got, cached = port.search_ex(q, k=10, use_cache=False)
    want, _ = jax_engine.search_ex(q, k=10, use_cache=False)
    assert not cached and len(got) == 10
    _same(got, want)


@pytest.mark.parametrize("words", [4, 90])
def test_batch_and_coalesced_match_jax(engines, words):
    jax_engine, port = engines
    queries = _queries(np.random.default_rng(100 + words), 32, words)
    want = jax_engine.search_batch(queries, k=10)
    got = port.search_batch(queries, k=10)
    with ThreadPoolExecutor(32) as pool:
        coalesced = list(pool.map(
            lambda q: port.search_coalesced_ex(q, 10, False)[0], queries))
    for g, c, w in zip(got, coalesced, want):
        _same(g, w)
        _same(c, w)
    assert port.metrics.counter("embed_fallbacks") == 0
    assert port.metrics.counter("fused_search_fallbacks") == 0


def test_http_round_trip(engines):
    _, port = engines
    server = create_server(port, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, body = post("/api/search", {"query": "a dog on the beach",
                                            "k": 5, "use_cache": False})
        assert status == 200
        # the reference's response keys (api/app.py:470-476)
        assert set(body) == {"results", "search_time_ms", "from_cache",
                             "query_id", "performance"}
        assert len(body["results"]) == 5
        assert set(body["results"][0]) == ROW_KEYS
        assert body["performance"] == {"results_count": 5}
        assert post("/api/search", {"query": "  "})[0] == 400
        assert post("/api/search", {"query": "x", "k": 0})[0] == 422
        status, body = post("/api/search/batch", {"queries": ["a", "b"]})
        assert status == 200 and body["query_count"] == 2
        with urllib.request.urlopen(base + "/api/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "healthy"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    assert not thread.is_alive()


def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def _jax_app(engine, tmp):
    """The JAX package's aiohttp app over ``engine`` on a free local port
    (its own event loop on a thread); yields the base URL."""
    app = create_app(engine=engine, config_path=tmp / "config.json",
                     static_dir=tmp, run_startup=False)
    loop = asyncio.new_event_loop()
    state = {}

    async def boot():
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        state["runner"] = runner
        state["port"] = site._server.sockets[0].getsockname()[1]

    loop.run_until_complete(boot())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{state['port']}"
    finally:
        asyncio.run_coroutine_threadsafe(state["runner"].cleanup(),
                                         loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()


# bodies the reference's pydantic schemas coerce, refuse or bound
SEARCH_BODIES = [
    {"query": "a dog", "k": "5"}, {"query": "a dog", "k": 5.0},
    {"query": "a dog", "use_cache": "true"}, {"query": "a dog",
                                              "use_cache": 1},
    {"query": "a dog", "k": True}, {"query": "a dog", "k": " 7 "},
    {"query": "a dog", "dedup_videos": "yes", "offset": "2", "k": "3"},
    {"query": "a dog", "k": "5.5"}, {"query": "a dog", "k": 5.5},
    {"query": "a dog", "k": 0}, {"query": "a dog", "k": "51"},
    {"query": "a dog", "offset": 64}, {"query": "a dog", "offset": -1},
    {"query": "a dog", "use_cache": 2}, {"query": "a dog",
                                         "use_cache": "maybe"},
    {"query": "a dog", "dedup_videos": None}, {"query": 5}, {"query": None},
    {"query": ["a"]}, {}, {"query": 5, "k": "x", "use_cache": 0.5},
    {"query": "a dog", "offset": 60, "k": 10}, {"query": "   "},
]
BATCH_BODIES = [
    {"queries": ["a dog", "a cat"], "k": "3"}, {"queries": ["a"], "k": 2.0},
    {"queries": []}, {"queries": "a dog"}, {"queries": {"a": 1}},
    {"queries": [1, "a", None]}, {"queries": ["a"], "k": "0"},
    {"queries": ["a"], "k": [3]}, {}, {"queries": [], "k": 99},
]


def test_http_validation_matches_jax(engines, tmp_path):
    """Status codes of both servers agree on every body; a 422 carries
    pydantic's error list in both (the same ``type`` and ``loc`` per
    entry, in order), other errors the same ``detail``."""
    jax_engine, port = engines
    server = create_server(port, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with _jax_app(jax_engine, tmp_path) as jax_base:
            for path, bodies in (("/api/search", SEARCH_BODIES),
                                 ("/api/search/batch", BATCH_BODIES)):
                for body in bodies:
                    got = _post(base, path, body)
                    want = _post(jax_base, path, body)
                    assert got[0] == want[0], (path, body, got, want)
                    if got[0] == 200:
                        continue
                    g, w = got[1]["detail"], want[1]["detail"]
                    if isinstance(w, list):
                        assert [(e["type"], e["loc"]) for e in g] == \
                            [(e["type"], e["loc"]) for e in w], (path, body)
                    else:
                        assert g == w, (path, body)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def _png_payload(seed):
    """Base64 of a PNG (``cv2.imencode``) of seeded 120 x 160 RGB pixels."""
    import cv2
    img = np.random.default_rng(seed).integers(0, 256, (120, 160, 3),
                                               dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


# /api/search queries around the image route: a PNG data URI (searched by
# the image), the same URI with its base64 cut short (incorrect padding),
# three image-shaped strings that are not image URIs or carry no image,
# and plain text; all but the first are searched as text
IMAGE_QUERIES = {
    "png": lambda: "data:image/png;base64," + _png_payload(5),
    "bad_base64": lambda: "data:image/png;base64," + _png_payload(5)[:-1],
    "no_slash": lambda: "data:image",
    "imagex": lambda: "data:imagex,abc",
    "empty_payload": lambda: "data:image/png;base64,",
    "text": lambda: "a dog on the beach",
}


@pytest.mark.parametrize("case", list(IMAGE_QUERIES))
def test_http_image_queries_match_jax(image_engines, tmp_path, case):
    """Every query of the table gets the JAX app's status code and rows
    (same frames in the same order, scores within 1e-5) from the port's
    server."""
    jax_engine, port = image_engines
    body = {"query": IMAGE_QUERIES[case](), "k": 7, "use_cache": False}
    server = create_server(port, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with _jax_app(jax_engine, tmp_path) as jax_base:
            want = _post(jax_base, "/api/search", body)
            got = _post(base, "/api/search", body)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    assert got[0] == want[0] == 200, (case, got[0], want[0])
    assert len(got[1]["results"]) == 7
    _same(got[1]["results"], want[1]["results"])


def test_search_by_image_matches_jax(image_engines):
    """The engine's image search: the port's resize, vision tower and
    vector search give the JAX engine's rows for the same seeded image."""
    jax_engine, port = image_engines
    image = np.random.default_rng(9).integers(0, 256, (180, 240, 3),
                                              dtype=np.uint8)
    got, cached = port.search_by_image_ex(image, k=10)
    want, _ = jax_engine.search_by_image_ex(image, k=10)
    assert not cached and len(got) == 10
    _same(got, want)
    assert port.search_by_image(image, k=10) == got
