"""The port's HTTP routes against the JAX package's aiohttp app, each
server over its own engine (``test_torch_engine_surface.engine_pair``:
the same seeded cache in two dirs, the same tiny tower), the same request
sent to both: the same status, content type, CORS headers and body, the
fields that vary by design left out (times, ``query_id``,
``processed_at``, the cache file's mtime, the API's name and description)
and scores within 1e-5. The table covers the system routes, the search
family (``/api/search/videos``, ``/vector``, ``/similar``, ``/image``,
the legacy ``/search``) with their refusals (a junk or fractional ``k``,
an empty query, an unknown video, a non-image upload), the video listing,
info and file routes, ``/api/index/save`` outside the videos dir (403),
the unknown path (404), a known path with another method (405) and
``OPTIONS``, and the routes the port answered 404 to until it served them
(upload, progress, frame preview, YouTube, OpenAPI and docs, profiler,
UI). Then one sequence of maintenance requests runs on both:
index save, video delete, index load, cache export (the file's bytes),
import (a bad ``.pkl`` and a wrong file type included), config set,
refused and reset, cache clear and rebuild. Last, ``search_timeout``: a
stub engine whose search sleeps answers 200 before a search is counted
(the bound stretches to 600 s) and 504 after, while the server answers
other requests.
"""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request
import uuid
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_engine_surface import (
    D,
    QUERIES,
    cache_file,  # noqa: F401  (a fixture)
    embedders,  # noqa: F401  (a fixture)
    engine_pair,
)
from tests.test_torch_slice import _jax_app
from video_quierer_tpu_torch.api.multipart import parse_multipart
from video_quierer_tpu_torch.api.server import create_server
from video_quierer_tpu_torch.engine.config import ApiConfig
from video_quierer_tpu_torch.engine.metrics import SystemMetrics
from video_quierer_tpu_torch.utils import stageprof

# times, ids, the files' mtimes, and the link to pydantic's docs in a 422
# entry (it names pydantic's version; the port has no pydantic)
VARY = {"search_time_ms", "search_time", "query_id", "processed_at",
        "uptime_seconds", "last_updated", "modified", "url"}
PLACEHOLDERS = {"v1.mp4": b"one video", "v4.mp4": b"four videos!"}
CORS = "Access-Control-Allow-Origin"


@contextlib.contextmanager
def port_server(engine, config_path, static_dir=None):
    server = create_server(engine, "127.0.0.1", 0, config_path=config_path,
                           static_dir=static_dir)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def send(base, method, path, body=None, headers=None, timeout=120):
    """``(status, headers, body bytes)``; ``body`` a dict goes as JSON."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
        headers = {"Content-Type": "application/json", **(headers or {})}
    req = urllib.request.Request(base + path, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def multipart(fields):
    """A ``multipart/form-data`` body of ``(name, filename or None,
    bytes)`` parts."""
    boundary = uuid.uuid4().hex
    out = b""
    for name, filename, data in fields:
        disp = f'form-data; name="{name}"'
        if filename is not None:
            disp += f'; filename="{filename}"'
        out += (f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
                "Content-Type: application/octet-stream\r\n\r\n").encode()
        out += data + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return out, {"Content-Type":
                 f"multipart/form-data; boundary={boundary}"}


def strip(value, top=True):
    """A JSON body without the fields that vary by design."""
    if isinstance(value, dict):
        drop = set(VARY)
        if top and "version" in value:          # /api: the server's own
            drop |= {"name", "description"}
        if top and "components" in value:       # /api/health's clock
            drop.add("timestamp")
        return {k: strip(v, False) for k, v in value.items()
                if k not in drop}
    if isinstance(value, list):
        return [strip(v, False) for v in value]
    return value


def same_json(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, abs=1e-5), path
    else:
        assert got == want, path


def same_answer(got, want, what):
    """Status, content type, CORS and Allow headers, and body agree."""
    (gs, gh, gb), (ws, wh, wb) = got, want
    assert gs == ws, (what, gs, ws, gb[:300], wb[:300])
    assert gh.get("Content-Type") == wh.get("Content-Type"), what
    assert (CORS in gh) == (CORS in wh), what
    assert gh.get("Allow") == wh.get("Allow"), what
    assert gh.get("Content-Disposition") == \
        wh.get("Content-Disposition"), what
    assert gh.get("Accept-Ranges") == wh.get("Accept-Ranges"), what
    if (wh.get("Content-Type") or "").startswith("application/json"):
        same_json(strip(json.loads(gb)), strip(json.loads(wb)), str(what))
    elif what[1] not in ("/metrics",):
        assert gb == wb, what


@pytest.fixture(scope="module")
def servers(tmp_path_factory, cache_file, embedders):  # noqa: F811
    root = tmp_path_factory.mktemp("http")
    jax_engine, port = engine_pair(root, cache_file, embedders)
    for engine in (jax_engine, port):
        for name, data in PLACEHOLDERS.items():
            (engine.videos_dir / name).write_bytes(data)
    with _jax_app(jax_engine, root) as jax_base, \
            port_server(port, root / "port_cfg.json", root) as port_base:
        yield (jax_base, jax_engine), (port_base, port)
    port.close()


def both(servers, method, path, body=None, headers=None):
    (jax_base, _), (port_base, _) = servers
    want = send(jax_base, method, path, body, headers)
    got = send(port_base, method, path, body, headers)
    same_answer(got, want, (method, path, body if not isinstance(
        body, bytes) else body[:60]))
    return got, want


def _png(seed):
    import cv2
    img = np.random.default_rng(seed).integers(0, 256, (90, 120, 3),
                                               dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _row(v, t):
    rng = np.random.default_rng(v * 1000 + t)
    return rng.standard_normal(D).astype(np.float32).tolist()


READ_ONLY = [
    ("GET", "/api", None), ("GET", "/health", None),
    ("GET", "/api/health", None), ("GET", "/api/stats", None),
    ("GET", "/metrics", None), ("GET", "/api/config", None),
    ("GET", "/api/cache/stats", None), ("GET", "/api/cache/health", None),
    ("GET", "/api/videos", None),
    ("GET", "/api/videos?limit=3&offset=2", None),
    ("GET", "/api/videos?limit=x", None),
    ("GET", "/api/videos?limit=1001", None),
    ("GET", "/api/videos?offset=-2&limit=1&limit=5", None),
    ("GET", "/api/videos/v3", None), ("GET", "/api/videos/3.mp", None),
    ("GET", "/api/videos/zz", None), ("GET", "/api/videos/upload", None),
    ("GET", "/videos", None), ("GET", "/videos/v1.mp4", None),
    ("HEAD", "/videos/v4.mp4", None), ("GET", "/videos/missing.mp4", None),
    ("GET", "/videos/%2E%2E%2Fx.pkl", None),
    ("GET", "/nope", None), ("GET", "/api/", None),
    ("POST", "/api", b"{}"), ("PUT", "/api/videos/v3", b""),
    ("DELETE", "/api/search", None), ("OPTIONS", "/api/search", None),
    ("OPTIONS", "/nope", None),
    ("POST", "/api/search/videos", {"query": QUERIES[0], "k": 5}),
    ("POST", "/api/search/videos", {"query": QUERIES[1], "k": "3"}),
    ("POST", "/api/search/videos", {"query": QUERIES[2], "k": 5.7}),
    ("POST", "/api/search/videos", {"query": QUERIES[3], "k": True}),
    ("POST", "/api/search/videos", {"query": QUERIES[3], "k": 50}),
    ("POST", "/api/search/videos", {"query": "a", "k": "5.5"}),
    ("POST", "/api/search/videos", {"query": "a", "k": None}),
    ("POST", "/api/search/videos", {"query": "a", "k": 0}),
    ("POST", "/api/search/videos", {"query": "a", "k": [3]}),
    ("POST", "/api/search/videos", {"query": "  "}),
    ("POST", "/api/search/videos", {"k": 3}),
    ("POST", "/api/search/videos", {"query": "", "k": "x"}),
    ("POST", "/api/search/videos", b"not json"),
    ("POST", "/api/search/videos", [1, 2]),
    ("POST", "/api/search/vector", {"vector": _row(1, 1), "k": 4}),
    ("POST", "/api/search/vector", {"vector": _row(2, 2), "k": "2",
                                    "use_cache": 0}),
    ("POST", "/api/search/vector", {"vector": _row(1, 1)[:5]}),
    ("POST", "/api/search/vector", {"vector": "abc"}),
    ("POST", "/api/search/vector", {"vector": ["a"] * D}),
    ("POST", "/api/search/vector", {"vector": [1.0] * D, "k": 99}),
    ("POST", "/api/search/vector", b'{"vector": [NaN' + b", 1.0" * (D - 1)
     + b"]}"),
    ("POST", "/api/search/similar", {"video_name": "v2.mp4",
                                     "timestamp": 10.1, "k": 5}),
    ("POST", "/api/search/similar", {"video_name": " v6.mp4 ", "k": 3.9}),
    ("POST", "/api/search/similar", {"video_name": "zz.mp4"}),
    ("POST", "/api/search/similar", {"video_name": ""}),
    ("POST", "/api/search/similar", {"video_name": "v2.mp4",
                                     "timestamp": "x"}),
    ("POST", "/api/search/similar", {"video_name": "v2.mp4", "k": "x"}),
    ("POST", "/search", {"query": QUERIES[0], "k": 3}),
    ("POST", "/search", {"query": QUERIES[1]}),
    ("POST", "/search", {"query": "a", "k": "x"}),
    ("POST", "/search", {"query": "  "}),
    ("POST", "/search", b"junk"),
    ("POST", "/api/search", {"query": QUERIES[2], "k": 4,
                             "use_cache": False}),
    ("POST", "/api/search", [1]),
    ("POST", "/api/search", b"{"),
    ("POST", "/api/cache/warm", {"queries": ["a", 5], "k": 2}),
    ("POST", "/api/cache/warm", {}),
    ("POST", "/api/cache/warm", {"queries": "abc"}),
    ("POST", "/api/cache/warm", {"queries": ["a"], "k": "x"}),
    ("POST", "/api/index/save", None),
    ("POST", "/api/index/save?filepath=/etc/passwd", None),
    ("POST", "/api/index/load?filepath=../x.pkl", None),
    ("POST", "/api/config", {"max_frames": "x", "use_clip": "maybe"}),
    ("POST", "/api/config", b"nope"),
    ("POST", "/api/config", {"max_frames": 0}),
    ("POST", "/api/config", {"sampling_mode": "weekly"}),
]


@pytest.mark.parametrize("method,path,body", READ_ONLY,
                         ids=[f"{m} {p}" for m, p, _ in READ_ONLY])
def test_routes_match_jax(servers, method, path, body):
    both(servers, method, path, body)


@pytest.mark.parametrize("byte_range", ["bytes=2-5", "bytes=-3",
                                        "bytes=4-", "bytes=0-99",
                                        "bytes=-0", "bytes=-99",
                                        "bytes=5-2", "bytes=50-60",
                                        "bytes=12-", "bytes=-",
                                        "bytes=0-1,3-4", "items=1-2"])
def test_file_ranges_match_jax(servers, byte_range):
    """A ``Range`` on a video file: 206 with the bytes and
    ``Content-Range`` (416 past the end; other units ignored), as
    aiohttp's ``FileResponse``."""
    got, want = both(servers, "GET", "/videos/v4.mp4",
                     headers={"Range": byte_range})
    assert got[1].get("Content-Range") == want[1].get("Content-Range")


IMAGE_FORMS = {
    "png": lambda: [("k", None, b"6"), ("file", "a.png", _png(1))],
    "png_default_k": lambda: [("file", "b.png", _png(2))],
    "not_an_image": lambda: [("file", "a.txt", b"plain text")],
    "no_file": lambda: [("k", None, b"3")],
    "junk_k": lambda: [("k", None, b"three"), ("file", "a.png", _png(1))],
    "k_out_of_range": lambda: [("file", "a.png", _png(1)),
                               ("k", None, b"0")],
}


@pytest.mark.parametrize("form", list(IMAGE_FORMS))
def test_image_upload_matches_jax(servers, form):
    body, headers = multipart(IMAGE_FORMS[form]())
    got, _ = both(servers, "POST", "/api/search/image", body, headers)
    if form.startswith("png"):
        assert got[0] == 200 and json.loads(got[2])["results"]


# the routes the port answered 404 to before its upload, profiler, docs
# and UI routes (their full parity cases: tests/test_torch_upload.py)
FORMERLY_UNPORTED = [("POST", "/api/videos/upload"),
                     ("POST", "/api/videos/download-youtube"),
                     ("GET", "/api/videos/upload/progress/x"),
                     ("GET", "/api/video/v1/frame?timestamp=1"),
                     ("GET", "/api/openapi.json"), ("GET", "/api/docs"),
                     ("POST", "/api/profiler/start"), ("GET", "/"),
                     ("GET", "/static/index.html")]


def _named_by_package(path, body):
    """The bodies that name their package: the spec's info and the
    profiler's summary, the docs' profiler."""
    if path == "/api/openapi.json":
        spec = json.loads(body)
        spec.pop("info")
        spec["paths"]["/api/profiler/start"]["post"].pop("summary")
        return spec
    return body.replace(b"jax.profiler", b"torch.profiler")


@pytest.mark.parametrize("method,path", FORMERLY_UNPORTED)
def test_formerly_unported_routes_match_jax(servers, method, path):
    """Each route answers as the JAX app does (an empty body: the upload
    fails to parse, 500; download-youtube 400; the progress of an unknown
    id 404; a placeholder video that does not decode; the spec and docs;
    a profiler trace started and stopped; no UI in the test's static
    dir)."""
    (jax_base, _), (port_base, _) = servers
    want = send(jax_base, method, path, b"")
    got = send(port_base, method, path, b"")
    if path.startswith("/api/profiler"):
        for base in (jax_base, port_base):
            assert send(base, "POST", "/api/profiler/stop", b"")[0] == 200
    assert got[0] == want[0], (got, want)
    assert got[1].get("Content-Type") == want[1].get("Content-Type")
    assert (CORS in got[1]) == (CORS in want[1])
    if path in ("/api/openapi.json", "/api/docs"):
        assert _named_by_package(path, got[2]) == \
            _named_by_package(path, want[2])
    elif (want[1].get("Content-Type") or "").startswith("application/json"):
        same_json(strip(json.loads(got[2])), strip(json.loads(want[2])))
    else:
        assert got[2] == want[2]


FLUSH_SPANS = {"lock_wait", "tokenize", "dispatch", "resolve", "format",
               "deliver"}


def test_profiler_writes_the_spans_beside_its_trace(servers, tmp_path):
    """``/api/profiler/start`` turns the program's spans on for the trace;
    ``stop`` writes those of its time beside the trace as a Chrome trace
    on the trace's time base (each coalesced flush's spans under its flush
    number, a flush's ``dispatch`` around the torch ops its thread ran)
    and puts the switch back as it was."""
    _, (port_base, port) = servers
    count = {name: port.metrics.histogram_stats(name).get("count", 0)
             for name in ("flush_latency_ms", "batch_search_latency_ms")}
    was = stageprof.ENABLED
    stageprof.enable(False)
    try:
        assert send(port_base, "POST", "/api/profiler/start",
                    {"trace_dir": str(tmp_path)})[0] == 200
        assert stageprof.ENABLED
        for query in QUERIES[:3]:
            assert port.search_coalesced(query, 5, False)
        assert send(port_base, "POST", "/api/profiler/stop", b"")[0] == 200
        assert not stageprof.ENABLED
    finally:
        stageprof.enable(was)
    # a flush's latency goes under its own name, not ``search_batch``'s
    assert port.metrics.histogram_stats("flush_latency_ms")["count"] == \
        count["flush_latency_ms"] + 3
    assert port.metrics.histogram_stats("batch_search_latency_ms").get(
        "count", 0) == count["batch_search_latency_ms"]
    trace, = tmp_path.glob("vqt_trace_*.pt.trace.json")
    spans, = tmp_path.glob("vqt_spans_*.json")
    assert spans.name[len("vqt_spans_"):-len(".json")] == \
        trace.name[len("vqt_trace_"):-len(".pt.trace.json")]
    trace, spans = (json.loads(p.read_text()) for p in (trace, spans))
    assert spans["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    flushes = {}
    for e in spans["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] >= 0
        if e["name"] in FLUSH_SPANS:
            flushes.setdefault(e["args"]["unit"], set()).add(e["name"])
    assert len(flushes) >= 3 and None not in flushes
    assert all(names == FLUSH_SPANS for names in flushes.values())
    ops = [e for e in trace["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    for d in (e for e in spans["traceEvents"] if e["name"] == "dispatch"):
        inside = [o for o in ops if o["tid"] == d["tid"]
                  and d["ts"] <= o["ts"] <= d["ts"] + d["dur"]]
        assert inside, d


def test_metrics_snapshot_matches_jax(servers):
    got, want = both(servers, "GET", "/metrics")
    assert got[2].startswith(b"# TYPE video_search_")
    got, want = (json.loads(a[2]) for a in send_both(servers,
                                                     "/api/metrics"))
    assert set(got) == set(want) == {"uptime_seconds", "counters",
                                     "gauges", "histograms"}
    assert got["gauges"] == want["gauges"]


def send_both(servers, path):
    (jax_base, _), (port_base, _) = servers
    return send(port_base, "GET", path), send(jax_base, "GET", path)


def test_maintenance_sequence_matches_jax(servers):
    """One sequence on both servers; each answer agrees, and each engine's
    state follows."""
    (jax_base, jax_engine), (port_base, port) = servers
    engines = (jax_engine, port)
    both(servers, "POST", "/api/index/save?filepath=idx.pkl")
    for e in engines:
        assert (e.videos_dir / "idx.pkl").exists()
    both(servers, "DELETE", "/api/videos/v1")
    for e in engines:
        assert not (e.videos_dir / "v1.mp4").exists()
        assert "v1.mp4" not in e.index.video_names()
    both(servers, "DELETE", "/api/videos/v1")               # 404 now
    both(servers, "GET", "/api/videos/v1.mp")
    vec = port.index.frame_embedding(0).tolist()
    got, _ = both(servers, "POST", "/api/search/vector",
                  {"vector": vec, "k": 8, "use_cache": False})
    assert "v1.mp4" not in {r["video_name"]
                            for r in json.loads(got[2])["results"]}
    both(servers, "POST", "/api/index/load?filepath=idx.pkl")
    for e in engines:
        assert "v1.mp4" in e.index.video_names()
    got, _ = both(servers, "GET", "/api/cache/export")
    exported = got[2]
    assert exported == port.cache_path.read_bytes()
    body, headers = multipart([("file", "back.pkl", exported)])
    both(servers, "POST", "/api/cache/import", body, headers)
    for bad in ([("file", "x.txt", exported)],
                [("file", "bad.pkl", b"\x80not a pickle")],
                [("other", None, b"1")]):
        body, headers = multipart(bad)
        both(servers, "POST", "/api/cache/import", body, headers)
    for e in engines:      # the exported cache: saved after the delete
        assert len(e.index) == 7 * 2048
        assert "v1.mp4" not in e.index.video_names()
        assert not e.cache_path.with_suffix(".import_tmp").exists()
    both(servers, "POST", "/api/config", {"max_frames": "120",
                                          "log_level": "WARNING",
                                          "unknown": 1})
    assert port.config.api.max_frames == 120
    assert json.loads((port.videos_dir.parent / "port_cfg.json")
                      .read_text())["max_frames"] == 120
    both(servers, "GET", "/api/config")
    both(servers, "POST", "/api/config/reset")
    assert port.config.api == ApiConfig()
    both(servers, "POST", "/api/cache/clear")
    for e in engines:
        assert len(e.index) == 0 and not e.cache_path.exists()
    both(servers, "GET", "/api/cache/stats")
    both(servers, "GET", "/api/cache/export")
    both(servers, "POST", "/api/search/videos", {"query": "a"})
    both(servers, "POST", "/api/cache/rebuild")       # no decodable video
    both(servers, "GET", "/api/cache/health")


class _StubIndex:
    dim = D

    def __len__(self):
        return 0


class _StubApi:
    search_timeout = 1
    enhanced_mode = False
    auto_save = False


class _StubEngine:
    """What ``/api/search`` reads of an engine, with a search that sleeps."""

    ready = True

    def __init__(self, sleep):
        self.sleep = sleep
        self.config = type("Cfg", (), {"api": _StubApi()})()
        self.metrics = SystemMetrics()
        self.index = _StubIndex()

    def search_ex(self, query, k=5, use_cache=True, dedup=False, offset=0):
        time.sleep(self.sleep)
        return [], False


def test_search_timeout_matches_jax(tmp_path):
    stubs = (_StubEngine(1.5), _StubEngine(1.5))
    body = {"query": "slow", "k": 1}
    with _jax_app(stubs[0], tmp_path) as jax_base, \
            port_server(stubs[1], tmp_path / "cfg.json") as port_base:
        bases = (jax_base, port_base)
        answers = [send(b, "POST", "/api/search", body) for b in bases]
        same_answer(answers[1], answers[0], "before a counted search")
        assert answers[1][0] == 200
        for stub in stubs:
            stub.metrics.observe("search_latency_ms", 1.0)
            stub.sleep = 3.0
        out = {}
        for base in bases:
            slow = threading.Thread(target=lambda b=base: out.update(
                r=send(b, "POST", "/api/search", body)))
            t0 = time.perf_counter()
            slow.start()
            time.sleep(0.2)
            status, _, health = send(base, "GET", "/health")
            assert status == 200 and time.perf_counter() - t0 < 1.0
            slow.join(30)
            out[base] = out.pop("r")
        same_answer(out[port_base], out[jax_base], "after")
        assert out[port_base][0] == 504
        assert json.loads(out[port_base][2]) == {
            "detail": "Search timed out after 1s"}


def test_multipart_parser_reads_binary_parts():
    payload = bytes(range(256)) * 4 + b"\r\n--\r\n\r\n" + bytes(7)
    body, headers = multipart([("k", None, b" 5 "),
                               ("file", "c.pkl", payload),
                               ("file", "empty.pkl", b"")])
    parts = parse_multipart(body, headers["Content-Type"])
    assert [(p.name, p.filename) for p in parts] == [
        ("k", None), ("file", "c.pkl"), ("file", "empty.pkl")]
    assert parts[0].text() == " 5 " and parts[1].data == payload
    assert parts[2].data == b""
    for bad_type in ("application/json", "multipart/form-data"):
        with pytest.raises(ValueError):
            parse_multipart(body, bad_type)
    with pytest.raises(ValueError):
        parse_multipart(body[:-10], headers["Content-Type"])


@pytest.mark.parametrize("auto_save", [True, False])
def test_entry_point_auto_saves_on_shutdown(tmp_path, monkeypatch,
                                            auto_save):
    """``python -m video_quierer_tpu_torch.api`` saves the cache on its way
    out when ``api.auto_save`` is set and the index holds rows (the
    reference's ``on_shutdown``), and only then."""
    from video_quierer_tpu_torch.api import __main__ as entry
    from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
    videos = tmp_path / "videos"
    videos.mkdir()
    idx = DeviceVideoIndex(dim=512, device="cpu")
    idx.add_batch(np.eye(4, 512, dtype=np.float32), "a.mp4",
                  [0.0, 1.0, 2.0, 3.0])
    cache = videos / "video_search_cache.pkl"
    assert idx.save_to_disk(cache, checksum=False)
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"auto_save": auto_save}))
    served = {}

    class Interrupted:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            served["engine_rows"] = len(served["engine"].index)
            raise KeyboardInterrupt

        def server_close(self):
            served["closed"] = True

    def fake_server(engine, host, port, config_path, static_dir):
        served["engine"], served["config_path"] = engine, config_path
        served["static_dir"] = static_dir
        return Interrupted()

    monkeypatch.setattr(entry, "create_server", fake_server)
    monkeypatch.chdir(tmp_path)
    entry.main(["--videos-dir", str(videos), "--device", "cpu",
                "--config", str(config)])
    assert served["engine_rows"] == 4 and served["closed"]
    assert served["config_path"] == config
    assert served["static_dir"] is None        # the repo's static/
    assert Path(str(cache) + ".sha256").exists() is auto_save
