"""The port's ingest and introspection routes against the JAX package's
aiohttp app, each over its own engine (``test_torch_engine_surface
.engine_pair``: the same seeded cache in two dirs, the same tiny 224 px
tower), the same request sent to both: the same status, content type,
CORS headers and body, the fields that vary by design left out (times,
``query_id``, an upload's generated ``video_id``, ``processing_time`` and
``performance``, a progress record's ``updated_at``).

- the video upload (a synthetic mp4 of 60 frames): ``video_id`` before
  and after the file part, and none; the rows both engines add (names,
  timestamps, frame ids; rows within the towers' f32 tolerance); the
  refusals (no file part, an empty file name, a wrong extension: 400), a
  body over a lowered ``MAX_FILE_SIZE`` (413, raised: no CORS; no file
  left behind), an ingest that fails (500, the error phase);
- the progress record (``?upload_id=``), its 256-entry cap (the oldest
  goes first), and its server-sent-events stream: followed from before
  the POST, replayed after it, and for an unknown id (one ``error`` event
  after the 10 s grace);
- ``download-youtube``'s validation and its "yt-dlp not installed" gate;
- the frame preview (a decoded frame as the same JPEG data URI, an
  unknown video, a missing file, a file that does not decode, 422);
- ``/api/openapi.json`` (equal apart from the title, description and
  the profiler's summary) and ``/api/docs``;
- the UI: ``/`` and ``/static`` (a file, a missing file, a directory,
  the static root, a path out of it; ``/`` without ``index.html``);
- the profiler: stop before start (409), start, start again (409), stop
  (the trace written: a Chrome trace of the CPU activity).
"""

import json
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from tests.helpers import make_synthetic_video
from tests.test_torch_engine_surface import (
    cache_file,  # noqa: F401  (a fixture)
    embedders,  # noqa: F401  (a fixture)
    engine_pair,
)
from tests.test_torch_http_surface import (
    CORS,
    multipart,
    port_server,
    same_json,
    send,
)
from tests.test_torch_slice import _jax_app
from video_quierer_tpu.api import app as jax_app
from video_quierer_tpu_torch.api import routes

VARY = {"search_time_ms", "search_time", "query_id", "processed_at",
        "uptime_seconds", "last_updated", "modified", "url",
        "processing_time", "performance", "updated_at"}
ROW_TOL = 2e-4
FRAMES = 60


def strip(value, drop=frozenset()):
    if isinstance(value, dict):
        return {k: strip(v, drop) for k, v in value.items()
                if k not in VARY | drop}
    if isinstance(value, list):
        return [strip(v, drop) for v in value]
    return value


def same(got, want, what, drop=frozenset()):
    """Status, content type, CORS and body (JSON without the fields that
    vary) agree."""
    (gs, gh, gb), (ws, wh, wb) = got, want
    assert gs == ws, (what, gs, ws, gb[:300], wb[:300])
    assert gh.get("Content-Type") == wh.get("Content-Type"), what
    assert (CORS in gh) == (CORS in wh), what
    if (wh.get("Content-Type") or "").startswith("application/json"):
        same_json(strip(json.loads(gb), drop), strip(json.loads(wb), drop),
                  str(what))
    else:
        assert gb == wb, what


@pytest.fixture(scope="module")
def static_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("static")
    (d / "index.html").write_text("<html><body>ui</body></html>")
    (d / "app.js").write_text("console.log(1);")
    (d / "css").mkdir()
    (d / "css" / "site.css").write_text("body{}")
    return d


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "clip.mp4"
    make_synthetic_video(path, n_frames=FRAMES, size=(96, 72), seed=3)
    return path


@pytest.fixture(scope="module")
def servers(tmp_path_factory, cache_file, embedders,  # noqa: F811
            static_dir):
    root = tmp_path_factory.mktemp("upload")
    jax_engine, port = engine_pair(root, cache_file, embedders)
    for engine in (jax_engine, port):
        (engine.videos_dir / "v1.mp4").write_bytes(b"not a video")
    with _jax_app(jax_engine, static_dir) as jax_base, \
            port_server(port, root / "port_cfg.json",
                        static_dir) as port_base:
        yield (jax_base, jax_engine), (port_base, port)
    port.close()


def both(servers, method, path, body=None, headers=None, drop=frozenset()):
    (jax_base, _), (port_base, _) = servers
    want = send(jax_base, method, path, body, headers)
    got = send(port_base, method, path, body, headers)
    same(got, want, (method, path), drop)
    return got, want


def upload_parts(video: Path, order: str, name: str = "clip.mp4"):
    file_part = ("file", name, video.read_bytes())
    if order == "first":
        return [("video_id", None, b"vid_first"), file_part]
    if order == "last":
        return [file_part, ("video_id", None, b"vid_last")]
    return [file_part]


def rows_of(engine, name):
    idx = engine.index
    ids = [i for i in range(len(idx))
           if idx._video_names[idx._video_ids[i]] == name]
    return (np.asarray(idx._emb[ids]), np.asarray(idx._timestamps)[ids],
            np.asarray(idx._frame_ids)[ids])


@pytest.mark.parametrize("order", ["first", "last", "none"])
def test_upload_matches_jax(servers, video, order):
    (_, jax_engine), (_, port) = servers
    body, headers = multipart(upload_parts(video, order))
    got, want = both(servers, "POST",
                     f"/api/videos/upload?upload_id=u-{order}", body,
                     headers, drop={"video_id"})
    assert got[0] == 200
    out = json.loads(got[2])
    assert out["frames_indexed"] > 0 and out["status"] == "success"
    name = f"{out['video_id']}_clip.mp4"
    if order != "none":
        assert out["video_id"] == f"vid_{order}"
    jax_name = f"{json.loads(want[2])['video_id']}_clip.mp4"
    assert (port.videos_dir / name).exists()
    assert not list(port.videos_dir.glob(".upload_*"))
    g, w = rows_of(port, name), rows_of(jax_engine, jax_name)
    assert len(g[0]) == out["frames_indexed"]
    np.testing.assert_allclose(g[0], w[0], rtol=ROW_TOL, atol=ROW_TOL)
    np.testing.assert_array_equal(g[1], w[1])
    np.testing.assert_array_equal(g[2], w[2])
    assert len(port.index) == len(jax_engine.index)
    # the record: done, every byte of the file part received
    got, _ = both(servers, "GET", f"/api/videos/upload/progress/u-{order}")
    rec = json.loads(got[2])
    assert rec["phase"] == "done" and rec["done"]
    assert rec["bytes_received"] == video.stat().st_size
    assert rec["total_bytes"] == len(body)
    assert rec["frames_indexed"] == out["frames_indexed"]


REFUSALS = {
    "no_file": lambda v: [("video_id", None, b"x")],
    "empty_name": lambda v: [("file", "", v.read_bytes())],
    "bad_ext": lambda v: [("file", "clip.txt", v.read_bytes())],
    "no_ext": lambda v: [("file", "clip", b"abc")],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_upload_refusals_match_jax(servers, video, case):
    body, headers = multipart(REFUSALS[case](video))
    got, _ = both(servers, "POST", f"/api/videos/upload?upload_id=r-{case}",
                  body, headers)
    assert got[0] == 400
    got, _ = both(servers, "GET", f"/api/videos/upload/progress/r-{case}")
    rec = json.loads(got[2])
    assert rec["phase"] == "error" and rec["done"] and rec["error"]


def test_upload_too_large_matches_jax(servers, video, monkeypatch):
    """Past a lowered cap: 413 (raised in both: no CORS), the record's
    error phase, and no partial file left in either dir."""
    (_, jax_engine), (_, port) = servers
    cap = video.stat().st_size // 3
    monkeypatch.setattr(jax_app, "MAX_FILE_SIZE", cap)
    monkeypatch.setattr(routes, "MAX_FILE_SIZE", cap)
    rows = len(port.index)
    body, headers = multipart(upload_parts(video, "first", "big.mp4"))
    got, _ = both(servers, "POST", "/api/videos/upload?upload_id=big",
                  body, headers)
    assert got[0] == 413 and CORS not in got[1]
    assert json.loads(got[2]) == {"detail": "File too large (max 1GB)"}
    got, _ = both(servers, "GET", "/api/videos/upload/progress/big")
    rec = json.loads(got[2])
    assert rec["phase"] == "error" and "File too large" in rec["error"]
    for engine in (jax_engine, port):
        assert not list(engine.videos_dir.glob(".upload_*"))
        assert not list(engine.videos_dir.glob("*big.mp4"))
    assert len(port.index) == rows
    # the connection still serves: the unread rest was not parsed as a
    # request
    assert send(servers[1][0], "GET", "/health")[0] == 200


def test_upload_ingest_failure_matches_jax(servers, video, monkeypatch):
    """An ingest that raises: 500 "Upload failed: ...", the error phase,
    the saved file removed."""
    (_, jax_engine), (_, port) = servers

    def boom(*_a, **_k):
        raise RuntimeError("decoder exploded")

    for engine in (jax_engine, port):
        monkeypatch.setattr(engine, "process_video", boom)
    body, headers = multipart(upload_parts(video, "first", "bad.mp4"))
    got, _ = both(servers, "POST", "/api/videos/upload?upload_id=boom",
                  body, headers)
    assert got[0] == 500
    assert json.loads(got[2]) == {"detail": "Upload failed: decoder exploded"}
    got, _ = both(servers, "GET", "/api/videos/upload/progress/boom")
    assert json.loads(got[2])["error"] == "decoder exploded"
    for engine in (jax_engine, port):
        assert not list(engine.videos_dir.glob("*bad.mp4"))


def test_progress_table_keeps_256_entries(servers):
    """Registered records past 256 push the oldest out, in both."""
    (jax_base, _), (port_base, _) = servers
    body, headers = multipart([("video_id", None, b"x")])
    for i in range(258):
        for base in (jax_base, port_base):
            assert send(base, "POST", f"/api/videos/upload?upload_id=cap{i}",
                        body, headers)[0] == 400
    for i, status in ((0, 404), (1, 404), (2, 200), (257, 200)):
        got, _ = both(servers, "GET", f"/api/videos/upload/progress/cap{i}")
        assert got[0] == status


def events(raw: bytes):
    """A text/event-stream body as ``[(event, data)]``."""
    out = []
    for block in raw.decode().split("\n\n"):
        if block:
            lines = dict(line.split(": ", 1) for line in block.split("\n"))
            out.append((lines["event"], json.loads(lines["data"])))
    return out


def test_progress_stream_replays_a_finished_upload(servers, video):
    body, headers = multipart(upload_parts(video, "first", "replay.mp4"))
    both(servers, "POST", "/api/videos/upload?upload_id=replay", body,
         headers)
    (jax_base, _), (port_base, _) = servers
    path = "/api/videos/upload/progress/replay/stream"
    got, want = send(port_base, "GET", path), send(jax_base, "GET", path)
    assert got[0] == want[0] == 200
    assert got[1].get("Content-Type") == want[1].get("Content-Type") \
        == "text/event-stream"
    assert got[1].get("Cache-Control") == want[1].get("Cache-Control")
    assert (CORS in got[1]) == (CORS in want[1])
    g, w = events(got[2]), events(want[2])
    assert [e for e, _ in g] == [e for e, _ in w] == ["progress"]
    same_json(strip(g[0][1]), strip(w[0][1]))
    assert g[0][1]["phase"] == "done"


def test_progress_stream_follows_an_upload(servers, video):
    """The stream opened before the POST: events in order, ending at
    "done", the last one equal to the JAX app's."""
    body, headers = multipart(upload_parts(video, "first", "follow.mp4"))
    last = []
    for base, _ in servers:
        with ThreadPoolExecutor(1) as pool:
            stream = pool.submit(
                send, base, "GET",
                "/api/videos/upload/progress/follow/stream")
            time.sleep(0.3)
            assert send(base, "POST", "/api/videos/upload?upload_id=follow",
                        body, headers)[0] == 200
            status, _, raw = stream.result(60)
        assert status == 200
        evs = events(raw)
        phases = [d["phase"] for _, d in evs]
        assert phases[-1] == "done" and set(phases) <= {
            "receiving", "processing", "saving", "done"}
        last.append(evs[-1][1])
    same_json(strip(last[1]), strip(last[0]))


def test_progress_stream_of_an_unknown_id(servers):
    """No record within the 10 s grace: one ``error`` event, then the
    end."""
    path = "/api/videos/upload/progress/never-registered/stream"
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(send, base, "GET", path) for base, _ in servers]
        want, got = (f.result(60) for f in futs)
    assert got[0] == want[0] == 200
    assert got[2] == want[2] == \
        b'event: error\ndata: {"detail": "Unknown upload_id"}\n\n'
    assert got[1].get("Content-Type") == want[1].get("Content-Type")


YOUTUBE = [b"junk", {}, {"url": "  "}, {"url": "https://example.com/v"},
           {"url": "https://www.youtube.com/watch?v=abc"},
           {"url": "https://youtu.be/abc", "quality": "480p"}]


@pytest.mark.parametrize("body", YOUTUBE, ids=range(len(YOUTUBE)))
def test_download_youtube_matches_jax(servers, body):
    """Validation, and the 500 of the missing ``yt_dlp`` (not installed
    here: the download itself is not run)."""
    got, _ = both(servers, "POST", "/api/videos/download-youtube", body)
    assert got[0] in (400, 500)


def test_frame_preview_matches_jax(servers, video):
    body, headers = multipart(upload_parts(video, "first", "frame.mp4"))
    both(servers, "POST", "/api/videos/upload", body, headers)
    for path in ("/api/video/vid_first_frame/frame?timestamp=0.5",
                 "/api/video/vid_first_frame/frame?timestamp=1.9",
                 "/api/video/vid_first_frame/frame?timestamp=99",
                 "/api/video/zz/frame?timestamp=1",
                 "/api/video/v2/frame?timestamp=1",
                 "/api/video/v1/frame?timestamp=1",
                 "/api/video/v2/frame",
                 "/api/video/v2/frame?timestamp=abc"):
        got, _ = both(servers, "GET", path)
    got, _ = both(servers, "GET",
                  "/api/video/vid_first_frame/frame?timestamp=0.5")
    out = json.loads(got[2])
    assert out["success"] and out["frame_data"].startswith(
        "data:image/jpeg;base64,")


def _spec_without_names(raw: bytes) -> dict:
    spec = json.loads(raw)
    spec.pop("info")
    spec["paths"]["/api/profiler/start"]["post"].pop("summary")
    return spec


def test_openapi_and_docs_match_jax(servers):
    (jax_base, _), (port_base, _) = servers
    got, want = (send(b, "GET", "/api/openapi.json")
                 for b in (port_base, jax_base))
    assert got[0] == want[0] == 200
    assert got[1].get("Content-Type") == want[1].get("Content-Type")
    assert (CORS in got[1]) and (CORS in want[1])
    assert _spec_without_names(got[2]) == _spec_without_names(want[2])
    info = json.loads(got[2])["info"]
    assert info["version"] == json.loads(want[2])["info"]["version"]
    got, want = (send(b, "GET", "/api/docs") for b in (port_base, jax_base))
    assert got[0] == want[0] == 200
    assert got[1].get("Content-Type") == want[1].get("Content-Type") \
        == "text/html; charset=utf-8"
    assert (CORS in got[1]) and (CORS in want[1])
    assert got[2] == want[2].replace(b"jax.profiler", b"torch.profiler")


UI = ["/", "/static/index.html", "/static/app.js", "/static/css/site.css",
      "/static/nope.js", "/static/css", "/static/", "/static",
      "/static/%2E%2E/secret.txt"]


@pytest.mark.parametrize("path", UI)
def test_ui_matches_jax(servers, path):
    got, want = both(servers, "GET", path)
    assert got[1].get("Accept-Ranges") == want[1].get("Accept-Ranges")


def test_ui_without_index_matches_jax(tmp_path, servers):
    """A static dir without ``index.html``: ``/`` answers the reference's
    "UI not found" page."""
    (_, jax_engine), (_, port) = servers
    (tmp_path / "other.txt").write_text("x")
    with _jax_app(jax_engine, tmp_path) as jax_base, \
            port_server(port, tmp_path / "cfg.json", tmp_path) as port_base:
        for path in ("/", "/static/other.txt"):
            same(send(port_base, "GET", path), send(jax_base, "GET", path),
                 path)


def test_profiler_matches_jax(servers, tmp_path):
    trace_dir = str(tmp_path / "trace")
    got, want = both(servers, "POST", "/api/profiler/stop", b"")
    assert got[0] == 409 and json.loads(got[2]) == {
        "detail": "profiler stop failed: No profile started"}
    got, _ = both(servers, "POST", "/api/profiler/start",
                  {"trace_dir": trace_dir})
    assert json.loads(got[2]) == {"success": True, "trace_dir": trace_dir}
    (jax_base, _), (port_base, _) = servers
    got, want = (send(b, "POST", "/api/profiler/start",
                      {"trace_dir": trace_dir})
                 for b in (port_base, jax_base))
    assert got[0] == want[0] == 409
    for g in (got, want):
        assert json.loads(g[2])["detail"].startswith(
            "profiler start failed: ")
    assert send(port_base, "POST", "/api/search",
                {"query": "a dog", "k": 3})[0] == 200
    got, _ = both(servers, "POST", "/api/profiler/stop", b"")
    assert json.loads(got[2]) == {"success": True, "trace_dir": trace_dir}
    traces = list(Path(trace_dir).glob("vqt_trace_*.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    assert trace["traceEvents"]
    got, _ = both(servers, "POST", "/api/profiler/stop", b"")
    assert got[0] == 409
    shutil.rmtree(trace_dir)


@pytest.mark.parametrize("method,path", [("GET", "/health"),
                                         ("POST", "/api/profiler/stop"),
                                         ("POST", "/api/videos/upload")])
def test_unread_body_is_not_parsed_as_a_request(servers, method, path):
    """A body the route answers without reading (or reads only in part)
    is drained: the next request on the keep-alive connection is answered
    as itself, not as the body's bytes."""
    import http.client
    port = int(servers[1][0].rsplit(":", 1)[1])
    smuggled = b"GET /nope HTTP/1.1\r\nHost: x\r\n\r\n" * 4
    body, headers = multipart([("video_id", None, smuggled)])
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers)
        first = conn.getresponse()
        first.read()
        conn.request("GET", "/api/health")
        second = conn.getresponse()
        assert second.status == 200
        assert json.loads(second.read())["status"] == "healthy"
    finally:
        conn.close()
