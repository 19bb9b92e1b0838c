"""The HTTP API's routes (counterpart of ``_register_routes`` in
``video_quierer_tpu/api/app.py``): the same paths, status codes, error
texts and body shapes.

- system: ``GET /api`` (the API's index), ``/health``, ``/api/health``,
  ``/api/stats``, ``/metrics`` (Prometheus text), ``/api/metrics``,
  ``/api/openapi.json`` and ``/api/docs`` (``api/openapi.py``), ``POST
  /api/profiler/start|stop`` (a ``torch.profiler`` trace of the CPU and,
  on a card, CUDA activity, written as a Chrome trace into
  ``trace_dir``, with the program's spans over the trace beside it on
  the same clock; 409 when a trace runs already, or none does);
- search: ``POST /api/search`` (``{query, k=5 (1..50), use_cache=true,
  dedup_videos=false, offset=0 (0..63)}``; a ``data:image/...;base64``
  query that decodes to an image searches by that image, any other query
  as text; ``enhanced_mode`` routes text through the request coalescer;
  bounded by ``search_timeout``: 504), ``/api/search/batch``,
  ``/api/search/videos`` (whole videos), ``/api/search/vector`` (a raw
  vector), ``/api/search/similar`` (an indexed frame's neighbours),
  ``/api/search/image`` (a multipart image upload) and the legacy
  ``/search``;
- videos: ``POST /api/videos/upload`` (multipart, the file part
  streamed to disk under ``MAX_FILE_SIZE``: 413 past it; then ingested
  and the cache saved; ``?upload_id=`` keeps a progress record, read by
  ``GET /api/videos/upload/progress/{upload_id}`` and streamed as
  server-sent events by ``.../stream``), ``POST
  /api/videos/download-youtube`` (needs ``yt_dlp``), ``GET /api/videos``
  (``?limit=&offset=``), ``GET /videos``, ``GET /api/videos/{video_id}``
  (substring match), ``DELETE /api/videos/{video_id}`` (file, rows, then
  the cache saved), ``GET /videos/{filename}`` (the file), ``GET
  /api/video/{video_id}/frame?timestamp=`` (one frame as a base64 JPEG);
- ``POST /api/index/save|load?filepath=`` (contained to the videos dir or
  ``VQT_INDEX_IO_DIR``: 403 elsewhere);
- ``GET/POST /api/config``, ``POST /api/config/reset`` (``config.json``
  written);
- ``/api/cache/stats|rebuild|clear|health|warm|export|import``;
- the UI: ``GET /`` (``index.html`` of the static dir) and the files
  under ``/static``.

OpenCV (the frame preview, image queries) and ``yt_dlp`` are imported
inside the routes that use them.
"""

from __future__ import annotations

import base64
import functools
import json
import logging
import os
import re
import tempfile
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from video_quierer_tpu_torch.api import schemas
from video_quierer_tpu_torch.api.multipart import (
    MultipartReader,
    parse_multipart,
)
from video_quierer_tpu_torch.api.openapi import docs_html, openapi_spec
from video_quierer_tpu_torch.api.schemas import RequestError, parse_k
from video_quierer_tpu_torch.api.web import (
    Request,
    Response,
    Router,
    error,
    file_response,
    stream_response,
    text_response,
)
from video_quierer_tpu_torch.engine.config import ApiConfig, save_api_config
from video_quierer_tpu_torch.engine.system import (
    VIDEO_EXTENSIONS,
    VideoSearchEngine,
)
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.utils import stageprof

logger = logging.getLogger(__name__)

API_VERSION = "2.1.0"
MAX_FILE_SIZE = 1024 * 1024 * 1024  # 1 GB, read at request time
# progress records kept after completion, so that a client can read the
# final state; the oldest goes first
_MAX_UPLOAD_ENTRIES = 256
# the profiler's trace directory when the request names none
DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(), "vqt_profile")
# the static dir when the server is given none: the repo's static/
DEFAULT_STATIC_DIR = Path(__file__).resolve().parents[2] / "static"


def sanitize_filename(filename: str) -> str:
    """A client's file name without path components ("..", separators)."""
    name = Path(filename.replace("\\", "/")).name
    return name.replace("..", "_").strip(". ") or "upload"


def _frame_to_data_uri(frame_bgr: np.ndarray) -> str:
    """A BGR frame as a JPEG (quality 85) base64 data URI; "" when it
    does not encode."""
    import cv2
    ok, buf = cv2.imencode(".jpg", frame_bgr,
                           [int(cv2.IMWRITE_JPEG_QUALITY), 85])
    if not ok:
        return ""
    return "data:image/jpeg;base64," + \
        base64.b64encode(buf.tobytes()).decode()


def _all_threads():
    """A profiler config that records the CPU ops of every thread (the
    searches run on the server's request threads), where this torch has
    the option; None (the calling thread's ops) where it has not."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


class TraceRecorder:
    """One ``torch.profiler`` trace at a time: the CPU activity and, on a
    card, the CUDA activity of the whole process (every thread's kernels),
    written at :meth:`stop` as a Chrome trace into the start's directory.
    The program's spans (``utils/stageprof.py``) are on while the trace
    runs; :meth:`stop` writes those of the trace's time beside it as
    ``vqt_spans_<id>.json`` (the trace is ``vqt_trace_<id>.pt.trace.json``),
    on the trace's own time base, and puts the spans' switch back as it
    was. The profiler must start and stop on one
    thread, so a thread of its own runs both for whichever request thread
    asks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prof = None
        self._dir: Optional[Path] = None
        self._spans_were = False
        self._since_ns = 0
        self._thread = ThreadPoolExecutor(1, thread_name_prefix="profiler")

    def _on_own_thread(self, fn):
        return self._thread.submit(fn).result()

    def start(self, trace_dir: str) -> None:
        with self._lock:
            if self._prof is not None:
                raise RuntimeError("a trace is already running")
            path = Path(trace_dir)
            path.mkdir(parents=True, exist_ok=True)

            def begin():
                import torch.profiler as tp
                activities = [tp.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(tp.ProfilerActivity.CUDA)
                prof = tp.profile(activities=activities,
                                  experimental_config=_all_threads())
                prof.start()
                return prof

            self._prof, self._dir = self._on_own_thread(begin), path
            self._spans_were = stageprof.ENABLED
            self._since_ns = time.time_ns()
            stageprof.enable(True)

    def stop(self) -> Path:
        with self._lock:
            prof, self._prof = self._prof, None
            if prof is None:
                raise RuntimeError("No profile started")
            run = f"{os.getpid()}_{time.time_ns()}"
            out = self._dir / f"vqt_trace_{run}.pt.trace.json"

            def end():
                prof.stop()
                prof.export_chrome_trace(str(out))

            try:
                self._on_own_thread(end)
            finally:
                stageprof.enable(self._spans_were)
            evs, _ = stageprof.events(self._since_ns)
            stageprof.write_chrome_trace(self._dir / f"vqt_spans_{run}.json",
                                         evs, _trace_base_ns(out))
            return out


def _trace_base_ns(path: Path) -> int:
    """The ``baseTimeNanoseconds`` of a Chrome trace the profiler wrote
    (in its first lines), else 0: its times are then from the epoch."""
    with open(path, "rb") as f:
        m = re.search(rb'"baseTimeNanoseconds":\s*(\d+)', f.read(1 << 20))
    return int(m.group(1)) if m else 0


def _decode_image_query(query: str) -> Optional[np.ndarray]:
    """Decode a data:image/...;base64 query to an RGB uint8 array (a copy
    of ``video_quierer_tpu/api/app.py:_decode_image_query``): None for any
    other query, and for one that does not decode (OpenCV missing
    included), which is then searched as text."""
    if not query.startswith("data:image/"):
        return None
    try:
        import cv2
        payload = query.split(",", 1)[1]
        raw = np.frombuffer(base64.b64decode(payload), np.uint8)
        bgr = cv2.imdecode(raw, cv2.IMREAD_COLOR)
        if bgr is None:
            return None
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    except Exception:
        return None


def video_id_of(video_name: str) -> str:
    """File name → video id (the reference's rule)."""
    return video_name.replace(".mp4", "").replace(".", "_")


def _id_matches(video_name: str, video_id: str) -> bool:
    stripped = video_name
    for ext in VIDEO_EXTENSIONS:
        stripped = stripped.replace(ext, "")
    return stripped.replace(".", "_") == video_id


def _find_video_by_id(engine: VideoSearchEngine, video_id: str
                      ) -> Optional[str]:
    for name in engine.index.video_names():
        if _id_matches(name, video_id):
            return name
    return None


def _resolve_index_path(engine: VideoSearchEngine, filepath: str
                        ) -> Optional[Path]:
    """An index save/load target, contained to the videos dir or the
    directory ``VQT_INDEX_IO_DIR`` names; None elsewhere (a copy of
    ``_resolve_index_path`` in ``video_quierer_tpu/api/app.py``)."""
    roots = [engine.videos_dir.resolve()]
    extra = os.environ.get("VQT_INDEX_IO_DIR")
    if extra:
        roots.append(Path(extra).resolve())
    p = Path(filepath)
    if not p.is_absolute():
        p = engine.videos_dir / p
    p = p.resolve()
    for root in roots:
        if p == root or root in p.parents:
            return p
    return None


def _dict_body(req: Request):
    """A JSON object body; 422 "invalid JSON body" (returned) else."""
    try:
        body = req.json()
    except ValueError:
        raise RequestError(422, "invalid JSON body") from None
    if not isinstance(body, dict):
        raise RequestError(422, "invalid JSON body")
    return body


def _model_body(req: Request):
    """A body for a pydantic model; 422 "invalid JSON body" (raised)
    when it is not JSON."""
    try:
        return req.json()
    except ValueError:
        raise RequestError(422, "invalid JSON body", cors=False) from None


def _lenient_body(req: Request):
    """A JSON body, ``{}`` when it does not decode."""
    try:
        return req.json()
    except ValueError:
        return {}


def _search_reply(results, t0: float, from_cache=None) -> dict:
    out = {"results": results,
           "search_time_ms": (time.time() - t0) * 1000.0}
    if from_cache is not None:
        out["from_cache"] = from_cache
    out["query_id"] = str(uuid.uuid4())
    out["performance"] = {"results_count": len(results)}
    return out


def _bounded(fn, timeout: float):
    """``fn()`` in a worker thread, waited for ``timeout`` seconds:
    ``(done, result)``. A search past its bound runs on to its end, as
    ``asyncio.to_thread`` under ``asyncio.wait_for`` does; its error, if
    it raises in time, is raised here."""
    box = {}
    done = threading.Event()

    def run():
        try:
            box["out"] = fn()
        except Exception as e:  # handed to the waiting thread
            box["err"] = e
        finally:
            done.set()

    threading.Thread(target=run, daemon=True, name="search").start()
    if not done.wait(timeout):
        return False, None
    if "err" in box:
        raise box["err"]
    return True, box["out"]


def build_router(engine: VideoSearchEngine, config_path: Path,
                 started: float, static_dir: Optional[Path] = None
                 ) -> Router:
    router = Router()
    static_dir = Path(static_dir) if static_dir is not None \
        else DEFAULT_STATIC_DIR
    uploads: Dict[str, dict] = {}
    uploads_lock = threading.Lock()
    profiler = TraceRecorder()
    profiler_dir: Dict[str, str] = {}

    def route(method: str, path: str):
        def add(fn):
            router.add(method, path, fn)
            return fn
        return add

    # -- system ----------------------------------------------------------

    @route("GET", "/api")
    def api_root(_req):
        return {
            "name": "Video Search API (PyTorch/CUDA port)",
            "version": API_VERSION,
            "description": "Semantic video search on PyTorch/CUDA",
            "features": [
                "CLIP-powered semantic search",
                "Multiple video format support",
                "YouTube download integration",
                "Frame-level search results",
                "Configuration management",
                "Cache optimization",
                "Image queries (data URI)",
                "Similar-moment search",
                "Prometheus metrics",
            ],
            "endpoints": {
                "health": "/api/health",
                "search": "/api/search",
                "upload": "/api/videos/upload",
                "videos": "/api/videos",
                "configuration": "/api/config",
                "cache": "/api/cache/stats",
                "metrics": "/metrics",
            },
        }

    @route("GET", "/api/openapi.json")
    def openapi_json(_req):
        return openapi_spec(API_VERSION)

    @route("GET", "/api/docs")
    def api_docs(_req):
        return Response(200, docs_html(API_VERSION).encode(),
                        "text/html; charset=utf-8")

    @route("GET", "/health")
    def health(_req):
        return {"status": "healthy" if engine.ready else "starting"}

    @route("GET", "/api/health")
    def api_health(_req):
        return {
            "status": "healthy" if engine.ready else "starting",
            "timestamp": time.time(),
            "components": {
                "video_system": {
                    "status": "healthy" if engine.ready else "not_ready"},
                "index": {
                    "status": "healthy" if len(engine.index) else "empty"},
            },
        }

    @route("GET", "/api/stats")
    def api_stats(_req):
        s = engine.stats()
        return {
            "uptime_seconds": time.time() - started,
            "system_ready": engine.ready,
            "video_count": s["video_count"],
            "total_frames_indexed": s["total_frames_indexed"],
            "index_performance": {
                "embeddings_count": s["total_frames_indexed"], **s["index"]},
            "feature_extraction": {"processor_type": s["processor_type"]},
            "cache_performance": {"cache_exists": s["cache_exists"]},
            "metrics": {"total_videos": s["video_hashes_count"]},
        }

    @route("GET", "/metrics")
    def metrics_prometheus(_req):
        return text_response(engine.metrics.export_prometheus())

    @route("GET", "/api/metrics")
    def metrics_json(_req):
        return engine.metrics.snapshot()

    @route("POST", "/api/profiler/start")
    def profiler_start(req):
        trace_dir = _lenient_body(req).get("trace_dir") or DEFAULT_TRACE_DIR
        try:
            profiler.start(trace_dir)
        except Exception as e:  # the reference answers 409
            return error(409, f"profiler start failed: {e}")
        profiler_dir["dir"] = trace_dir
        return {"success": True, "trace_dir": trace_dir}

    @route("POST", "/api/profiler/stop")
    def profiler_stop(_req):
        try:
            profiler.stop()
        except Exception as e:  # the reference answers 409
            return error(409, f"profiler stop failed: {e}")
        return {"success": True, "trace_dir": profiler_dir.get("dir")}

    # -- search ----------------------------------------------------------

    @route("POST", "/api/search")
    def api_search(req):
        query, k, use_cache, dedup, offset = schemas.search_request(
            _model_body(req))
        query = query.strip()
        if not query:
            return error(400, "No query provided")
        t0 = time.time()
        if offset and offset + k > 64:
            return error(422, "offset + k must be <= 64")
        image = _decode_image_query(query)
        if image is not None:
            search = functools.partial(engine.search_by_image_ex, image, k)
        elif dedup or offset:
            search = functools.partial(engine.search_ex, query, k,
                                       use_cache, dedup, offset)
        elif engine.config.api.enhanced_mode:
            search = functools.partial(engine.search_coalesced_ex, query, k,
                                       use_cache)
        else:
            search = functools.partial(engine.search_ex, query, k,
                                       use_cache)
        # search_timeout bounds the request; until a search has been
        # counted, the bound stretches to cover the first one's one-time
        # costs
        timeout = max(1, int(engine.config.api.search_timeout))
        if not engine.metrics.histogram_stats(
                "search_latency_ms").get("count", 0):
            timeout = max(timeout, 600)
        done, out = _bounded(search, timeout)
        if not done:
            return error(504, f"Search timed out after {timeout}s")
        results, from_cache = out
        return _search_reply(results, t0, from_cache)

    @route("POST", "/api/search/batch")
    def api_search_batch(req):
        queries, k = schemas.batch_request(_model_body(req))
        batches = engine.search_batch(queries, k)
        results = [{"query": q, "results": r, "count": len(r)}
                   for q, r in zip(queries, batches)]
        return {
            "results": results,
            "query_count": len(queries),
            "total_results": sum(len(r["results"]) for r in results),
        }

    @route("POST", "/api/search/videos")
    def api_search_videos(req):
        body = _dict_body(req)
        query = str(body.get("query", "")).strip()
        k = parse_k(body)
        if not query:
            return error(400, "No query provided")
        t0 = time.time()
        return _search_reply(engine.search_videos(query, k), t0)

    @route("POST", "/api/search/vector")
    def api_search_vector(req):
        body = _dict_body(req)
        vec = body.get("vector")
        k = parse_k(body)
        dim = engine.index.dim
        if not isinstance(vec, list) or len(vec) != dim:
            return error(422, f"vector must be a list of {dim} floats")
        try:
            vector = np.asarray(vec, np.float32)
        except (TypeError, ValueError):
            return error(422, "vector entries must be numbers")
        if not np.isfinite(vector).all():
            return error(422, "vector entries must be finite")
        t0 = time.time()
        results, from_cache = engine.search_by_vector_ex(
            vector, k, bool(body.get("use_cache", True)))
        return _search_reply(results, t0, from_cache)

    @route("POST", "/api/search/similar")
    def api_search_similar(req):
        body = _dict_body(req)
        video_name = str(body.get("video_name", "")).strip()
        if not video_name:
            return error(400, "No video_name provided")
        k = parse_k(body)
        try:
            timestamp = float(body.get("timestamp", 0.0))
        except (TypeError, ValueError):
            return error(422, "timestamp must be a number")
        t0 = time.time()
        try:
            results, from_cache = engine.search_similar_ex(
                video_name, timestamp, k, bool(body.get("use_cache", True)))
        except KeyError:
            return error(404, f"Video not found in index: {video_name}")
        return _search_reply(results, t0, from_cache)

    @route("POST", "/api/search/image")
    def api_search_image(req):
        parts = parse_multipart(req.body, req.headers.get("Content-Type"))
        k, image = 5, None
        for part in parts:
            if part.name == "k":
                try:
                    k = int(part.text().strip())
                except ValueError:
                    return error(422, "k must be an integer")
            elif part.name == "file":
                import cv2
                bgr = cv2.imdecode(np.frombuffer(part.data, np.uint8),
                                   cv2.IMREAD_COLOR)
                if bgr is None:
                    return error(400, "could not decode image")
                image = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if image is None:
            return error(400, "No image file provided")
        if not 1 <= k <= 50:
            return error(422, "k must be in [1, 50]")
        t0 = time.time()
        results, from_cache = engine.search_by_image_ex(image, k)
        return _search_reply(results, t0, from_cache)

    @route("POST", "/search")
    def search_legacy(req):
        body = _lenient_body(req)
        query = str(body.get("query", ""))
        k = int(body.get("k", 5))
        if not query.strip():
            return error(400, "No query provided")
        t0 = time.time()
        results = engine.search(query, k, bool(body.get("use_cache", True)))
        return {"success": True, "results": results,
                "search_time": time.time() - t0, "query": query}

    # -- videos ----------------------------------------------------------

    def progress_entry(req: Request) -> Optional[dict]:
        """A progress record, registered when the client passed
        ``?upload_id=``."""
        upload_id = req.query.get("upload_id")
        if not upload_id:
            return None
        entry = {
            "upload_id": upload_id,
            "phase": "receiving",
            "bytes_received": 0,
            "total_bytes": req.content_length,
            "frames_indexed": None,
            "error": None,
            "done": False,
            "updated_at": time.time(),
        }
        with uploads_lock:
            while len(uploads) >= _MAX_UPLOAD_ENTRIES:
                uploads.pop(next(iter(uploads)))
            uploads[upload_id] = entry
        return entry

    def progress(entry: Optional[dict], **kw) -> None:
        if entry is not None:
            entry.update(kw, updated_at=time.time())

    @route("POST", "/api/videos/upload")
    def upload_video(req):
        reader = MultipartReader(req.read, req.headers.get("Content-Type"))
        video_id = None
        tmp_path: Optional[Path] = None
        saved_path: Optional[Path] = None
        filename = None
        prog = progress_entry(req)

        def reject(msg: str):
            progress(prog, phase="error", done=True, error=msg)
            return error(400, msg)

        def remove_partial():
            for p in (tmp_path, saved_path):
                if p is not None and p.exists():
                    p.unlink()

        try:
            # the file goes to a temporary name first: the video_id part
            # may come before or after the file part
            for part in reader:
                if part.name == "video_id":
                    video_id = sanitize_filename(part.text().strip()) \
                        or None
                elif part.name == "file":
                    filename = part.filename
                    if not filename:
                        return reject("No file provided")
                    filename = sanitize_filename(filename)
                    ext = Path(filename).suffix.lower()
                    if ext not in VIDEO_EXTENSIONS:
                        return reject(f"Unsupported file type: {ext}")
                    tmp_path = engine.videos_dir / \
                        f".upload_{uuid.uuid4().hex}{ext}"
                    size = 0
                    with open(tmp_path, "wb") as f:
                        while True:
                            chunk = part.read_chunk(1 << 20)
                            if not chunk:
                                break
                            size += len(chunk)
                            progress(prog, bytes_received=size)
                            if size > MAX_FILE_SIZE:
                                # raised, as the reference's: no CORS
                                raise RequestError(
                                    413, "File too large (max 1GB)",
                                    cors=False)
                            f.write(chunk)
            if tmp_path is None:
                return reject("No file provided")
            video_id = video_id or str(uuid.uuid4())
            saved_path = engine.videos_dir / f"{video_id}_{filename}"
            tmp_path.replace(saved_path)
            tmp_path = None
            t0 = time.time()
            progress(prog, phase="processing")
            frames = engine.process_video(saved_path)
            progress(prog, phase="saving", frames_indexed=frames)
            engine.save()
            dt = time.time() - t0
            progress(prog, phase="done", done=True)
            return {
                "video_id": video_id,
                "status": "success",
                "frames_indexed": frames,
                "processing_time": dt,
                "performance": {
                    "frames_per_second": frames / dt if dt > 0 else 0},
            }
        except RequestError as e:
            progress(prog, phase="error", done=True,
                     error=json.dumps({"detail": e.detail}))
            remove_partial()
            raise
        except Exception as e:  # the reference answers 500
            logger.exception("Upload failed")
            progress(prog, phase="error", done=True, error=str(e))
            remove_partial()
            return error(500, f"Upload failed: {e}")

    @route("GET", "/api/videos/upload/progress/{upload_id}")
    def upload_progress(req):
        entry = uploads.get(req.params["upload_id"])
        if entry is None:
            return error(404, "Unknown upload_id")
        return dict(entry)

    @route("GET", "/api/videos/upload/progress/{upload_id}/stream")
    def upload_progress_stream(req):
        """Server-sent events: one ``progress`` event per change of the
        record until the upload is done or fails; an id not registered
        within a 10 s grace window gets one ``error`` event."""
        upload_id = req.params["upload_id"]

        def events():
            last = None
            deadline = time.time() + 600
            grace = time.time() + 10
            while time.time() < deadline:
                entry = uploads.get(upload_id)
                if entry is None:
                    if time.time() < grace:
                        time.sleep(0.1)
                        continue
                    yield (b"event: error\n"
                           b"data: {\"detail\": \"Unknown upload_id\"}\n\n")
                    break
                snap = json.dumps(entry, default=str)
                if snap != last:
                    last = snap
                    yield f"event: progress\ndata: {snap}\n\n".encode()
                if entry.get("done"):
                    break
                time.sleep(0.15)

        return stream_response(events(), "text/event-stream",
                               (("Cache-Control", "no-cache"),), cors=False)

    @route("POST", "/api/videos/download-youtube")
    def download_youtube(req):
        body = _lenient_body(req)
        url = str(body.get("url", "")).strip()
        quality = body.get("quality", "best")
        overrides = body.get("config", {}) or {}
        if not url:
            return error(400, "No URL provided")
        if "youtube.com/watch" not in url and "youtu.be/" not in url:
            return error(400, "Invalid YouTube URL")
        try:
            import yt_dlp  # noqa: F401
        except ImportError:
            return error(500, "yt-dlp not installed. "
                         "Install with: pip install yt-dlp")
        video_id = str(uuid.uuid4())
        t0 = time.time()
        try:
            fmt = {
                "best": "best[ext=mp4]/best",
                "720p": "best[height<=720][ext=mp4]/best[height<=720]",
                "480p": "best[height<=480][ext=mp4]/best[height<=480]",
                "360p": "best[height<=360][ext=mp4]/best[height<=360]",
                "worst": "worst[ext=mp4]/worst",
            }.get(quality, "best[ext=mp4]/best")
            opts = {
                "format": fmt,
                "outtmpl": str(engine.videos_dir /
                               f"{video_id}_%(title)s.%(ext)s"),
                "restrictfilenames": True,
                "no_warnings": True,
            }
            with yt_dlp.YoutubeDL(opts) as ydl:
                info = ydl.extract_info(url, download=False)
                title = info.get("title", "Unknown")
                ydl.download([url])
            files = list(engine.videos_dir.glob(f"{video_id}_*"))
            if not files:
                return error(500, "Download completed but file not found")
            video_path = files[0]
            cfg = None
            if overrides:
                cfg = schemas.api_config_request(
                    {**engine.config.api.model_dump(), **overrides})
            frames = engine.process_video(video_path, cfg)
            engine.save()
            dt = time.time() - t0
            return {
                "video_id": video_id,
                "status": "success",
                "title": title,
                "filename": video_path.name,
                "frames_indexed": frames,
                "processing_time": dt,
                "quality": quality,
                "url": url,
                "performance": {
                    "frames_per_second": frames / dt if dt > 0 else 0},
            }
        except Exception as e:  # the reference answers 500
            for f in engine.videos_dir.glob(f"{video_id}_*"):
                f.unlink()
            return error(500, f"YouTube download failed: {e}")

    @route("GET", "/api/videos")
    def list_videos(req):
        try:
            limit = int(req.query.get("limit", 100))
            offset = int(req.query.get("offset", 0))
        except ValueError:
            return error(400, "limit/offset must be integers")
        if limit > 1000:
            return error(400, "Limit too large (max 1000)")
        videos = []
        for name, count in engine.index.video_frame_counts().items():
            path = engine.videos_dir / name
            videos.append({
                "filename": name,
                "video_id": video_id_of(name),
                "frame_count": count,
                "size": path.stat().st_size if path.exists() else 0,
                "processed_at": time.time(),
            })
        videos = videos[offset: offset + limit]
        return {"videos": videos, "count": len(videos), "limit": limit,
                "offset": offset}

    @route("GET", "/videos")
    def list_videos_legacy(_req):
        out = []
        for name in engine.index.video_names():
            path = engine.videos_dir / name
            out.append({
                "name": name,
                "size": path.stat().st_size if path.exists() else 0,
                "modified": path.stat().st_mtime if path.exists() else 0,
            })
        return {"videos": out}

    @route("GET", "/api/videos/{video_id}")
    def video_info(req):
        video_id = req.params["video_id"]
        for name, count in engine.index.video_frame_counts().items():
            if video_id in name:             # substring, as the reference
                return {"video_id": video_id, "filename": name,
                        "exists": (engine.videos_dir / name).exists(),
                        "frame_count": count}
        return error(404, "Video not found")

    @route("DELETE", "/api/videos/{video_id}")
    def delete_video(req):
        video_id = req.params["video_id"]
        name = _find_video_by_id(engine, video_id)
        if name is None:
            matches = list(engine.videos_dir.glob(f"*{video_id}*"))
            if not matches:
                return error(404, "Video not found")
            name = matches[0].name
        path = engine.videos_dir / name
        if path.exists():
            path.unlink()
        engine.remove_video(name)
        engine.save()
        return {"status": "deleted", "video_id": video_id,
                "filename": name}

    @route("GET", "/videos/{filename}")
    def serve_video(req):
        filename = req.params["filename"]
        path = engine.videos_dir / filename
        if not path.exists() or not path.is_file() \
                or path.parent != engine.videos_dir:
            return error(404, f"Video not found: {filename}")
        return file_response(path)

    @route("GET", "/api/video/{video_id}/frame")
    def video_frame(req):
        video_id = req.params["video_id"]
        try:
            timestamp = float(req.query["timestamp"])
        except (KeyError, ValueError):
            return error(422, "timestamp query parameter required")

        def failed(msg: str, name: str):
            return {"success": False, "error": msg, "frame_data": None,
                    "timestamp": timestamp, "video_name": name}

        name = _find_video_by_id(engine, video_id)
        if name is None:
            return failed("Video not found", "unknown")
        path = engine.videos_dir / name
        if not path.exists():
            return failed("Video file not found on disk", name)
        from video_quierer_tpu_torch.ingest.frames import frame_at_timestamp
        frame = frame_at_timestamp(path, timestamp)
        if frame is None:
            return failed("Failed to extract frame at timestamp", name)
        data = _frame_to_data_uri(frame)
        if not data:
            return failed("Failed to encode frame", name)
        return {"success": True, "frame_data": data, "error": None,
                "timestamp": timestamp, "video_name": name}

    # -- index persistence -----------------------------------------------

    def index_io(req, fn, verb: str, done: str):
        filepath = req.query.get("filepath")
        if not filepath:
            return error(422, "filepath query parameter required")
        target = _resolve_index_path(engine, filepath)
        if target is None:
            return error(403, "filepath outside the allowed directories")
        if not fn(target):
            return error(500, f"Failed to {verb} index")
        return {"status": done, "filepath": filepath}

    @route("POST", "/api/index/save")
    def index_save(req):
        return index_io(req, engine.save, "save", "saved")

    @route("POST", "/api/index/load")
    def index_load(req):
        return index_io(req, engine.load, "load", "loaded")

    # -- configuration ---------------------------------------------------

    @route("GET", "/api/config")
    def get_config(_req):
        return {"success": True, "config": engine.config.api.model_dump(),
                "message": "Configuration retrieved successfully"}

    @route("POST", "/api/config")
    def set_config(req):
        cfg = schemas.api_config_request(_model_body(req))
        # the loader's validation: a value it refuses (max_frames = 0)
        # would break every later ingest
        old = engine.config.api
        engine.config.api = cfg
        try:
            engine.config.validate()
        except ValueError as e:
            engine.config.api = old
            return error(422, str(e))
        ok = save_api_config(cfg, config_path)
        if cfg.log_level in ("DEBUG", "INFO", "WARNING", "ERROR"):
            logging.getLogger().setLevel(getattr(logging, cfg.log_level))
        return {"success": ok, "config": cfg.model_dump(),
                "message": "Configuration updated successfully" if ok
                else "Failed to save configuration"}

    @route("POST", "/api/config/reset")
    def reset_config(_req):
        cfg = ApiConfig()
        engine.config.api = cfg
        ok = save_api_config(cfg, config_path)
        return {"success": ok, "config": cfg.model_dump(),
                "message": "Configuration reset to defaults" if ok
                else "Failed to save default configuration"}

    # -- cache -----------------------------------------------------------

    @route("GET", "/api/cache/stats")
    def cache_stats(_req):
        try:
            s = schemas.cache_stats(engine)
            last = None
            if s["last_updated"] not in ("Never", "Error"):
                last = int(time.mktime(time.strptime(
                    s["last_updated"], "%Y-%m-%d %H:%M:%S")))
            return {"success": True, "embeddings": s["embeddings_count"],
                    "videos": s["videos_count"],
                    "size": s["cache_size_mb"] * 1024 * 1024,
                    "last_updated": last,
                    "cache_file_exists": s["cache_file_exists"],
                    "video_hashes_count": s["video_hashes_count"]}
        except Exception:  # the reference answers an empty success=False
            logger.exception("cache stats failed")
            return {"success": False, "embeddings": 0, "videos": 0,
                    "size": 0, "last_updated": None,
                    "cache_file_exists": False, "video_hashes_count": 0}

    @route("POST", "/api/cache/rebuild")
    def cache_rebuild(_req):
        try:
            engine.rebuild()
        except Exception as e:  # the reference answers success=False
            logger.exception("rebuild failed")
            return schemas.cache_response(
                False, message=f"Failed to rebuild cache: {e}")
        cfg = engine.config.api
        return schemas.cache_response(
            True, schemas.cache_stats(engine),
            f"Cache rebuilt successfully with config: "
            f"max_frames={cfg.max_frames}, use_clip={cfg.use_clip}")

    @route("POST", "/api/cache/clear")
    def cache_clear(_req):
        try:
            engine.clear()
        except Exception as e:  # the reference answers success=False
            return schemas.cache_response(
                False, message=f"Failed to clear cache: {e}")
        return schemas.cache_response(True, schemas.cache_stats(engine),
                                      "Cache cleared successfully")

    @route("GET", "/api/cache/health")
    def cache_health(_req):
        return schemas.cache_health(engine)

    @route("POST", "/api/cache/warm")
    def cache_warm(req):
        body = _lenient_body(req)
        queries = body.get("queries") or []
        k = int(body.get("k", 5))
        if not isinstance(queries, list) or not queries:
            return error(400, "queries list required")
        warmed = engine.warm_cache([str(q) for q in queries], k)
        return {"success": True, "warmed": warmed}

    @route("GET", "/api/cache/export")
    def cache_export(_req):
        if not engine.cache_path.exists():
            return error(404, "Cache file not found")
        return file_response(
            engine.cache_path, content_type="application/octet-stream",
            headers=(("Content-Disposition",
                      'attachment; filename="video_search_cache_export.pkl"'
                      ),))

    @route("POST", "/api/cache/import")
    def cache_import(req):
        parts = parse_multipart(req.body, req.headers.get("Content-Type"))
        part = next((p for p in parts if p.name == "file"), None)
        if part is None:
            return error(400, "No file provided")
        if not (part.filename or "").endswith(".pkl"):
            return error(400, "Invalid file type. Must be a .pkl file")
        # load into a scratch index first (the restricted unpickler), so a
        # bad file leaves the cache and the index as they were
        tmp = engine.cache_path.with_suffix(".import_tmp")
        tmp.write_bytes(part.data)
        probe = DeviceVideoIndex(dim=engine.index.dim,
                                 device=engine.index.device)
        if not probe.load_from_disk(tmp, verify=False):
            tmp.unlink(missing_ok=True)
            return schemas.cache_response(
                False, message="Failed to import cache: invalid cache file")
        tmp.replace(engine.cache_path)
        # a checksum sidecar of an earlier save no longer matches
        Path(str(engine.cache_path) + ".sha256").unlink(missing_ok=True)
        ok = engine.load()
        return schemas.cache_response(
            ok, schemas.cache_stats(engine),
            "Cache imported successfully" if ok
            else "Failed to import cache")

    # -- UI ----------------------------------------------------------------

    @route("GET", "/")
    def ui_root(_req):
        index = static_dir / "index.html"
        if index.exists():
            return file_response(index)
        return Response(
            200, b"<h1>UI not found</h1><p>static/index.html missing.</p>",
            "text/html; charset=utf-8")

    if static_dir.exists():
        root = static_dir.resolve()

        def forbidden(_req=None):
            return text_response("403: Forbidden", 403, cors=False)

        @route("GET", "/static/{filename:path}")
        def static_file(req):
            target = (static_dir / req.params["filename"]).resolve()
            if target != root and root not in target.parents:
                return text_response("404: Not Found", 404, cors=False)
            if target.is_dir():
                return forbidden()
            if not target.is_file():     # aiohttp's FileResponse 404
                return Response(404, content_type="application/octet-stream")
            return file_response(target)

        router.add("GET", "/static", forbidden)

    return router
