"""HTTP search API on the standard library (counterpart of the search
routes of ``video_quierer_tpu/api/app.py``).

``http.server.ThreadingHTTPServer`` with JSON bodies, one thread per
request. Routes, status codes and response shapes are the reference's:

- ``GET /health``, ``GET /api/health``, ``GET /api/stats``;
- ``POST /api/search`` — ``{query, k=5 (1..50), use_cache=true,
  dedup_videos=false, offset=0 (0..63)}``; 400 on an empty query, 422 on
  an invalid body or ``offset + k > 64``; a ``data:image/...;base64``
  query that decodes to an image searches by that image
  (``search_by_image_ex``), any other query as text; ``enhanced_mode``
  routes text through the request coalescer;
- ``POST /api/search/batch`` — ``{queries (>= 1), k=5 (1..50)}``.

Request fields take pydantic v2's lax coercion (``"5"`` and ``5.0`` are
the int 5, ``"true"`` and ``1`` are True; ``engine/config.py:lax_int``),
and a refused body answers 422 with pydantic's error list as ``detail``
(``type``, ``loc``, ``msg``, ``input``, ``ctx``), as the reference's.

The image search route, uploads, config, cache and video routes are
later ports (404). The reference bounds a search by ``search_timeout``;
this server does not yet.
"""

from __future__ import annotations

import base64
import json
import logging
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from video_quierer_tpu_torch.engine.config import LAX, FieldError
from video_quierer_tpu_torch.engine.system import VideoSearchEngine

logger = logging.getLogger(__name__)


class RequestError(Exception):
    def __init__(self, status: int, detail: Any):
        super().__init__(detail)
        self.status = status
        self.detail = detail


# request schemas: (field, lax type, default (_REQUIRED: none), ge, le) in
# the order of the reference's pydantic models (api/schemas.py)
_REQUIRED = object()
_SEARCH = (("query", "str", _REQUIRED, None, None),
           ("k", "int", 5, 1, 50),
           ("use_cache", "bool", True, None, None),
           ("dedup_videos", "bool", False, None, None),
           ("offset", "int", 0, 0, 63))
_BATCH_K = ("k", "int", 5, 1, 50)


def _error(type_: str, loc: list, msg: str, value, ctx=None) -> Dict:
    """One entry of pydantic's error list."""
    err = {"type": type_, "loc": loc, "msg": msg, "input": value}
    if ctx is not None:
        err["ctx"] = ctx
    return err


def _field(body: Dict, spec, errors: List[Dict]):
    """One field of a request body, coerced as pydantic's lax mode; a
    refusal is appended to ``errors`` (and gives None)."""
    name, typ, default, lo, hi = spec
    if name not in body:
        if default is _REQUIRED:
            errors.append(_error("missing", [name], "Field required", body))
        return default
    value = body[name]
    try:
        value = LAX[typ](value)
    except FieldError as e:
        errors.append(_error(e.type, [name], e.msg, value))
        return None
    if lo is not None and value < lo:
        errors.append(_error(
            "greater_than_equal", [name],
            f"Input should be greater than or equal to {lo}", value,
            {"ge": lo}))
    elif hi is not None and value > hi:
        errors.append(_error(
            "less_than_equal", [name],
            f"Input should be less than or equal to {hi}", value,
            {"le": hi}))
    return value


def _queries(body: Dict, errors: List[Dict]) -> Optional[List[str]]:
    """``queries``: a non-empty list of str (``List[str]``,
    ``min_length=1``)."""
    if "queries" not in body:
        errors.append(_error("missing", ["queries"], "Field required", body))
        return None
    value = body["queries"]
    if not isinstance(value, list):
        errors.append(_error("list_type", ["queries"],
                             "Input should be a valid list", value))
        return None
    before = len(errors)
    for i, q in enumerate(value):
        if not isinstance(q, str):
            errors.append(_error("string_type", ["queries", i],
                                 "Input should be a valid string", q))
    if len(errors) == before and not value:
        errors.append(_error(
            "too_short", ["queries"], "List should have at least 1 item "
            "after validation, not 0", value,
            {"field_type": "List", "min_length": 1, "actual_length": 0}))
    return value


def _search_request(body: Dict) -> Tuple[str, int, bool, bool, int]:
    """``SearchRequest``'s fields; 422 with pydantic's error list."""
    errors: List[Dict] = []
    values = tuple(_field(body, spec, errors) for spec in _SEARCH)
    if errors:
        raise RequestError(422, errors)
    return values


def _batch_request(body: Dict) -> Tuple[List[str], int]:
    """``BatchSearchRequest``'s fields; 422 with pydantic's error list."""
    errors: List[Dict] = []
    queries = _queries(body, errors)
    k = _field(body, _BATCH_K, errors)
    if errors:
        raise RequestError(422, errors)
    return queries, k


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


def make_handler(engine: VideoSearchEngine, started: float):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # route through logging
            logger.debug("%s - " + fmt, self.address_string(), *args)

        def _send(self, status: int, payload) -> None:
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> Dict:
            n = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(n) or b"null")
            except ValueError:
                raise RequestError(422, "invalid JSON body") from None
            if not isinstance(body, dict):
                raise RequestError(422, "invalid JSON body")
            return body

        def _dispatch(self, method: str) -> None:
            fn = ROUTES.get((method, self.path.split("?", 1)[0]))
            if fn is None:
                self._send(404, {"detail": "Not Found"})
                return
            try:
                self._send(200, fn(self))
            except RequestError as e:
                self._send(e.status, {"detail": e.detail})
            except Exception:  # boundary: answer 500, keep serving
                logger.exception("%s %s failed", method, self.path)
                self._send(500, {"detail": "Internal Server Error"})

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

    def health(_h):
        return {"status": "healthy" if engine.ready else "starting"}

    def api_health(_h):
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

    def api_stats(_h):
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

    def api_search(h):
        query, k, use_cache, dedup, offset = _search_request(h._body())
        query = query.strip()
        if not query:
            raise RequestError(400, "No query provided")
        t0 = time.time()
        if offset and offset + k > 64:
            raise RequestError(422, "offset + k must be <= 64")
        image = _decode_image_query(query)
        if image is not None:
            results, from_cache = engine.search_by_image_ex(image, k)
        elif dedup or offset:
            results, from_cache = engine.search_ex(query, k, use_cache,
                                                   dedup, offset)
        elif engine.config.api.enhanced_mode:
            results, from_cache = engine.search_coalesced_ex(query, k,
                                                             use_cache)
        else:
            results, from_cache = engine.search_ex(query, k, use_cache)
        return {
            "results": results,
            "search_time_ms": (time.time() - t0) * 1000.0,
            "from_cache": from_cache,
            "query_id": str(uuid.uuid4()),
            "performance": {"results_count": len(results)},
        }

    def api_search_batch(h):
        queries, k = _batch_request(h._body())
        batches = engine.search_batch(queries, k)
        results = [{"query": q, "results": r, "count": len(r)}
                   for q, r in zip(queries, batches)]
        return {
            "results": results,
            "query_count": len(queries),
            "total_results": sum(len(r["results"]) for r in results),
        }

    ROUTES = {
        ("GET", "/health"): health,
        ("GET", "/api/health"): api_health,
        ("GET", "/api/stats"): api_stats,
        ("POST", "/api/search"): api_search,
        ("POST", "/api/search/batch"): api_search_batch,
    }
    return Handler


class SearchServer(ThreadingHTTPServer):
    daemon_threads = True
    # concurrent clients are the point of the coalescer: the stdlib's
    # default listen backlog of 5 resets bursts of connections
    request_queue_size = 1024


def create_server(engine: VideoSearchEngine, host: str = "0.0.0.0",
                  port: int = 5001) -> SearchServer:
    """A bound (not yet serving) server; ``port=0`` picks a free port
    (``server.server_address[1]``)."""
    return SearchServer((host, port), make_handler(engine, time.time()))
