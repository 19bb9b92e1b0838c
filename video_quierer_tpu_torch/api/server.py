"""HTTP search API on the standard library (counterpart of the search
routes of ``video_quierer_tpu/api/app.py``).

``http.server.ThreadingHTTPServer`` with JSON bodies, one thread per
request. Routes, status codes and response shapes are the reference's:

- ``GET /health``, ``GET /api/health``, ``GET /api/stats``;
- ``POST /api/search`` — ``{query, k=5 (1..50), use_cache=true,
  dedup_videos=false, offset=0 (0..63)}``; 400 on an empty query, 422 on
  an invalid body or ``offset + k > 64``; ``enhanced_mode`` routes through
  the request coalescer;
- ``POST /api/search/batch`` — ``{queries (>= 1), k=5 (1..50)}``.

Image queries (``data:image`` URIs), uploads, config, cache and video
routes are later ports (501 / 404). The reference bounds a search by
``search_timeout``; this server does not yet.
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from video_quierer_tpu_torch.engine.system import VideoSearchEngine

logger = logging.getLogger(__name__)


class RequestError(Exception):
    def __init__(self, status: int, detail: Any):
        super().__init__(detail)
        self.status = status
        self.detail = detail


def _int_field(body: Dict, name: str, default: int, lo: int,
               hi: Optional[int]) -> int:
    value = body.get(name, default)
    if isinstance(value, bool) or not isinstance(value, int):
        raise RequestError(422, f"{name} must be an integer")
    if value < lo or (hi is not None and value > hi):
        raise RequestError(422, f"{name} must be in [{lo}, {hi}]")
    return value


def _bool_field(body: Dict, name: str, default: bool) -> bool:
    value = body.get(name, default)
    if not isinstance(value, bool):
        raise RequestError(422, f"{name} must be a boolean")
    return value


def _search_request(body: Dict) -> Tuple[str, int, bool, bool, int]:
    query = body.get("query")
    if not isinstance(query, str):
        raise RequestError(422, "query must be a string")
    return (query, _int_field(body, "k", 5, 1, 50),
            _bool_field(body, "use_cache", True),
            _bool_field(body, "dedup_videos", False),
            _int_field(body, "offset", 0, 0, 63))


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
        if query.startswith("data:image"):
            raise RequestError(501, "image queries are not yet ported")
        if dedup or offset:
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
        body = h._body()
        queries = body.get("queries")
        if not isinstance(queries, list) or not queries \
                or not all(isinstance(q, str) for q in queries):
            raise RequestError(422, "queries must be a non-empty list of "
                                    "strings")
        k = _int_field(body, "k", 5, 1, 50)
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
