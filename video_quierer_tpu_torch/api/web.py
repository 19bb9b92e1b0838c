"""The HTTP plumbing of the API on the standard library's
``http.server``: requests, answers, routing, with the answers of the
reference's aiohttp server (``video_quierer_tpu/api/app.py``):

- routing on exact paths, ``{name}`` segments (one path segment,
  percent-decoded) and ``{name:path}`` tails (the rest of the path, the
  static files under ``/static``), query strings (``?limit=&offset=``,
  the first value of a repeated key); an unknown path answers 404 and a
  known path asked with another method 405 (with ``Allow``), both as
  aiohttp's plain-text answers; ``HEAD`` of a ``GET`` route answers its
  headers;
- ``OPTIONS`` of any path answers an empty 200 with the CORS headers, and
  every answer a route gives carries them (``Access-Control-Allow-Origin``,
  ``-Methods`` and ``-Headers``: ``*``, the reference's middleware); the
  answers the reference raises instead (the 422s of body validation, 404,
  405, and 500 on an unhandled error, aiohttp's plain-text "Server got
  itself in trouble") carry none;
- bodies: JSON, ``text/plain`` (``/metrics``), files (``Accept-Ranges:
  bytes``, one byte range answered 206) and ``multipart/form-data`` in
  (``api/multipart.py``);
- a request body is read when a route asks for it, whole (``body``) or in
  chunks (``read``: the video upload streams up to 1 GB to disk); what a
  route leaves unread is drained before its answer goes out (for at most
  ``DRAIN_SECONDS``; past that the connection closes after the answer),
  so a keep-alive connection never parses it as the next request;
- a streamed answer (``stream_response``: server-sent events) goes out
  without ``Content-Length``, each chunk flushed as it comes, and the
  connection closes at its end (``Connection: close``).
"""

from __future__ import annotations

import email.utils
import json
import time
import logging
import mimetypes
import re
import urllib.parse
from http.server import BaseHTTPRequestHandler
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from video_quierer_tpu_torch.api.schemas import RequestError

logger = logging.getLogger(__name__)

CORS = (("Access-Control-Allow-Origin", "*"),
        ("Access-Control-Allow-Methods", "*"),
        ("Access-Control-Allow-Headers", "*"))
JSON_TYPE = "application/json; charset=utf-8"
TEXT_TYPE = "text/plain; charset=utf-8"
_RANGE = re.compile(r"bytes=(\d*)-(\d*)")
# how long an answer waits for the rest of a body its route left unread
DRAIN_SECONDS = 10.0


class Response:
    """An answer: ``status``, a bytes ``body``, a ``file`` or a ``stream``
    (an iterable of byte chunks) to send, its content type and extra
    headers."""

    def __init__(self, status: int = 200, body: bytes = b"",
                 content_type: Optional[str] = None,
                 headers: Tuple = (), file: Optional[Path] = None,
                 cors: bool = True,
                 stream: Optional[Iterable[bytes]] = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = list(headers)
        self.file = file
        self.cors = cors
        self.stream = stream


def json_response(data, status: int = 200) -> Response:
    return Response(status, json.dumps(data).encode(), JSON_TYPE)


def error(status: int, detail) -> Response:
    """The reference's returned error: ``{"detail": ...}``, with CORS."""
    return json_response({"detail": detail}, status)


def text_response(text: str, status: int = 200, cors: bool = True
                  ) -> Response:
    return Response(status, text.encode(), TEXT_TYPE, cors=cors)


def file_response(path: Path, headers: Tuple = (),
                  content_type: Optional[str] = None) -> Response:
    """A file, sent from disk (``Accept-Ranges: bytes`` and
    ``Last-Modified``, as aiohttp's ``FileResponse``); its type guessed
    from the name unless given."""
    if content_type is None:
        content_type = (mimetypes.guess_type(path.name)[0]
                        or "application/octet-stream")
    modified = email.utils.formatdate(path.stat().st_mtime, usegmt=True)
    return Response(200, content_type=content_type, file=path,
                    headers=(("Accept-Ranges", "bytes"),
                             ("Last-Modified", modified)) + tuple(headers))


def stream_response(chunks: Iterable[bytes], content_type: str,
                    headers: Tuple = (), cors: bool = True) -> Response:
    """A streamed answer: each chunk is written and flushed as the
    iterable yields it."""
    return Response(200, content_type=content_type, headers=headers,
                    cors=cors, stream=chunks)


class Request:
    """What a route sees of a request: its body is read on demand, whole
    (``body``) or in chunks (``read``)."""

    def __init__(self, handler: BaseHTTPRequestHandler, method: str,
                 params: Dict[str, str], query: Dict[str, str]):
        self.method = method
        self.params = params
        self.query = query
        self.headers = handler.headers
        length = handler.headers.get("Content-Length")
        # None without the header, as aiohttp's ``content_length``
        self.content_length = int(length) if length else None
        self._rfile = handler.rfile
        self._remaining = self.content_length or 0
        self._body: Optional[bytes] = None

    @property
    def body(self) -> bytes:
        """The body not yet read by :meth:`read`, read whole (once)."""
        if self._body is None:
            self._body = self.read(self._remaining)
        return self._body

    def read(self, n: int) -> bytes:
        """Up to ``n`` bytes more of the body; ``b""`` at its end."""
        n = min(n, self._remaining)
        if n <= 0:
            return b""
        data = self._rfile.read(n)
        self._remaining = self._remaining - len(data) if data else 0
        return data

    def drain(self, seconds: float = DRAIN_SECONDS) -> bool:
        """Read and drop the rest of the body, for at most ``seconds``;
        True when it is all read."""
        deadline = time.monotonic() + seconds
        while self._remaining and time.monotonic() < deadline:
            self.read(1 << 20)
        return not self._remaining

    def json(self):
        """The body as JSON; any decode failure raises ``ValueError``."""
        return json.loads(self.body.decode("utf-8"))


Route = Callable[[Request], object]


class Router:
    """Routes by method and path: exact paths and ``{name}`` segments."""

    def __init__(self):
        self._routes: List[Tuple[str, re.Pattern, Route]] = []

    def add(self, method: str, path: str, fn: Route) -> None:
        pattern = re.sub(r"\\{(\w+)\\}", r"(?P<\1>[^{}/]+)",
                         re.escape(path))
        pattern = re.sub(r"\\{(\w+):path\\}", r"(?P<\1>.*)", pattern)
        self._routes.append((method, re.compile(pattern + r"\Z"), fn))

    def resolve(self, method: str, path: str):
        """``(route, params)``; ``(None, allowed methods)`` when the path
        is known but not for ``method``; ``(None, None)`` when unknown."""
        allowed = set()
        for m, pattern, fn in self._routes:
            hit = pattern.match(path)
            if hit is None:
                continue
            if m == method or (method == "HEAD" and m == "GET"):
                return fn, {k: urllib.parse.unquote(v)
                            for k, v in hit.groupdict().items()}
            allowed.add(m)
            if m == "GET":
                allowed.add("HEAD")
        return None, (sorted(allowed) or None)


def make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # route through logging
            logger.debug("%s - " + fmt, self.address_string(), *args)

        def _head(self, resp: Response) -> None:
            """The status line and the answer's own and CORS headers."""
            self.send_response(resp.status)
            if resp.content_type is not None:
                self.send_header("Content-Type", resp.content_type)
            for key, value in resp.headers:
                self.send_header(key, value)
            if resp.cors:
                for key, value in CORS:
                    self.send_header(key, value)

        def _send(self, resp: Response, head_only: bool = False) -> None:
            if resp.stream is not None:
                self._send_stream(resp, head_only)
                return
            start, size = 0, len(resp.body)
            if resp.file is not None:
                size = resp.file.stat().st_size
                start, size = self._range(resp, size)
            self._head(resp)
            self.send_header("Content-Length", str(size))
            if resp.status >= 500:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            if head_only:
                return
            if resp.file is None:
                self.wfile.write(resp.body)
                return
            with open(resp.file, "rb") as f:
                f.seek(start)
                remaining = size
                while remaining:
                    chunk = f.read(min(remaining, 1 << 20))
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    remaining -= len(chunk)

        def _send_stream(self, resp: Response, head_only: bool) -> None:
            """Headers without ``Content-Length``, then each chunk flushed
            as it comes; the connection closes at the end."""
            self._head(resp)
            self.send_header("Connection", "close")
            self.close_connection = True
            self.end_headers()
            self.wfile.flush()
            if head_only:
                return
            for chunk in resp.stream:
                self.wfile.write(chunk)
                self.wfile.flush()

        def _range(self, resp: Response, size: int) -> Tuple[int, int]:
            """``(start, length)`` of the file's bytes to send. A ``Range``
            header turns the answer into a 206 of one byte range, as
            aiohttp's ``FileResponse`` reads it (``bytes=a-b``, ``a-``,
            ``-n``; the end clamped to the file); one it cannot read, or
            a range that starts past the end, into a 416."""
            raw = self.headers.get("Range")
            if resp.status != 200 or raw is None:
                return 0, size
            hit = _RANGE.fullmatch(raw)
            first, last = hit.groups() if hit else ("", "")
            if first:
                start = int(first)
                end = min(int(last), size - 1) if last else size - 1
                valid = not last or start <= int(last)
            else:          # the last n bytes (aiohttp: all of them for 0)
                n = int(last) if last else 0
                start = max(0, size - n) if n else 0
                end, valid = size - 1, bool(last)
            if not valid or start >= size:
                resp.status, resp.file = 416, None
                resp.content_type = "application/octet-stream"
                resp.headers.append(("Content-Range", f"bytes */{size}"))
                return 0, 0
            resp.status = 206
            resp.headers.append(("Content-Range",
                                 f"bytes {start}-{end}/{size}"))
            return start, end - start + 1

        def _dispatch(self, method: str) -> None:
            url = urllib.parse.urlsplit(self.path)
            if method == "OPTIONS":
                self._drain(Request(self, method, {}, {}))
                self._send(Response(200))
                return
            fn, info = router.resolve(method, url.path)
            if fn is None:
                self._drain(Request(self, method, {}, {}))
                if info is None:
                    self._send(text_response("404: Not Found", 404,
                                             cors=False))
                else:
                    resp = text_response("405: Method Not Allowed", 405,
                                         cors=False)
                    resp.headers.append(("Allow", ",".join(info)))
                    self._send(resp)
                return
            query: Dict[str, str] = {}
            for key, value in urllib.parse.parse_qsl(
                    url.query, keep_blank_values=True):
                query.setdefault(key, value)
            req = Request(self, method, info, query)
            try:
                out = fn(req)
                resp = out if isinstance(out, Response) \
                    else json_response(out)
            except RequestError as e:
                resp = json_response({"detail": e.detail}, e.status)
                resp.cors = e.cors
            except Exception:  # boundary: answer 500, keep serving
                logger.exception("%s %s failed", method, self.path)
                resp = text_response(
                    "500 Internal Server Error\n\nServer got itself in "
                    "trouble", 500, cors=False)
            self._drain(req)
            self._send(resp, head_only=method == "HEAD")

        def _drain(self, req: Request) -> None:
            """Read what the route left of the body off the connection;
            close it after the answer when that takes too long."""
            if not req.drain():
                self.close_connection = True

        def do_GET(self):
            self._dispatch("GET")

        def do_HEAD(self):
            self._dispatch("HEAD")

        def do_POST(self):
            self._dispatch("POST")

        def do_PUT(self):
            self._dispatch("PUT")

        def do_PATCH(self):
            self._dispatch("PATCH")

        def do_DELETE(self):
            self._dispatch("DELETE")

        def do_OPTIONS(self):
            self._dispatch("OPTIONS")

    return Handler
