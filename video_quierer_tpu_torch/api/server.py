"""HTTP API on the standard library (counterpart of
``video_quierer_tpu/api/app.py``).

``http.server.ThreadingHTTPServer``, one thread per request (an open
server-sent-events stream holds its thread until it ends). The routes,
their status codes and bodies are the reference's (``api/routes.py``);
the plumbing (routing, CORS, file and multipart bodies) is
``api/web.py``'s.
"""

from __future__ import annotations

import time
from http.server import ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from video_quierer_tpu_torch.api.routes import build_router
from video_quierer_tpu_torch.api.web import make_handler
from video_quierer_tpu_torch.engine.system import VideoSearchEngine


class SearchServer(ThreadingHTTPServer):
    daemon_threads = True
    # concurrent clients are the point of the coalescer: the stdlib's
    # default listen backlog of 5 resets bursts of connections
    request_queue_size = 1024


def create_server(engine: VideoSearchEngine, host: str = "0.0.0.0",
                  port: int = 5001,
                  config_path: Path = Path("config.json"),
                  static_dir: Optional[Path] = None) -> SearchServer:
    """A bound (not yet serving) server over ``engine``; ``port=0`` picks a
    free port (``server.server_address[1]``). ``config_path`` is the file
    ``POST /api/config`` and ``/api/config/reset`` write; ``static_dir``
    the UI's files (``/`` and ``/static``; default: the repo's
    ``static/``)."""
    router = build_router(engine, Path(config_path), time.time(),
                          static_dir)
    return SearchServer((host, port), make_handler(router))

