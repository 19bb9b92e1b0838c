"""Serve the HTTP API from the port:

    python -m video_quierer_tpu_torch.api --port 5001 --videos-dir DIR

``engine.startup()`` loads the pickle cache in DIR
(``video_search_cache.pkl``), ingests the videos in DIR that are new or
changed (decoding needs OpenCV) and saves the cache; then the server
runs until interrupted, and on the way out saves the cache again when
``api.auto_save`` is set and the index holds rows. ``--config`` is the
flat ``config.json`` read at start and written by ``POST /api/config``;
``--static-dir`` the UI's files (default: the repo's ``static/``).
``--device`` defaults to ``cuda``; without a CUDA card that raises rather
than serving on the CPU.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from video_quierer_tpu_torch.api.server import create_server
from video_quierer_tpu_torch.engine.config import load_engine_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5001)
    ap.add_argument("--videos-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", type=Path, default=Path("config.json"))
    ap.add_argument("--static-dir", type=Path, default=None)
    args = ap.parse_args(argv)
    cfg = load_engine_config(args.config)
    logging.basicConfig(level=cfg.api.log_level)
    # exact f32 re-rank: no TF32 in f32 matmuls (cuDNN allows it by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine = VideoSearchEngine(videos_dir=args.videos_dir, config=cfg,
                               device=args.device)
    engine.startup()
    server = create_server(engine, args.host, args.port,
                           config_path=args.config,
                           static_dir=args.static_dir)
    log = logging.getLogger(__name__)
    log.info("serving on %s:%d", args.host, server.server_address[1])
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if engine.config.api.auto_save and len(engine.index):
            engine.save()
            log.info("auto-saved index on shutdown")
        engine.close()


if __name__ == "__main__":
    main()
