"""Interactive search REPL over a videos dir (a copy of
``video_quierer_tpu/cli.py``, on the port's engine).

Usage:
    python -m video_quierer_tpu_torch.cli [--videos-dir videos] [-k 5]
        [--device cuda]

``engine.startup()`` loads the dir's cache and ingests what is new; then
each line read is searched, until ``quit``, ``exit``, ``q`` or the end
of input. ``--device`` defaults to ``cuda``; without a CUDA card that
raises rather than running on the CPU.
"""

from __future__ import annotations

import argparse
import logging

import torch

from video_quierer_tpu_torch.engine.system import VideoSearchEngine


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Interactive video search")
    parser.add_argument("--videos-dir", default="videos")
    parser.add_argument("-k", type=int, default=5)
    parser.add_argument("--log-level", default="INFO")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    logging.basicConfig(level=getattr(logging, args.log_level.upper(),
                                      logging.INFO),
                        format="%(levelname)s:%(name)s:%(message)s")
    # exact f32 re-rank: no TF32 in f32 matmuls (cuDNN allows it by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("Video Search (PyTorch/CUDA port) — interactive demo")
    print("=" * 50)
    engine = VideoSearchEngine(args.videos_dir, device=args.device)
    engine.startup()
    print(f"\nIndex ready: {len(engine.index)} frames from "
          f"{len(engine.index.video_names())} videos.")
    print("Type a query, or 'quit' to exit.\n")

    try:
        while True:
            try:
                query = input("search> ").strip()
            except (KeyboardInterrupt, EOFError):
                print()
                break
            if query.lower() in ("quit", "exit", "q"):
                break
            if not query:
                continue
            results = engine.search(query, k=args.k)
            if not results:
                print("  no results")
                continue
            for i, r in enumerate(results, 1):
                print(f"  {i}. {r['video_name']} at {r['formatted_time']} "
                      f"(score {r['score']:.3f})")
    finally:
        engine.close()


if __name__ == "__main__":
    main()
