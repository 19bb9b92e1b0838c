"""video_quierer_tpu_torch — the PyTorch/CUDA port of ``video_quierer_tpu``.

The JAX package beside it is the reference: every module here has one
counterpart there (same subpackage layout) and the ``tests/test_torch_*``
files hold the two against each other on the CPU. The port serves on an
NVIDIA H100 (Hopper, ``sm_90a``); the TPU's Pallas kernels on its main
path are hand-written CUDA C++ kernels under ``csrc/``, built with
``nvcc`` on first use (``ops/kernels.py``).

Importing the package imports torch and numpy only — never jax, flax,
aiohttp, pydantic or cv2 (OpenCV is imported by the functions that decode
a video) — and builds nothing.

Entry point: ``python -m video_quierer_tpu_torch.api --port 5001
--videos-dir DIR`` (ingest of the videos in DIR, then HTTP text search,
api/server.py).
"""

__version__ = "0.1.0"
