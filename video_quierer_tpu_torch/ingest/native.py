"""ctypes bindings of the native FFmpeg decode tier (counterpart of
``video_quierer_tpu/ingest/native.py``, over the same
``native/decoder.cpp``).

The decode loop runs in C++ (demux → decode → sample → swscale → write
into one contiguous buffer); Python gives the sampling plan (the interval
rule of ``ingest/frames.py``) and receives a ready ``[N, S, S, 3]`` uint8
RGB batch. ``extract_frames(use_native=True)`` or ``VQT_NATIVE_DECODE=1``
takes this tier; where the library cannot be built or loaded, the OpenCV
path, which the reference calls behaviour-identical, serves instead.

Nothing is built or loaded at import. The first :func:`load` compiles
``native/decoder.cpp`` (read only) with ``native/Makefile``'s flags
(``$CXX``, default ``g++``, ``-O3 -fPIC -std=c++17 -Wall``, ``pkg-config``
for libavformat, libavcodec, libavutil and libswscale) into
``build/native/libvqt_decoder-<hash of the source and flags>.so``: under
an ``fcntl`` lock, to a temporary name, then ``os.replace``, so parallel
processes (test workers) neither race nor load half a file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "decoder.cpp"
BUILD_DIR = _ROOT / "build" / "native"
PKGS = ("libavformat", "libavcodec", "libavutil", "libswscale")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")

_lib = None
_load_attempted = False
_load_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The decoder library could not be built."""


class _VideoInfo(ctypes.Structure):
    _fields_ = [
        ("fps", ctypes.c_double),
        ("total_frames", ctypes.c_long),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
    ]


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def _pkg_config(flag: str) -> List[str]:
    out = subprocess.run(["pkg-config", flag, *PKGS], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise NativeBuildError(f"pkg-config {flag} {' '.join(PKGS)}: "
                               + out.stderr.strip())
    return out.stdout.split()


def toolchain_available() -> bool:
    """A C++ compiler, ``pkg-config`` and the four libav libraries'
    development files are present."""
    if shutil.which(_cxx()) is None or shutil.which("pkg-config") is None:
        return False
    return subprocess.run(["pkg-config", "--exists", *PKGS],
                          capture_output=True, timeout=60).returncode == 0


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((_cxx(),) + CXXFLAGS).encode())
    return BUILD_DIR / f"libvqt_decoder-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The built library's path, compiling it first when it is not
    there; raises :class:`NativeBuildError`."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():            # another process built it meanwhile
            return out
        if shutil.which(_cxx()) is None or shutil.which("pkg-config") is None:
            raise NativeBuildError(f"{_cxx()} or pkg-config not found")
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [_cxx(), *CXXFLAGS, *_pkg_config("--cflags"), "-shared",
               "-o", str(tmp), str(SOURCE), *_pkg_config("--libs"), "-lm"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise NativeBuildError("native decoder build failed:\n"
                                       + proc.stderr)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    logger.info("native decoder built: %s", out)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.vqt_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(_VideoInfo)]
    lib.vqt_probe.restype = ctypes.c_int
    lib.vqt_decode_sampled.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_double)]
    lib.vqt_decode_sampled.restype = ctypes.c_int
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The decoder library (built on the first call), or None when it
    cannot be built or loaded; tried once a process."""
    global _lib, _load_attempted
    with _load_lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            path = build()
        except (NativeBuildError, OSError, subprocess.SubprocessError) as e:
            logger.debug("native decoder build failed: %s", e)
            logger.info("native decoder unavailable — using OpenCV path")
            return None
        try:
            _lib = _bind(path)
            logger.info("native decoder loaded: %s", path)
        except OSError as e:
            logger.warning("failed to load native decoder: %s", e)
        return _lib


def available() -> bool:
    return load() is not None


def probe(video_path: Path) -> Optional[Tuple[float, int, int, int]]:
    """``(fps, total_frames, width, height)`` or None."""
    lib = load()
    if lib is None:
        return None
    info = _VideoInfo()
    if lib.vqt_probe(str(video_path).encode(), ctypes.byref(info)) != 0:
        return None
    return info.fps, int(info.total_frames), info.width, info.height


def decode_sampled(video_path: Path, interval: int, max_frames: int,
                   target_size: int = 224
                   ) -> Optional[Tuple[np.ndarray, Sequence[float]]]:
    """Native sampled decode → ``([N, S, S, 3] uint8 RGB, timestamps)``:
    every ``interval``-th frame, at most ``max_frames``, each resized
    shorter side first and centre-cropped to ``target_size``. None when
    the library is unavailable or the decode fails."""
    lib = load()
    if lib is None:
        return None
    frames = np.empty((max_frames, target_size, target_size, 3), np.uint8)
    stamps = np.empty(max_frames, np.float64)
    n = lib.vqt_decode_sampled(
        str(video_path).encode(), int(interval), int(max_frames),
        int(target_size),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if n < 0:
        return None
    return frames[:n].copy(), stamps[:n].tolist()
