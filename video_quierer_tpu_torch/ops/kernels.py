"""Build, load and call the port's CUDA kernels.

The sources under ``csrc/`` (``*.cu``, one per kernel or family of
kernels, and the shared ``*.cuh`` headers) compile with ``nvcc`` for
``sm_90a`` into ONE shared library with a plain C interface, loaded with
``ctypes``. The library lands in
``build/kernels/<hash of the sources>/`` beside the package, so a changed
source rebuilds and an unchanged one loads the cached build. Nothing is
built at import time: the first call that needs a kernel builds it (one
``nvcc`` process per source, in parallel, then a link; the sources include
no PyTorch headers, so each compiles in seconds).

Each C function launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code.
The wrappers in ``ops/*.py`` check devices, dtypes, shapes and
contiguity before they pass pointers, and count their launches
(:func:`count_launch`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")
LIB_NAME = "libvqt_kernels.so"

# dtype codes of csrc/common.cuh
DT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (argument types must be declared: ctypes would otherwise
# pass every Python int as a 32-bit int and cut the pointers)
_SIGNATURES = {
    "vqt_cand_scan_prefix": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P),
    "vqt_cand_scan": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "vqt_cand_scan_int8_prefix": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _P),
    "vqt_cand_scan_int8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P),
    "vqt_cand_scan_int4_prefix": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _P),
    "vqt_block_scan": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "vqt_block_scan_stages": (_I, _I, _I, _I),
    "vqt_cand_scan_codes_stages": (_I, _I, _I, _I),
    "vqt_cand_scan_stages": (_I, _I, _I),
    "vqt_probe_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _P),
    "vqt_probe_scan_scratch": (_I, _I, _I),
    "vqt_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                      _F, _I, _P),
    "vqt_text_layer": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "vqt_attn_half": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _F, _I, _I, _P),
    "vqt_mlp_half": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                     _I, _P),
    "vqt_rms_attn_half": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                          _I, _I, _P),
    "vqt_gated_mlp_half": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
}

# return types other than the launchers' int error code
_RESTYPES = {"vqt_probe_scan_scratch": ctypes.c_size_t}

_lock = threading.Lock()
_lib = None
_count_lock = threading.Lock()

# what the last build in this process cost ({} when the cache was warm)
last_build: dict = {}


def source_files():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for f in source_files():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(f"nvcc not found (PATH or {home}/bin)")


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed build directory (no-op when
    that build exists) and return the library path: one ``nvcc -c`` per
    source, all started together, then one link. A failed build raises
    with the compiler's output."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    try:
        for src, p, out in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} with code "
                                   f"{p.returncode}:\n{out}")
        proc = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code "
                               f"{proc.returncode}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    (out_dir / "ptxas.log").write_text(log)
    os.replace(tmp, lib)         # atomic: concurrent builds race safely
    last_build.update(seconds=time.perf_counter() - t0, dir=str(out_dir),
                      ptxas=log)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            handle.vqt_error_string.argtypes = [ctypes.c_int]
            handle.vqt_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = lib().vqt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DT_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"unsupported kernel dtype {t.dtype}") from None


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device and contiguous; returns it."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return dev


def count_launch(wrapper, counter: str = "launches") -> None:
    """One more launch on ``wrapper.launches``, or on the wrapper's
    ``counter`` of one kernel instance (thread-safe)."""
    with _count_lock:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)
