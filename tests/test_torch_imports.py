"""The port imports torch and numpy only: in a fresh interpreter, importing
every module of video_quierer_tpu_torch (the corpus-mesh modules
``parallel/mesh.py`` and ``index/sharded.py``, the SigLIP family's
``models/siglip``, the HTTP API's ``api/``, the samplers, the
``use_clip = false`` encoders, the CLI, the checkpoint converters, the
trainer's ``train/``, the Switch-MoE and pipeline modules of
``parallel/``, the native decode tier's ``ingest/native.py`` and the
multi-process and data meshes of ``parallel/mesh.py`` among them) leaves jax, flax, optax, orbax, aiohttp, pydantic, cv2, yt_dlp,
safetensors and transformers out of ``sys.modules``, builds no kernel,
spawns no process and loads no native library."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "orbax", "aiohttp", "pydantic", "cv2",
             "yt_dlp", "safetensors", "transformers")

SCRIPT = r"""
import ctypes, importlib, json, pkgutil, subprocess, sys
spawned, opened = [], []
_popen, _cdll = subprocess.Popen.__init__, ctypes.CDLL.__init__
def popen(self, args, *a, **kw):
    spawned.append(str(args))
    return _popen(self, args, *a, **kw)
def cdll(self, name, *a, **kw):
    opened.append(str(name))
    return _cdll(self, name, *a, **kw)
subprocess.Popen.__init__, ctypes.CDLL.__init__ = popen, cdll
import video_quierer_tpu_torch as pkg
mods = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + "."))
for name in mods:
    importlib.import_module(name)
from video_quierer_tpu_torch.ops import kernels
from video_quierer_tpu_torch.ingest import native
print(json.dumps({"modules": mods, "loaded": sorted(sys.modules),
                  "built": kernels._lib is not None,
                  "native": [native._lib is not None,
                             native._load_attempted],
                  "spawned": spawned,
                  "opened": [n for n in opened if "vqt" in n]}))
"""


@pytest.fixture(scope="module")
def report():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_imports_no_jax_or_server_frameworks(report):
    assert len(report["modules"]) >= 20
    loaded = set(report["loaded"])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_builds_no_kernel(report):
    assert report["built"] is False


def test_import_builds_and_loads_no_native_decoder(report):
    """Importing ``ingest/native.py`` (with every other module) runs no
    compiler and no ``make``, spawns no process and loads no library."""
    assert report["native"] == [False, False]
    assert report["spawned"] == [] and report["opened"] == []


def test_mesh_modules_are_walked(report):
    for name in ("parallel", "parallel.mesh", "parallel.moe",
                 "parallel.pipeline", "ingest.native", "index.sharded",
                 "index.device_index", "index.ivf"):
        assert f"video_quierer_tpu_torch.{name}" in report["modules"]


def test_siglip_modules_are_walked(report):
    for name in ("model", "bridge", "fused", "embedder", "spm", "convert"):
        assert f"video_quierer_tpu_torch.models.siglip.{name}" in \
            report["modules"]


def test_api_modules_are_walked(report):
    for name in ("server", "routes", "schemas", "multipart", "web",
                 "openapi", "__main__"):
        assert f"video_quierer_tpu_torch.api.{name}" in report["modules"]


def test_ingest_fallback_and_cli_modules_are_walked(report):
    for name in ("ingest.samplers", "ingest.frames", "ingest.pipeline",
                 "engine.fallback", "cli"):
        assert f"video_quierer_tpu_torch.{name}" in report["modules"]


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    """The corpus mesh takes the CUDA devices unless given others: without
    a card it raises, never falling back to the CPU."""
    from video_quierer_tpu_torch.parallel import mesh
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.corpus_mesh(4)
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.multislice_corpus_mesh(2, 4)
    cpu = mesh.corpus_mesh(2, devices=["cpu"] * 3)
    assert cpu.n_shards == 2 and cpu.shape == {mesh.CORPUS_AXIS: 2}
    with pytest.raises(ValueError, match="slices"):
        mesh.multislice_corpus_mesh(3, 4, devices=["cpu"] * 4)
    monkeypatch.delenv("VQT_COORDINATOR", raising=False)
    assert mesh.initialize_distributed() is False
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.data_mesh(4)
    dm = mesh.data_mesh(devices=["cpu"] * 4, model_parallel=2)
    assert dm.shape == {mesh.DATA_AXIS: 2, mesh.MODEL_AXIS: 2}
    assert len(dm.data_devices) == 2


GROUP_SCRIPT = r"""
import json, os, socket
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
os.environ.update(VQT_COORDINATOR=f"127.0.0.1:{port}", VQT_NUM_PROCESSES="1",
                  VQT_PROCESS_ID="0")
import torch.distributed as dist
from video_quierer_tpu_torch.parallel import mesh
first = mesh.initialize_distributed("cpu", timeout_s=30)
out = {"first": first, "formed": dist.is_initialized(),
       "backend": dist.get_backend(), "world": dist.get_world_size(),
       "again": mesh.initialize_distributed("cpu")}
try:
    mesh.initialize_distributed("cuda")
except ValueError as e:
    out["cuda"] = str(e)
m = mesh.multislice_corpus_mesh(1, devices=["cpu"] * 2)
out["mesh"] = [m.n_shards, m.multiprocess]
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_env_gated_init_forms_the_group():
    """With ``VQT_COORDINATOR`` set, ``initialize_distributed`` forms the
    default process group (gloo for the CPU) and returns True; a second
    call returns True without a new rendezvous; a CUDA device asks for
    NCCL and is refused on a gloo group, never served by it. A group of
    one process leaves the corpus mesh in one process."""
    out = subprocess.run([sys.executable, "-c", GROUP_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["first"] is True and got["formed"] is True
    assert got["backend"] == "gloo" and got["world"] == 1
    assert got["again"] is True
    assert "nccl" in got["cuda"]
    assert got["mesh"] == [2, False]


def test_train_modules_are_walked(report):
    for name in ("train", "train.trainer", "train.data", "train.eval",
                 "train.checkpoint", "train.finetune"):
        assert f"video_quierer_tpu_torch.{name}" in report["modules"]
