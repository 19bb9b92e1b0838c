"""The port imports torch and numpy only: in a fresh interpreter, importing
every module of video_quierer_tpu_torch leaves jax, flax, aiohttp,
pydantic and cv2 out of ``sys.modules``, and builds no kernel."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "orbax", "aiohttp", "pydantic", "cv2")

SCRIPT = r"""
import importlib, json, pkgutil, sys
import video_quierer_tpu_torch as pkg
mods = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + "."))
for name in mods:
    importlib.import_module(name)
from video_quierer_tpu_torch.ops import kernels
print(json.dumps({"modules": mods, "loaded": sorted(sys.modules),
                  "built": kernels._lib is not None}))
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
