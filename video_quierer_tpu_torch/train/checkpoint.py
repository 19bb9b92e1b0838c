"""Training checkpoints in the port's own format (counterpart of
``video_quierer_tpu/train/checkpoint.py``, which writes orbax's).

``save_checkpoint`` writes ``ckpt_dir/step_<N>/`` atomically: the files
go into a hidden temporary directory beside it, which is renamed into
place once complete, so a reader sees a whole checkpoint or none. It
holds:

- ``checkpoint.json``: the format's name (:data:`FORMAT`), the step and
  which trees are present;
- ``params.pt``, ``opt_state.pt`` (``{"count", "mu", "nu"}``) and, when
  the trainer tracks one, ``ema_params.pt``: dicts of CPU tensors by
  parameter name, written by ``torch.save`` and read back with
  ``torch.load(weights_only=True)``.

A mesh trainer's trees are written whole (gathered from their parts)
in the same format, and any checkpoint restores onto any mesh shape or
onto one device, as JAX's orbax restore does (JAX ``:51-84``).
``restore_checkpoint`` follows the JAX package's four EMA cases: an EMA
on disk into a trainer without one is dropped; a checkpoint without one
into a trainer that tracks one seeds it from the restored parameters;
the matching cases restore as they are. :func:`load_params` reads the
``params`` tree alone, for serving (``model.orbax_checkpoint``). A
directory that is not a checkpoint of this format raises ``ValueError``
(an orbax directory of the JAX package included: the port does not read
orbax's format).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch

from video_quierer_tpu_torch.parallel.mesh import ShardedTree

logger = logging.getLogger(__name__)

FORMAT = "video_quierer_tpu_torch.train/1"
MANIFEST = "checkpoint.json"


def _cpu(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_checkpoint(ckpt_dir: Path, trainer, step: int) -> Path:
    """Save the trainer's state under ``ckpt_dir/step_<N>``; returns that
    path. An existing ``step_<N>`` raises ``FileExistsError``."""
    ckpt_dir = Path(ckpt_dir).resolve()
    path = ckpt_dir / f"step_{step}"
    if path.exists():
        raise FileExistsError(f"checkpoint {path} already exists")
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    st = trainer.state
    trees = {"params": _cpu(st.params),
             "opt_state": {"count": int(st.opt_state["count"]),
                           "mu": _cpu(st.opt_state["mu"]),
                           "nu": _cpu(st.opt_state["nu"])}}
    if st.ema_params is not None:
        trees["ema_params"] = _cpu(st.ema_params)
    tmp = Path(tempfile.mkdtemp(prefix=f".step_{step}.", dir=ckpt_dir))
    try:
        for name, tree in trees.items():
            torch.save(tree, tmp / f"{name}.pt")
        (tmp / MANIFEST).write_text(json.dumps(
            {"format": FORMAT, "step": int(step), "trees": sorted(trees)}))
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    logger.info("checkpoint saved: %s", path)
    return path


def latest_step(ckpt_dir: Path) -> Optional[int]:
    """The highest ``N`` of the ``step_<N>`` entries, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_"):
            try:
                steps.append(int(p.name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def read_manifest(path: Path) -> dict:
    """The manifest of the checkpoint at ``path``; ``ValueError`` when
    ``path`` is not a checkpoint of this format."""
    path = Path(path)
    try:
        manifest = json.loads((path / MANIFEST).read_text())
    except (OSError, ValueError) as e:
        raise ValueError(
            f"{path} is not a checkpoint of the port's trainer (no "
            f"readable {MANIFEST}; orbax checkpoints of the JAX package are "
            "not read)") from e
    fmt = manifest.get("format") if isinstance(manifest, dict) else None
    if fmt != FORMAT:
        raise ValueError(f"{path}: checkpoint format {fmt!r} is not the "
                         f"port's ({FORMAT})")
    return manifest


def _load(path: Path, name: str):
    return torch.load(Path(path) / f"{name}.pt", map_location="cpu",
                      weights_only=True)


def load_params(path: Path) -> Dict[str, torch.Tensor]:
    """The ``params`` tree (the live weights, not the EMA) of the
    checkpoint at ``path``, as CPU tensors by name."""
    read_manifest(path)
    return _load(path, "params")


@torch.no_grad()
def _copy_into(dst: Mapping[str, torch.Tensor],
               src: Mapping[str, torch.Tensor], what: str) -> None:
    """Copy ``src`` into ``dst`` in place, tensor by tensor (into a mesh
    trainer's ``ShardedTree`` by its parts, whatever mesh wrote ``src``)."""
    if dst.keys() != src.keys():
        raise ValueError(f"{what}: the checkpoint's names differ from the "
                         f"trainer's ({sorted(set(dst) ^ set(src))[:4]})")
    for k, t in dst.items():
        if t.shape != src[k].shape:
            raise ValueError(f"{what}.{k}: shape {tuple(src[k].shape)} on "
                             f"disk, {tuple(t.shape)} in the trainer")
        if isinstance(dst, ShardedTree):
            dst.load_(k, src[k])
        else:
            t.copy_(src[k])


def restore_checkpoint(ckpt_dir: Path, trainer,
                       step: Optional[int] = None) -> int:
    """Restore params, optimizer state, step and EMA into the trainer (in
    place, on its device); returns the step."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = Path(ckpt_dir).resolve() / f"step_{step}"
    manifest = read_manifest(path)
    st = trainer.state
    _copy_into(st.params, _load(path, "params"), "params")
    opt = _load(path, "opt_state")
    _copy_into(st.opt_state["mu"], opt["mu"], "opt_state.mu")
    _copy_into(st.opt_state["nu"], opt["nu"], "opt_state.nu")
    st.opt_state["count"] = int(opt["count"])
    if st.ema_params is not None:
        # a pre-EMA checkpoint seeds the average from the restored weights
        src = (_load(path, "ema_params")
               if "ema_params" in manifest["trees"] else st.params)
        _copy_into(st.ema_params, src, "ema_params")
    st.step = int(manifest["step"])
    logger.info("checkpoint restored: %s", path)
    return st.step
