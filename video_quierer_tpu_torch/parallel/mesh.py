"""Corpus meshes (counterpart of ``video_quierer_tpu/parallel/mesh.py``, the
corpus axes).

The JAX package serves a sharded corpus from one controller process: a
``jax.sharding.Mesh`` with a ``corpus`` axis (and an outer ``dcn`` axis on
a multi-slice mesh), each shard's scan run under ``shard_map``. The port
keeps that single-controller shape: a :class:`CorpusMesh` is an ordered
tuple of devices, one per shard; ``index/sharded.py`` launches each
shard's scan on its device and merges the candidates on the first one.
Devices may repeat, so several shards can share one card (or, in the CPU
tests, ``"cpu"``), as the JAX tests split the host into 8 virtual devices.

:func:`pipe_devices` gives the ``pipe`` axis of the pipelined image tower
(``parallel/pipeline.py``; JAX ``pipe_mesh``). Multi-host serving
(``initialize_distributed`` with NCCL) and the data, tensor and expert
meshes of training are later ports.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch

CORPUS_AXIS = "corpus"
# outer axis of a multi-slice mesh: shards of one slice are contiguous
DCN_AXIS = "dcn"
# the pipelined image tower's stages (parallel/pipeline.py)
PIPE_AXIS = "pipe"


class CorpusMesh:
    """Shards of a row-sharded corpus: ``devices[i]`` holds shard ``i``.

    On a multi-slice mesh (``n_slices > 1``) the devices are row-major
    ``[slice][shard of the slice]``, as ``jax.sharding.Mesh`` over ``(dcn,
    corpus)`` lays them out; ``shape`` reads like the JAX mesh's
    (``mesh.shape[CORPUS_AXIS]`` is the shards of one slice)."""

    def __init__(self, devices: Sequence, n_slices: int = 1):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a corpus mesh needs at least one device")
        if n_slices < 1 or len(self.devices) % n_slices:
            raise ValueError(f"{len(self.devices)} devices not divisible "
                             f"into {n_slices} slices")
        self.n_slices = n_slices

    @property
    def n_shards(self) -> int:
        """Shards over all slices."""
        return len(self.devices)

    @property
    def per_slice(self) -> int:
        return len(self.devices) // self.n_slices

    @property
    def multislice(self) -> bool:
        return self.n_slices > 1

    @property
    def shape(self) -> Dict[str, int]:
        if self.multislice:
            return {DCN_AXIS: self.n_slices, CORPUS_AXIS: self.per_slice}
        return {CORPUS_AXIS: self.per_slice}

    def __repr__(self) -> str:
        return (f"CorpusMesh({[str(d) for d in self.devices]}, "
                f"n_slices={self.n_slices})")


def _cuda_devices(n_devices: Optional[int], devices) -> list:
    """``devices`` (all CUDA devices when None), the first ``n_devices``
    of them — fewer when fewer exist, as ``jax.devices()[:n]``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("a corpus mesh on CUDA devices was asked for "
                               "but torch.cuda.device_count() is 0")
    devs = list(devices)
    return devs if n_devices is None else devs[:n_devices]


def corpus_mesh(n_devices: Optional[int] = None, *,
                devices: Optional[Sequence] = None) -> CorpusMesh:
    """1-D mesh over the first ``n_devices`` CUDA devices (or of
    ``devices``)."""
    return CorpusMesh(_cuda_devices(n_devices, devices))


def multislice_corpus_mesh(n_slices: int, n_devices: Optional[int] = None,
                           *, devices: Optional[Sequence] = None
                           ) -> CorpusMesh:
    """2-D ``(dcn, corpus)`` mesh: the first ``n_devices`` devices split
    row-major into ``n_slices`` slices (an indivisible count raises)."""
    return CorpusMesh(_cuda_devices(n_devices, devices), n_slices=n_slices)


def pipe_devices(n_stages: Optional[int] = None, devices=None, *,
                 depth: Optional[int] = None) -> Tuple[torch.device, ...]:
    """The ``pipe`` axis: stage ``s`` runs on the ``s``-th device. The
    first ``n_stages`` of ``devices`` (all CUDA devices when None, raising
    without a card); with ``n_stages`` None and the encoder ``depth``
    given, the largest count of them that divides it (JAX
    ``embedder.py:130-139``): one card is one stage."""
    devs = _cuda_devices(n_stages, devices)
    if n_stages is None and depth is not None:
        n = max(d for d in range(1, len(devs) + 1) if depth % d == 0)
        devs = devs[:n]
    return tuple(torch.device(d) for d in devs)


def initialize_distributed() -> bool:
    """Multi-process runtime init, gated on ``VQT_COORDINATOR`` as in the
    reference: False when it is unset (one process serves every shard).
    Multi-host serving is not ported: with it set this raises."""
    if not os.environ.get("VQT_COORDINATOR"):
        return False
    raise NotImplementedError(
        "multi-host serving (VQT_COORDINATOR) is not yet ported: one "
        "process holds every shard of a corpus mesh")
