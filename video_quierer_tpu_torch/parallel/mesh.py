"""Corpus and data meshes (counterpart of
``video_quierer_tpu/parallel/mesh.py``).

The JAX package serves a sharded corpus from one program over a
``jax.sharding.Mesh`` with a ``corpus`` axis (and an outer ``dcn`` axis on
a multi-slice mesh), each shard's scan run under ``shard_map``. The port
keeps that shape: a :class:`CorpusMesh` is an ordered tuple of devices, one
per shard; ``index/sharded.py`` launches each shard's scan on its device
and merges the candidates. Devices may repeat, so several shards can share
one card (or, in the CPU tests, ``"cpu"``), as the JAX tests split the
host into 8 virtual devices.

**Across processes** (multi-host serving): :func:`initialize_distributed`
forms a ``torch.distributed`` process group from ``VQT_COORDINATOR``,
``VQT_NUM_PROCESSES`` and ``VQT_PROCESS_ID``, as the reference's
``jax.distributed.initialize``. A corpus mesh built while such a group
exists spans its processes, in the order ``jax.devices()`` gives the
devices of a multi-process job: process-major, so process ``p`` owns
global shards ``[p·L, (p+1)·L)`` on its own ``L`` local devices (on the
card ``cuda:0 .. L-1`` of the cards it sees, which a launcher sets with
``CUDA_VISIBLE_DEVICES``). ``CorpusMesh.devices`` are always this
process's devices; the shards of the other processes are known by their
count and owner.

:func:`data_mesh` gives the ``(data, model)`` grid of the embedder's
data-parallel serving (``models/clip/embedder.py``, JAX
``CLIPEmbedder(mesh=...)``) and of the trainer's data and tensor
parallelism; with ``axis=EXPERT_AXIS`` the same grid is the trainer's
``(data, expert)`` mesh (``train/trainer.py``, JAX ``finetune.py:
build_mesh``). It spans this process's devices only: the JAX trainer is
one controller over its devices, and so is the port's.
:class:`ShardedTree` places a state dict on such a grid by partition
specs (JAX ``device_put`` with a ``NamedSharding``).
:func:`pipe_devices` gives the ``pipe`` axis of the pipelined image tower
(``parallel/pipeline.py``; JAX ``pipe_mesh``).
"""

from __future__ import annotations

import collections.abc
import datetime
import os
from typing import (
    Callable,
    Dict,
    Iterator,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

import torch
import torch.distributed as dist

CORPUS_AXIS = "corpus"
# outer axis of a multi-slice mesh: shards of one slice are contiguous
DCN_AXIS = "dcn"
# the pipelined image tower's stages (parallel/pipeline.py)
PIPE_AXIS = "pipe"
# the embedder's data-parallel grid (data_mesh)
DATA_AXIS = "data"
MODEL_AXIS = "model"
# a rendezvous or collective that has not completed by then raises
DIST_TIMEOUT_S = 600.0


def process_group():
    """The default process group when it spans several processes (formed
    by :func:`initialize_distributed`), else None."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


class CorpusMesh:
    """Shards of a row-sharded corpus.

    ``devices`` are this process's devices, one a shard: in one process
    ``devices[i]`` holds shard ``i``. With ``group`` (a process group of
    ``P`` processes, each holding ``L = len(devices)`` shards) the mesh has
    ``P·L`` shards, process-major: the process of rank ``p`` owns shards
    ``[p·L, (p+1)·L)``, ``devices[j]`` holding shard ``p·L + j``. Building
    such a mesh is a collective: every process of the group builds it, and
    a process that holds another count of shards makes it raise.

    On a multi-slice mesh (``n_slices > 1``) the shards are row-major
    ``[slice][shard of the slice]``, as ``jax.sharding.Mesh`` over ``(dcn,
    corpus)`` lays them out; ``shape`` reads like the JAX mesh's
    (``mesh.shape[CORPUS_AXIS]`` is the shards of one slice)."""

    def __init__(self, devices: Sequence, n_slices: int = 1, *, group=None):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a corpus mesh needs at least one device")
        self.group = group
        self.process_count = 1 if group is None else dist.get_world_size(
            group)
        self.process_index = 0 if group is None else dist.get_rank(group)
        if self.process_count > 1:
            counts = [None] * self.process_count
            dist.all_gather_object(counts, len(self.devices), group=group)
            if len(set(counts)) != 1:
                raise ValueError(f"every process of a corpus mesh holds the "
                                 f"same number of shards; they hold "
                                 f"{counts}")
        if n_slices < 1 or self.n_shards % n_slices:
            raise ValueError(f"{self.n_shards} devices not divisible "
                             f"into {n_slices} slices")
        self.n_slices = n_slices

    @property
    def n_local(self) -> int:
        """Shards on this process."""
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        """Shards over all slices and processes."""
        return self.n_local * self.process_count

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.process_index * self.n_local

    @property
    def local_shards(self) -> range:
        return range(self.first_shard, self.first_shard + self.n_local)

    def owner(self, shard: int) -> int:
        """Rank of the process that holds global shard ``shard``."""
        return shard // self.n_local

    @property
    def multiprocess(self) -> bool:
        return self.process_count > 1

    @property
    def per_slice(self) -> int:
        return self.n_shards // self.n_slices

    @property
    def multislice(self) -> bool:
        return self.n_slices > 1

    @property
    def shape(self) -> Dict[str, int]:
        if self.multislice:
            return {DCN_AXIS: self.n_slices, CORPUS_AXIS: self.per_slice}
        return {CORPUS_AXIS: self.per_slice}

    def on_first_process(self, fn: Callable):
        """``fn()`` on process 0 alone, its result returned on every
        process: the others wait at a barrier until every process has got
        here (so none still reads what ``fn`` writes), then for process 0's
        result. For a write to a shared path (the cache save), which two
        processes must not make at once. A failure on process 0 raises on
        every process. In one process: ``fn()``."""
        if not self.multiprocess:
            return fn()
        dist.barrier(group=self.group)
        box = [None]
        failure = None
        if self.process_index == 0:
            try:
                box[0] = ("ok", fn())
            except Exception as e:      # re-raised below, after the others
                failure = e             # have been told
                box[0] = ("error", f"{type(e).__name__}: {e}")
        dist.broadcast_object_list(box, src=dist.get_global_rank(
            self.group, 0), group=self.group)
        if failure is not None:
            raise failure
        if box[0][0] == "error":
            raise RuntimeError(f"process 0 failed: {box[0][1]}")
        return box[0][1]

    def __repr__(self) -> str:
        procs = (f", process {self.process_index} of {self.process_count}"
                 if self.multiprocess else "")
        return (f"CorpusMesh({[str(d) for d in self.devices]}, "
                f"n_slices={self.n_slices}{procs})")


class DataMesh:
    """A ``(data, axis)`` grid of devices (JAX ``data_mesh``; ``axis`` is
    ``model`` or, for expert parallelism, ``parallel/moe.py:EXPERT_AXIS``):
    row ``r`` is ``devices[r·mp : (r+1)·mp]`` and a part of the second
    axis is ``grid[r][c]``. Serving splits a batch over ``data`` only and
    computes each part on its row's first device (:attr:`data_devices`),
    as JAX's ``P(data_axis, ...)`` replicates over ``model``; the trainer
    also splits parameters over the second axis. Devices may repeat, so
    several parts can share one card."""

    def __init__(self, devices: Sequence, model_parallel: int = 1, *,
                 axis: str = MODEL_AXIS):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a data mesh needs at least one device")
        if model_parallel < 1 or len(devs) % model_parallel:
            raise ValueError(f"{len(devs)} devices not divisible by "
                             f"mp={model_parallel}")
        if axis == DATA_AXIS:
            raise ValueError(f"the second axis cannot be {DATA_AXIS!r}")
        self.devices = devs
        self.axis = axis
        self.grid: Tuple[Tuple[torch.device, ...], ...] = tuple(
            devs[r:r + model_parallel]
            for r in range(0, len(devs), model_parallel))

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.grid), self.axis: len(self.grid[0])}

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """Each data row's first device: where its part of a batch runs."""
        return tuple(row[0] for row in self.grid)

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]}, {self.shape})"


class ShardedTree(collections.abc.Mapping):
    """Tensors by name, each placed on a :class:`DataMesh` by its
    partition spec (a tuple with an axis name or None per dimension, ``()``
    replicated; JAX's ``PartitionSpec``): a tensor split over the mesh's
    second axis ``A`` on dimension ``k`` is held as ``A`` equal parts,
    part ``c`` on ``mesh.grid[0][c]``; any other tensor as one part on
    ``mesh.grid[0][0]``. The parts are what the trainer updates; other
    data rows take copies of them (``to``) for a step.

    As a mapping it gives each tensor whole by its name (the parts
    concatenated on ``grid[0][0]``; a replicated tensor is its one part,
    live), as a one-device state dict does; :meth:`load_` writes a whole
    tensor into the parts in place."""

    def __init__(self, mesh: DataMesh, specs: Mapping[str, tuple],
                 parts: Mapping[str, List[torch.Tensor]]):
        self.mesh = mesh
        self.specs = dict(specs)
        self._parts = dict(parts)

    @staticmethod
    def split_dim(spec: tuple, mesh: DataMesh) -> Optional[int]:
        """The dimension ``spec`` splits over the mesh's second axis, or
        None (replicated)."""
        for k, ax in enumerate(spec):
            if ax == mesh.axis:
                return k
        return None

    @classmethod
    def place(cls, tree: Mapping[str, torch.Tensor], mesh: DataMesh,
              specs: Mapping[str, tuple]) -> "ShardedTree":
        """``tree``'s tensors (copied) in their parts on the mesh; a
        dimension that does not divide over the axis raises."""
        n = len(mesh.grid[0])
        parts = {}
        for name, t in tree.items():
            k = cls.split_dim(specs[name], mesh)
            t = t.detach()
            if k is None:
                parts[name] = [t.to(mesh.grid[0][0], copy=True)]
                continue
            if t.shape[k] % n:
                raise ValueError(f"{name}: dimension {k} of {tuple(t.shape)}"
                                 f" does not split over {n} {mesh.axis} "
                                 "parts")
            parts[name] = [c.to(dev, copy=True).contiguous() for c, dev in
                           zip(t.chunk(n, dim=k), mesh.grid[0])]
        return cls(mesh, specs, parts)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "ShardedTree":
        """A tree of the same layout with ``fn`` of each part (say
        ``torch.zeros_like``)."""
        return ShardedTree(self.mesh, self.specs, {
            k: [fn(p) for p in ps] for k, ps in self._parts.items()})

    def parts(self, name: str) -> List[torch.Tensor]:
        return self._parts[name]

    def flat(self) -> List[torch.Tensor]:
        """Every part, in name order and part order."""
        return [p for ps in self._parts.values() for p in ps]

    def split(self, name: str, full: torch.Tensor) -> List[torch.Tensor]:
        """``full`` (a tensor shaped like ``name``'s) cut as ``name``'s
        parts are, each on its part's device."""
        k = self.split_dim(self.specs[name], self.mesh)
        ps = self._parts[name]
        if k is None:
            return [full.to(ps[0].device)]
        return [c.to(p.device) for c, p in
                zip(full.chunk(len(ps), dim=k), ps)]

    def __getitem__(self, name: str) -> torch.Tensor:
        ps = self._parts[name]
        k = self.split_dim(self.specs[name], self.mesh)
        if k is None:
            return ps[0]
        return torch.cat([p.to(ps[0].device) for p in ps], dim=k)

    def load_(self, name: str, full: torch.Tensor) -> None:
        """Write the whole tensor ``full`` into ``name``'s parts."""
        with torch.no_grad():
            for p, c in zip(self._parts[name], self.split(name, full)):
                p.copy_(c)

    def __iter__(self) -> Iterator[str]:
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __repr__(self) -> str:
        split = sum(len(ps) > 1 for ps in self._parts.values())
        return (f"ShardedTree({len(self)} tensors, {split} split over "
                f"{self.mesh.shape})")


def _cuda_devices(n_devices: Optional[int], devices, what: str = "a corpus "
                  "mesh") -> list:
    """``devices`` (all CUDA devices when None), the first ``n_devices``
    of them — fewer when fewer exist, as ``jax.devices()[:n]``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(f"{what} on CUDA devices was asked for but "
                               "torch.cuda.device_count() is 0")
    devs = list(devices)
    return devs if n_devices is None else devs[:n_devices]


def _spanning_mesh(n_slices: int, n_devices: Optional[int], devices
                   ) -> CorpusMesh:
    """A corpus mesh over this process's devices, spanning every process
    of the default group when one exists. ``n_devices`` then counts the
    devices of all processes and must split evenly over them: each
    process takes its first ``n_devices / P`` (the JAX package's
    ``jax.devices()[:n]`` could leave a process without a shard, which no
    caller asks for)."""
    group = process_group()
    if group is None:
        return CorpusMesh(_cuda_devices(n_devices, devices),
                          n_slices=n_slices)
    procs = dist.get_world_size(group)
    local = _cuda_devices(None, devices)
    if n_devices is not None:
        if n_devices % procs or n_devices // procs > len(local):
            raise ValueError(f"{n_devices} shards over {procs} processes of "
                             f"{len(local)} devices each")
        local = local[:n_devices // procs]
    return CorpusMesh(local, n_slices=n_slices, group=group)


def corpus_mesh(n_devices: Optional[int] = None, *,
                devices: Optional[Sequence] = None) -> CorpusMesh:
    """1-D mesh over the first ``n_devices`` CUDA devices (or of
    ``devices``), spanning the processes of the default group when one
    exists (:func:`initialize_distributed`)."""
    return _spanning_mesh(1, n_devices, devices)


def multislice_corpus_mesh(n_slices: int, n_devices: Optional[int] = None,
                           *, devices: Optional[Sequence] = None
                           ) -> CorpusMesh:
    """2-D ``(dcn, corpus)`` mesh: the first ``n_devices`` devices split
    row-major into ``n_slices`` slices (an indivisible count raises),
    spanning the processes of the default group when one exists."""
    return _spanning_mesh(n_slices, n_devices, devices)


def data_mesh(n_devices: Optional[int] = None, model_parallel: int = 1, *,
              devices: Optional[Sequence] = None,
              axis: str = MODEL_AXIS) -> DataMesh:
    """``(data, axis)`` grid over the first ``n_devices`` CUDA devices (or
    of ``devices``): ``n / model_parallel`` data rows of
    ``model_parallel`` devices. Without a card and without ``devices`` it
    raises."""
    return DataMesh(_cuda_devices(n_devices, devices, "a data mesh"),
                    model_parallel, axis=axis)


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


def initialize_distributed(device: str | torch.device = "cuda",
                           timeout_s: float = DIST_TIMEOUT_S) -> bool:
    """Multi-process runtime init, gated on ``VQT_COORDINATOR`` as in the
    reference: False when it is unset (one process serves every shard).

    With it set (``host:port`` of process 0's rendezvous), this process
    joins the default ``torch.distributed`` group at
    ``tcp://$VQT_COORDINATOR`` as rank ``VQT_PROCESS_ID`` of
    ``VQT_NUM_PROCESSES`` and returns True. The backend follows
    ``device``: NCCL for a CUDA device (bound to it; its process's first
    card by default), gloo for the CPU. A rendezvous or collective that
    does not complete within ``timeout_s`` raises instead of hanging; a
    failed NCCL init raises and is never retried on gloo. A second call
    where the group exists returns True with no new rendezvous (and
    raises if the group's backend is not the one ``device`` asks for)."""
    coord = os.environ.get("VQT_COORDINATOR")
    if not coord:
        return False
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}; "
                             f"a {dev.type} device needs {backend}")
        return True
    kw = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("VQT_COORDINATOR is set for a CUDA device but "
                               "torch.cuda.is_available() is False")
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}",
        world_size=int(os.environ["VQT_NUM_PROCESSES"]),
        rank=int(os.environ["VQT_PROCESS_ID"]),
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True
