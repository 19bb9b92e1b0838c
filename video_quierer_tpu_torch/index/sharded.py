"""Corpus-sharded scans: per-shard top-k and a merge on the first device
(counterpart of ``video_quierer_tpu/index/sharded.py``).

The ``[N_pad, D]`` mirror is split row-wise over the shards of a
:class:`~video_quierer_tpu_torch.parallel.mesh.CorpusMesh`: shard ``i``
owns rows ``[i·S, (i+1)·S)`` and lives on ``mesh.devices[i]``. Every
shard's scan is launched on its device (the exact scans B8/B9, or the
candidate stages over the perm layout, B10/B11); the per-shard ``[B, k]``
lists are copied to the first device, concatenated in ascending shard
order and merged (:func:`merge_topk`, descending-stable), which gives the
single-device scan's order, ties included. On a multi-slice mesh the merge
is hierarchical: within each slice, then the slices' winners, as in the
reference.

Two layouts, as ``_sharded_topk`` of the reference:

- identity (``perm`` None): shard-local valid ``clip(valid - offset, 0,
  S)``, and the shard's rows offset back to global rows (pads stay
  ``_IMAX``);
- perm (a candidate impl with the mirror's ``perm`` column, split like the
  rows): liveness ``perm < valid`` against the GLOBAL live count, and the
  candidates are host rows already.

The reference runs the shards under one ``shard_map`` and merges with
``all_gather`` over ICI; here one process launches each shard's kernels in
turn (on one card, several shards share it) and the copies to the first
device are the collectives.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from video_quierer_tpu_torch.ops.topk import (
    APPROX_FETCH_CAP,
    MAX_K,
    _IMAX,
    candidate_stage,
    candidate_stage_int8,
    cosine_topk,
    cosine_topk_int8,
    merge_topk,
)
from video_quierer_tpu_torch.parallel.mesh import CorpusMesh

Pair = Tuple[torch.Tensor, torch.Tensor]


def _scan_impl(impl: str):
    """Per-shard scan: ``"exact"`` = :func:`cosine_topk` (B8), anything
    else the bf16 candidate stage over the perm layout (B10)."""
    if impl != "exact":
        return lambda emb, q, valid, *, k, perm=None: candidate_stage(
            emb, q, valid, k=k, perm=perm, prefix=False)
    return lambda emb, q, valid, *, k, perm=None: cosine_topk(
        emb, q, valid, k=k)


def _scan_impl_int8(impl: str):
    """Int8 twin: :func:`cosine_topk_int8` (B9) or the perm-layout int8
    candidate stage (B11)."""
    if impl != "exact":
        return lambda c, s, q, valid, *, k, perm=None: candidate_stage_int8(
            c, s, q, valid, k=k, perm=perm, prefix=False)
    return lambda c, s, q, valid, *, k, perm=None: cosine_topk_int8(
        c, s, q, valid, k=k)


def is_multislice(mesh: Optional[CorpusMesh]) -> bool:
    return mesh is not None and mesh.multislice


def shard_corpus(emb: torch.Tensor, mesh: CorpusMesh,
                 dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Split ``[N_pad, ...]`` row-wise into one contiguous tensor per shard,
    each on its shard's device (and cast to ``dtype`` when given).
    ``N_pad`` must divide evenly: the sharded index keeps capacity a
    multiple of the shard count times the kernels' blocks."""
    n_pad = emb.shape[0]
    if n_pad % mesh.n_shards:
        raise ValueError(f"N_pad={n_pad} not divisible by {mesh.n_shards} "
                         "shards")
    rows = n_pad // mesh.n_shards
    return [emb[i * rows:(i + 1) * rows].to(dev, dtype).contiguous()
            for i, dev in enumerate(mesh.devices)]


# a per-row column (the perm) splits like the rows
shard_corpus_vec = shard_corpus


def _gather_merge(parts: List[Pair], k: int) -> Pair:
    """Per-participant ``[B, k]`` lists → copied to the first one's device,
    concatenated in ascending participant order, merged to the top k."""
    dev = parts[0][0].device
    return merge_topk(torch.cat([v.to(dev) for v, _ in parts], dim=1),
                      torch.cat([i.to(dev) for _, i in parts], dim=1), k=k)


def _sharded_topk(operands: Tuple[List[torch.Tensor], ...],
                  queries: torch.Tensor, valid: int,
                  perm: Optional[List[torch.Tensor]], *, k: int,
                  mesh: CorpusMesh, impl: str, int8: bool) -> Pair:
    """Shared core of the four sharded scans. ``operands``: ``(emb,)`` or
    ``(codes, scales)``, each a list of per-shard tensors; ``perm`` the
    per-shard perm columns (candidate impls only) or None."""
    k_cap = MAX_K if impl == "exact" else APPROX_FETCH_CAP
    if k <= 0 or k > k_cap:
        raise ValueError(f"k must be in [1, {k_cap}], got {k}")
    if perm is not None and impl == "exact":
        raise ValueError("exact sharded scan requires an identity-layout "
                         "mirror (perm=None)")
    if any(len(op) != mesh.n_shards for op in operands):
        raise ValueError(f"expected {mesh.n_shards} shards per operand")
    shard_rows = operands[0][0].shape[0]
    scan = _scan_impl_int8(impl) if int8 else _scan_impl(impl)
    valid = int(valid)
    queries = queries.float()
    parts = []
    for i, dev in enumerate(mesh.devices):
        ops = [op[i] for op in operands]
        q = queries.to(dev)
        if perm is None:
            offset = i * shard_rows
            local = min(max(valid - offset, 0), shard_rows)
            vals, idxs = scan(*ops, q, local, k=k)
            idxs = torch.where(idxs < _IMAX, idxs + offset, idxs)
        else:
            vals, idxs = scan(*ops, q, valid, k=k, perm=perm[i])
        parts.append((vals, idxs))
    per = mesh.per_slice
    slices = [_gather_merge(parts[s * per:(s + 1) * per], k)
              for s in range(mesh.n_slices)]
    return slices[0] if len(slices) == 1 else _gather_merge(slices, k)


def sharded_cosine_topk(emb: List[torch.Tensor], queries: torch.Tensor,
                        valid: int, *, k: int, mesh: CorpusMesh,
                        impl: str = "exact",
                        perm: Optional[List[torch.Tensor]] = None) -> Pair:
    """Top-k over a corpus-sharded matrix (f32 or bf16 shards from
    :func:`shard_corpus`): ``(scores [B, k], global rows [B, k])`` on the
    mesh's first device. ``impl="exact"`` (``k <= MAX_K``) is
    descending-stable; a candidate impl (``k <= APPROX_FETCH_CAP``) with
    ``perm`` returns host rows."""
    return _sharded_topk((emb,), queries, valid, perm, k=k, mesh=mesh,
                         impl=impl, int8=False)


def multislice_cosine_topk(emb: List[torch.Tensor], queries: torch.Tensor,
                           valid: int, *, k: int, mesh: CorpusMesh,
                           impl: str = "exact",
                           perm: Optional[List[torch.Tensor]] = None
                           ) -> Pair:
    """:func:`sharded_cosine_topk` over a multi-slice mesh: merged within
    each slice, then across slices."""
    return _sharded_topk((emb,), queries, valid, perm, k=k, mesh=mesh,
                         impl=impl, int8=False)


def sharded_cosine_topk_int8(codes: List[torch.Tensor],
                             scales: List[torch.Tensor],
                             queries: torch.Tensor, valid: int, *, k: int,
                             mesh: CorpusMesh, impl: str = "exact",
                             perm: Optional[List[torch.Tensor]] = None
                             ) -> Pair:
    """Int8 twin of :func:`sharded_cosine_topk` (callers re-rank in f32)."""
    return _sharded_topk((codes, scales), queries, valid, perm, k=k,
                         mesh=mesh, impl=impl, int8=True)


def multislice_cosine_topk_int8(codes: List[torch.Tensor],
                                scales: List[torch.Tensor],
                                queries: torch.Tensor, valid: int, *,
                                k: int, mesh: CorpusMesh,
                                impl: str = "exact",
                                perm: Optional[List[torch.Tensor]] = None
                                ) -> Pair:
    """Int8 twin of :func:`multislice_cosine_topk`."""
    return _sharded_topk((codes, scales), queries, valid, perm, k=k,
                         mesh=mesh, impl=impl, int8=True)
