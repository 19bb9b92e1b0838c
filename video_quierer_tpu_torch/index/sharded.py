"""Corpus-sharded scans: per-shard top-k and the merge (counterpart of
``video_quierer_tpu/index/sharded.py``).

The ``[N_pad, D]`` mirror is split row-wise over the shards of a
:class:`~video_quierer_tpu_torch.parallel.mesh.CorpusMesh`: shard ``i``
owns rows ``[i·S, (i+1)·S)``. Each process places and scans only its own
shards (``mesh.devices[j]`` holds shard ``mesh.first_shard + j``): the
exact scans B8/B9, or the candidate stages over the perm layout, B10/B11.
The per-shard ``[B, k]`` lists merge in ascending shard order
(:func:`merge_topk`, descending-stable), which gives the single-device
scan's order, ties included. On a multi-slice mesh the merge is
hierarchical, as in the reference: within each slice (the ICI stage),
then the slices' winners (the DCN stage).

In one process every list is copied to the first device and merged there.
On a mesh that spans processes (``mesh.multiprocess``) each process
merges the slices it holds whole, then exchanges what crosses processes
with ONE ``all_gather`` of a fixed-shape tensor over the mesh's group: a
whole slice's ``[B, k]`` winners, or, for a slice that spans processes,
its local shards' lists (padded with ``(-inf, _IMAX)`` entries, as B8's
pads). Every process then merges in ascending slice order, so every
process returns the same rows, equal to the one-process merge's.

Two layouts, as ``_sharded_topk`` of the reference:

- identity (``perm`` None): shard-local valid ``clip(valid - offset, 0,
  S)``, and the shard's rows offset back to global rows (pads stay
  ``_IMAX``);
- perm (a candidate impl with the mirror's ``perm`` column, split like the
  rows): liveness ``perm < valid`` against the GLOBAL live count, and the
  candidates are host rows already.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

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


def local_rows(n_pad: int, mesh: CorpusMesh) -> Tuple[int, int]:
    """``[lo, hi)``: the rows of ``[N_pad, ...]`` this process's shards
    own. ``N_pad`` must divide evenly: the sharded index keeps capacity a
    multiple of the shard count times the kernels' blocks."""
    if n_pad % mesh.n_shards:
        raise ValueError(f"N_pad={n_pad} not divisible by {mesh.n_shards} "
                         "shards")
    rows = n_pad // mesh.n_shards
    return mesh.first_shard * rows, (mesh.first_shard + mesh.n_local) * rows


def place_local(block: torch.Tensor, mesh: CorpusMesh,
                dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """This process's rows (``block``, the ``[lo, hi)`` of
    :func:`local_rows`) split into one contiguous tensor per local shard,
    each on its shard's device (and cast to ``dtype`` when given)."""
    rows = block.shape[0] // mesh.n_local
    return [block[j * rows:(j + 1) * rows].to(dev, dtype).contiguous()
            for j, dev in enumerate(mesh.devices)]


def shard_corpus(emb: torch.Tensor, mesh: CorpusMesh,
                 dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Split ``[N_pad, ...]`` row-wise and place this process's shards:
    one contiguous tensor per local shard, on its device (cast to
    ``dtype`` when given)."""
    lo, hi = local_rows(emb.shape[0], mesh)
    return place_local(emb[lo:hi], mesh, dtype)


# a per-row column (the perm) splits like the rows
shard_corpus_vec = shard_corpus


def _gather_merge(parts: List[Pair], k: int) -> Pair:
    """Per-participant ``[B, k]`` lists → copied to the first one's device,
    concatenated in ascending participant order, merged to the top k."""
    dev = parts[0][0].device
    return merge_topk(torch.cat([v.to(dev) for v, _ in parts], dim=1),
                      torch.cat([i.to(dev) for _, i in parts], dim=1), k=k)


Entry = Tuple[str, int]


def exchange_plan(mesh: CorpusMesh) -> List[List[Entry]]:
    """What each process sends in the cross-process exchange, in order:
    ``("slice", s)`` for a slice it holds whole (merged locally), else
    ``("shard", i)`` for each of its shards of a slice that spans
    processes. Every process derives the same plan from the mesh."""
    per, n_local = mesh.per_slice, mesh.n_local
    plan = []
    for p in range(mesh.process_count):
        lo, hi = p * n_local, (p + 1) * n_local
        entries: List[Entry] = []
        for s in range(lo // per, -(-hi // per)):
            s_lo, s_hi = s * per, (s + 1) * per
            if lo <= s_lo and s_hi <= hi:
                entries.append(("slice", s))
            else:
                entries += [("shard", i)
                            for i in range(max(lo, s_lo), min(hi, s_hi))]
        plan.append(entries)
    return plan


# bit pattern of the -inf pad score in the exchange's int32 buffer
_NEG_INF_BITS = int(torch.tensor(float("-inf")).view(torch.int32))


def _cross_process_merge(parts: List[Pair], k: int,
                         mesh: CorpusMesh) -> Pair:
    """The merge of a mesh that spans processes: the ICI stage (slices
    held whole, merged here), ONE ``all_gather`` over the mesh's group of
    an ``[E, B, 2, k]`` int32 buffer (scores as their bits, then rows;
    ``E`` the longest plan, shorter ones padded with ``(-inf, _IMAX)``),
    the spanning slices' merges and the DCN stage, in ascending slice
    order. ``parts``: this process's shards' lists, in shard order."""
    local = dict(zip(mesh.local_shards, parts))
    per = mesh.per_slice
    plan = exchange_plan(mesh)
    sent = []
    for kind, x in plan[mesh.process_index]:
        sent.append(local[x] if kind == "shard" else _gather_merge(
            [local[i] for i in range(x * per, (x + 1) * per)], k))
    dev = parts[0][0].device
    b = parts[0][0].shape[0]
    width = max(len(entries) for entries in plan)
    buf = torch.empty((width, b, 2, k), dtype=torch.int32, device=dev)
    buf[:, :, 0] = _NEG_INF_BITS
    buf[:, :, 1] = _IMAX
    for e, (vals, idxs) in enumerate(sent):
        buf[e, :, 0] = vals.to(dev, torch.float32).view(torch.int32)
        buf[e, :, 1] = idxs.to(dev, torch.int32)
    out = [torch.empty_like(buf) for _ in range(mesh.process_count)]
    dist.all_gather(out, buf, group=mesh.group)
    got: Dict[Entry, Pair] = {}
    for p, entries in enumerate(plan):
        for e, entry in enumerate(entries):
            got[entry] = (out[p][e, :, 0].view(torch.float32),
                          out[p][e, :, 1])
    slices = [got[("slice", s)] if ("slice", s) in got else _gather_merge(
        [got[("shard", i)] for i in range(s * per, (s + 1) * per)], k)
        for s in range(mesh.n_slices)]
    return slices[0] if len(slices) == 1 else _gather_merge(slices, k)


def _sharded_topk(operands: Tuple[List[torch.Tensor], ...],
                  queries: torch.Tensor, valid: int,
                  perm: Optional[List[torch.Tensor]], *, k: int,
                  mesh: CorpusMesh, impl: str, int8: bool) -> Pair:
    """Shared core of the four sharded scans. ``operands``: ``(emb,)`` or
    ``(codes, scales)``, each a list of this process's per-shard tensors;
    ``perm`` the per-shard perm columns (candidate impls only) or None."""
    k_cap = MAX_K if impl == "exact" else APPROX_FETCH_CAP
    if k <= 0 or k > k_cap:
        raise ValueError(f"k must be in [1, {k_cap}], got {k}")
    if perm is not None and impl == "exact":
        raise ValueError("exact sharded scan requires an identity-layout "
                         "mirror (perm=None)")
    if any(len(op) != mesh.n_local for op in operands):
        raise ValueError(f"expected {mesh.n_local} local shards per operand")
    shard_rows = operands[0][0].shape[0]
    scan = _scan_impl_int8(impl) if int8 else _scan_impl(impl)
    valid = int(valid)
    queries = queries.float()
    parts = []
    for j, dev in enumerate(mesh.devices):
        ops = [op[j] for op in operands]
        q = queries.to(dev)
        if perm is None:
            offset = (mesh.first_shard + j) * shard_rows
            local = min(max(valid - offset, 0), shard_rows)
            vals, idxs = scan(*ops, q, local, k=k)
            idxs = torch.where(idxs < _IMAX, idxs + offset, idxs)
        else:
            vals, idxs = scan(*ops, q, valid, k=k, perm=perm[j])
        parts.append((vals, idxs))
    if mesh.multiprocess:
        return _cross_process_merge(parts, k, mesh)
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
    mesh's first device (this process's; the same rows on every process).
    ``impl="exact"`` (``k <= MAX_K``) is descending-stable; a candidate
    impl (``k <= APPROX_FETCH_CAP``) with ``perm`` returns host rows."""
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
