"""IVF-Flat approximate index: k-means on the device and the cluster-tile
probe scan (counterpart of ``video_quierer_tpu/index/ivf.py``).

The system's approximate nearest-neighbour tier, which the engine serves
when ``index.kind = "ivf"``:

- **Build** (:meth:`IVFIndex.build`): spherical k-means on the index's
  device (:func:`_kmeans`: chunked f32 products, first-maximum argmax,
  ``index_add_`` sums and counts, empty clusters keep their centroid);
  cluster sizes capped at ``balance_factor * N / nlist`` on the host
  (:func:`_rebalance`); the rows packed cluster by cluster into
  ``BLOCK_ROWS``-row tiles ``[T + 1, BLOCK_ROWS, D]`` f32 on the device
  with their global row ids (-1 for padding; the last tile is all
  padding). The host steps are numpy copies of the reference's: which
  rows are evicted, and so the tiles, depend on ``np.argpartition``'s and
  ``np.argsort(kind="stable")``'s orders.
- **Search** (:meth:`IVFIndex.search`): on the host each query is scored
  against the centroids and takes the first tiles of its ``nprobe`` best
  clusters (:meth:`IVFIndex._probe_pairs`); one call of
  :func:`probe_scan` (kernel B12 on CUDA tensors: a plan, a scan and a
  merge kernel, no host sync) takes the top k of every (query, tile)
  pair; the host merges each query's candidates
  (:func:`_merge_pairs`) and the exact scan of the fresh buffer, the rows
  appended since the build (:meth:`IVFIndex._merge_fresh`).

Results are exact within the probed clusters (true f32 cosines); recall
follows ``nprobe / nlist``.

On a corpus mesh (``mesh``, the engine's index mesh; on a multi-slice
mesh the devices of its first slice) the tier is distributed as in the
reference: clusters go greedily, largest first, to the least-loaded
device (:meth:`IVFIndex._pack_sharded`, a numpy copy: its tie orders decide
the tiles); each device holds its clusters' tiles plus one padding tile,
with global row ids; a search routes each probed cluster to its device's
slot list, sized to the exact worst case so no probe is dropped
(:meth:`IVFIndex._shard_pairs`), runs B12 on every device and merges
the per-device lists on the first one in device order
(``index/sharded.py:_gather_merge``).

Not carried over: the XLA gather path ``_probe_and_scan`` (on the CPU the
plain version :func:`probe_scan_ref` takes its place), and two XLA
compile-cache devices: the query padding to ``_QUERY_BUCKETS`` (padded
queries probe only the padding tile) and the mesh's rounding of the slot
count to a power of two (extra slots hold the padding tile); neither
changes a result. Nor the ``_pallas_mode()`` routing.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from video_quierer_tpu_torch.index.sharded import _gather_merge
from video_quierer_tpu_torch.ops import kernels
from video_quierer_tpu_torch.ops.topk import MAX_K, NEG_INF
from video_quierer_tpu_torch.parallel.mesh import CorpusMesh
from video_quierer_tpu_torch.utils.env import resolve_device

logger = logging.getLogger(__name__)

BLOCK_ROWS = 1024          # rows of one cluster tile (kernel B12's tile)
_ASSIGN_CHUNK = 65536      # rows per k-means assignment product
_PACK_CHUNK = 1 << 18      # rows per scatter of the device packing

Pair = Tuple[torch.Tensor, torch.Tensor]


# -- kernel B12 and its plain version -----------------------------------------

PROBE_GROUP = 8           # pairs of one tile a work item scores at once
PROBE_WINDOW = 8192       # pairs the plan groups together (one plan CTA)
PROBE_MAX_CHUNKS = 16     # chunks of 64 rows at most
PROBE_MAX_D = 768         # widest rows whose ring and queries fit on an SM


def probe_chunks(n_pairs: int) -> int:
    """Chunks the kernel cuts each probed tile into for a list of
    ``n_pairs`` pairs: the largest power of two in ``[2, 16]`` with at
    most 8,192 (pair, chunk) slots, so a short list (B = 1: 32 pairs, 16
    chunks of 64 rows) still gives every SM work and a long one keeps its
    items long."""
    chunks = 2
    while chunks < PROBE_MAX_CHUNKS and 2 * chunks * n_pairs <= 8192:
        chunks *= 2
    return chunks


def _select(scores: torch.Tensor, rid: torch.Tensor, k: int) -> Pair:
    """Per row of ``scores [R, N]``, the top ``k`` by (score desc, id asc)
    among the entries whose id ``rid [R, N]`` is >= 0; pads ``(-inf,
    -1)``."""
    scores = scores.masked_fill(rid < 0, NEG_INF)
    # ties break by global id: order the rows by id, then sort stably
    rid, order = torch.sort(rid, dim=-1, stable=True)
    scores = torch.gather(scores, 1, order)
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals = vals[:, :k]
    idxs = torch.gather(rid, 1, pos[:, :k]).masked_fill(vals == NEG_INF, -1)
    return vals.contiguous(), idxs.to(torch.int32).contiguous()


def _pair_scores(tiles: torch.Tensor, tl: torch.Tensor, qs: torch.Tensor
                 ) -> torch.Tensor:
    """f32 scores ``[P, BLOCK_ROWS]`` of tiles ``tl`` against queries
    ``qs [P, D]``, one batched product."""
    return torch.bmm(tiles[tl], qs[:, :, None])[..., 0]


def probe_scan_ref(tiles: torch.Tensor, ids: torch.Tensor,
                   tile_list: torch.Tensor, qidx: torch.Tensor,
                   queries: torch.Tensor, *, k: int) -> Pair:
    """Plain PyTorch version of kernel B12: for pair ``p``, the f32 scores
    of tile ``tile_list[p]``'s rows against query ``qidx[p]``, rows whose
    id is < 0 scored ``-inf``, and the top ``k`` by (score desc, id asc);
    ``([P, k] f32, [P, k] i32)``, pads ``(-inf, -1)``."""
    tl = tile_list.long()
    sc = _pair_scores(tiles, tl, queries[qidx.long()])
    return _select(sc, ids[tl], k)


def probe_plan_ref(ids: torch.Tensor, tile_list: torch.Tensor,
                   qidx: torch.Tensor, b: int) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Plain version of B12's plan (device-agnostic): the work groups and
    the pairs that get pads only.

    A pair is dead when its query is outside ``[0, b)``, its tile is
    negative, or every id of its tile is -1. Within each window of
    ``PROBE_WINDOW`` pairs the live ones are sorted stably by tile, and
    each tile's run is cut into groups of up to ``PROBE_GROUP`` pairs, in
    window order. Returns ``(groups [G, 2 + PROBE_GROUP] i32, dead [P]
    bool)``: a group's row is its tile, its pair count and its pairs (-1
    beyond the count). The kernel's work items are each group times each
    of the ``probe_chunks(P)`` chunks of the tile's rows, group-major."""
    p, dev = tile_list.shape[0], tile_list.device
    tl = tile_list.long()
    ok = (tl >= 0) & (qidx >= 0) & (qidx < b)
    empty = (ids < 0).all(dim=1)
    dead = ~ok | empty[tl.clamp(min=0)]
    groups = []
    for lo in range(0, p, PROBE_WINDOW):
        pos = torch.arange(lo, min(p, lo + PROBE_WINDOW), device=dev)
        pos = pos[~dead[pos]]
        tiles, order = torch.sort(tl[pos], stable=True)
        pos = pos[order]
        counts = torch.unique_consecutive(tiles, return_counts=True)[1]
        first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts,
                                        counts)
        rank = torch.arange(pos.shape[0], device=dev) - first
        gid = torch.cumsum((rank % PROBE_GROUP == 0).long(), 0) - 1
        n_groups = int(gid[-1]) + 1 if gid.numel() else 0
        table = torch.full((n_groups, 2 + PROBE_GROUP), -1,
                           dtype=torch.int32, device=dev)
        table[gid, 0] = tiles.int()
        table[gid, 2 + rank % PROBE_GROUP] = pos.int()
        table[:, 1] = torch.bincount(gid, minlength=n_groups).int()
        groups.append(table)
    groups = torch.cat(groups) if groups else torch.empty(
        (0, 2 + PROBE_GROUP), dtype=torch.int32, device=dev)
    return groups, dead


def probe_scan_items_ref(tiles: torch.Tensor, ids: torch.Tensor,
                         tile_list: torch.Tensor, qidx: torch.Tensor,
                         queries: torch.Tensor, *, k: int,
                         chunks: Optional[int] = None) -> Pair:
    """B12 as its kernel computes it, in plain PyTorch: the plan
    (:func:`probe_plan_ref`), a top-``k`` list per (pair, chunk) of every
    work item by :func:`probe_scan_ref`'s scoring, then each pair's chunk
    lists merged by the same (score desc, id asc) key; dead pairs pad.
    ``chunks`` defaults to the kernel's, :func:`probe_chunks`."""
    p, dev = tile_list.shape[0], tiles.device
    chunks = probe_chunks(p) if chunks is None else chunks
    rows = BLOCK_ROWS // chunks
    groups, _ = probe_plan_ref(ids, tile_list, qidx, queries.shape[0])
    # every pair with a tile and a query scored as probe_scan_ref scores
    # them (one batched product), each item's rows then cut from it
    valid = torch.nonzero((tile_list >= 0) & (qidx >= 0)
                          & (qidx < queries.shape[0])).flatten()
    scores = _pair_scores(tiles, tile_list[valid].long(),
                          queries[qidx[valid].long()])
    row_of = torch.full((p,), -1, dtype=torch.long, device=dev)
    row_of[valid] = torch.arange(valid.shape[0], device=dev)
    lists_v = torch.full((p, chunks, k), NEG_INF, device=dev)
    lists_i = torch.full((p, chunks, k), -1, dtype=torch.int32, device=dev)
    for tile, n, *pairs in groups.tolist():
        pairs = torch.tensor(pairs[:n], device=dev)
        sc = scores[row_of[pairs]]
        rid = ids[tile].expand(n, -1)
        for c in range(chunks):
            part = slice(c * rows, (c + 1) * rows)
            lists_v[pairs, c], lists_i[pairs, c] = _select(
                sc[:, part], rid[:, part], k)
    return _select(lists_v.view(p, chunks * k), lists_i.view(p, chunks * k),
                   k)


def probe_scan(tiles: torch.Tensor, ids: torch.Tensor,
               tile_list: torch.Tensor, qidx: torch.Tensor,
               queries: torch.Tensor, *, k: int) -> Pair:
    """Top ``k`` (``<= MAX_K``) of every (query, tile) pair in one call:
    tiles ``[T, BLOCK_ROWS, D]`` f32, ids ``[T, BLOCK_ROWS]`` i32 (-1 for
    padding), ``tile_list``/``qidx`` ``[P]`` i32 (entries in ``[0, T)`` and
    ``[0, B)``; a pair outside them pads), queries ``[B, D]`` f32 →
    ``([P, k] f32, [P, k] i32)``. Kernel B12 on CUDA tensors (its plan,
    scan and merge kernels on the current stream, no host sync; D at most
    ``PROBE_MAX_D``), the plain version on CPU ones."""
    if tiles.device.type == "cpu":
        return probe_scan_ref(tiles, ids, tile_list, qidx, queries, k=k)
    dev = kernels.require_cuda(tiles, ids, tile_list, qidx, queries)
    if tiles.dtype != torch.float32 or queries.dtype != torch.float32 \
            or ids.dtype != torch.int32 or tile_list.dtype != torch.int32 \
            or qidx.dtype != torch.int32:
        raise TypeError("the probe scan takes f32 tiles and queries and "
                        "int32 ids, tile list and query index")
    d = tiles.shape[-1]
    if tiles.ndim != 3 or tiles.shape[1] != BLOCK_ROWS \
            or ids.shape != tiles.shape[:2] or tile_list.ndim != 1 \
            or qidx.shape != tile_list.shape or queries.ndim != 2 \
            or queries.shape[1] != d or d % 4 or d > PROBE_MAX_D \
            or not 1 <= k <= MAX_K \
            or tiles.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError(f"unsupported probe scan: tiles {tuple(tiles.shape)}"
                         f" ids {tuple(ids.shape)} pairs "
                         f"{tuple(tile_list.shape)} queries "
                         f"{tuple(queries.shape)} k={k} (D a multiple of 4 "
                         f"up to {PROBE_MAX_D}, 16-byte aligned tiles and "
                         f"queries, k <= {MAX_K})")
    p = tile_list.shape[0]
    chunks = probe_chunks(p)
    lib = kernels.lib()
    vals = torch.empty((p, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((p, k), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.vqt_probe_scan_scratch(p, k, chunks),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        kernels.check(lib.vqt_probe_scan(
            kernels.ptr(tiles), kernels.ptr(ids), kernels.ptr(tile_list),
            kernels.ptr(qidx), kernels.ptr(queries), kernels.ptr(vals),
            kernels.ptr(idxs), kernels.ptr(scratch), p, tiles.shape[0], d,
            queries.shape[0], k, chunks, kernels.stream(dev)), "probe scan")
    kernels.count_launch(probe_scan)
    return vals, idxs


probe_scan.launches = 0


# -- build --------------------------------------------------------------------

def init_indices(n: int, n_clusters: int, seed: int) -> np.ndarray:
    """The k-means seeds: ``n_clusters`` distinct rows of ``n``, drawn from
    a seeded ``torch.Generator``. (The reference draws them with
    ``jax.random.choice``, whose bits the port cannot reproduce; its tests
    hand the reference's indices to :func:`_kmeans`.)"""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randperm(n, generator=g)[:n_clusters].numpy()


def _assign(emb: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of every row by f32 product, ``_ASSIGN_CHUNK``
    rows at a time; the first maximum wins, as ``jnp.argmax``."""
    return torch.cat([
        torch.argmax(emb[lo: lo + _ASSIGN_CHUNK] @ centroids.t(), dim=-1)
        for lo in range(0, emb.shape[0], _ASSIGN_CHUNK)])


def _kmeans(emb: torch.Tensor, init_idx: torch.Tensor, *, iters: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means of the unit rows ``emb [N, D]`` f32 from the seed
    rows ``init_idx [C]`` → ``(centroids [C, D], assignments [N] i64)``.
    The products are full f32 (TF32 off, the default of
    ``torch.backends.cuda.matmul.allow_tf32``); ``index_add_`` sums in no
    fixed order on CUDA, so centroids may differ in the last bits from
    build to build."""
    n_clusters = init_idx.shape[0]
    centroids = emb[init_idx]
    ones = torch.ones(emb.shape[0], dtype=emb.dtype, device=emb.device)
    for _ in range(iters):
        assign = _assign(emb, centroids)
        sums = torch.zeros_like(centroids).index_add_(0, assign, emb)
        counts = torch.zeros(n_clusters, dtype=emb.dtype,
                             device=emb.device).index_add_(0, assign, ones)
        norms = torch.linalg.vector_norm(sums, dim=-1, keepdim=True)
        fresh = sums / torch.clamp(norms, min=1e-10)
        # empty clusters keep their previous centroid
        centroids = torch.where(counts[:, None] > 0, fresh, centroids)
    return centroids, _assign(emb, centroids)


def _rebalance(emb: np.ndarray, centroids: np.ndarray,
               assign: np.ndarray, cap: int) -> np.ndarray:
    """Cap cluster sizes: over-full clusters keep their ``cap`` closest
    rows; evicted rows move to their best non-full cluster. Bounds
    ``max_tiles`` so the probe's tile budget never truncates live rows."""
    assign = assign.copy()
    nlist = centroids.shape[0]
    counts = np.bincount(assign, minlength=nlist)
    evicted = []
    for c in np.nonzero(counts > cap)[0]:
        rows = np.nonzero(assign == c)[0]
        sims = emb[rows] @ centroids[c]
        keep = np.argpartition(-sims, cap - 1)[:cap]
        mask = np.ones(rows.size, bool)
        mask[keep] = False
        evicted.extend(rows[mask].tolist())
        counts[c] = cap
    if not evicted:
        return assign
    evicted = np.asarray(evicted)
    sims = emb[evicted] @ centroids.T                      # [E, C]
    order = np.argsort(-sims, axis=1)
    for i, row in enumerate(evicted):
        for c in order[i]:
            if counts[c] < cap:
                assign[row] = c
                counts[c] += 1
                break
    return assign


def _pack(assign: np.ndarray, nlist: int):
    """Cluster-contiguous tile positions of every row: ``(order,
    tile_start [C + 1], tiles_per_cluster [C], tile, offset)`` — row
    ``order[i]`` goes to ``(tile[i], offset[i])``, each cluster's rows in
    ascending id order."""
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=nlist)
    tiles_per_cluster = np.maximum(1, -(-counts // BLOCK_ROWS))
    tile_start = np.concatenate([[0], np.cumsum(tiles_per_cluster)])
    sorted_assign = assign[order]
    cluster_first = np.concatenate([[0], np.cumsum(counts)])[:-1]
    ranks = np.arange(assign.shape[0]) - cluster_first[sorted_assign]
    tile = tile_start[sorted_assign] + ranks // BLOCK_ROWS
    return order, tile_start, tiles_per_cluster, tile, ranks % BLOCK_ROWS


class _Laps:
    """Seconds per build stage (the device synchronised at each lap)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.split: Dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.split[name] = now - self._t
        self._t = now


# -- search helpers -----------------------------------------------------------

def _merge_pairs(cand_v: np.ndarray, cand_i: np.ndarray, b: int, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per query, its pairs' live candidates (ids >= 0) in pair order,
    then a stable descending top ``k``; ``(-inf, -1)`` fills short rows."""
    cand_v = cand_v.reshape(b, -1)
    cand_i = cand_i.reshape(b, -1)
    out_vals = np.full((b, k), NEG_INF, np.float32)
    out_idxs = np.full((b, k), -1, np.int64)
    for qi in range(b):
        live = cand_i[qi] >= 0
        flat_v, flat_i = cand_v[qi][live], cand_i[qi][live]
        order = np.argsort(-flat_v, kind="stable")[:k]
        out_vals[qi, : order.size] = flat_v[order]
        out_idxs[qi, : order.size] = flat_i[order]
    return out_vals, out_idxs


class IVFIndex:
    """Cluster-pruned approximate index over a fixed embedding matrix.

    Built once from a corpus snapshot; appended rows go to an exactly
    scanned fresh buffer until it outgrows ``rebuild_fraction`` of the
    built rows (:meth:`rebuild` then folds them in). ``balance_factor``
    caps clusters at ``factor * N / nlist`` rows (0 disables balancing).
    The tiles, their ids and the centroids live on ``device`` (on a mesh:
    the tiles and ids split over its devices, the rest on the first); the
    centroids, ids and tile ranges also on the host, where the probe is
    chosen.
    """

    def __init__(self, nlist: Optional[int] = None, nprobe: int = 8,
                 kmeans_iters: int = 10, seed: int = 0,
                 balance_factor: float = 2.0,
                 rebuild_fraction: float = 0.25,
                 mesh: Optional[CorpusMesh] = None,
                 device: str | torch.device = "cuda"):
        if mesh is not None and mesh.multiprocess:
            raise ValueError("the IVF tier spreads over one process's "
                             "devices; on a mesh that spans processes each "
                             "process keeps its own replica (mesh=None)")
        self.mesh = mesh
        # a multi-slice mesh's first slice
        self._devices = None if mesh is None else mesh.devices[:mesh.per_slice]
        self.nlist = nlist
        self.nprobe = nprobe
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.balance_factor = balance_factor
        self.rebuild_fraction = rebuild_fraction
        self.device = resolve_device(device if mesh is None
                                     else mesh.devices[0])
        self._built = False
        self._fresh: Optional[np.ndarray] = None
        self._n_built = 0
        # seconds per stage of the last build, and the rows it evicted
        self.last_build: Dict[str, float] = {}

    def build(self, emb: np.ndarray) -> None:
        """``emb [N, D]`` float32 (unit rows recommended)."""
        emb = np.asarray(emb, np.float32)
        n, d = emb.shape
        nlist = self.nlist or max(16, 1 << int(np.log2(max(16, n ** 0.5))))
        nlist = min(nlist, max(16, n // 4))
        logger.info("IVF build: N=%d nlist=%d", n, nlist)
        laps = _Laps(self.device)
        emb_dev = torch.from_numpy(emb).to(self.device)
        laps.lap("upload")
        init = torch.from_numpy(init_indices(n, nlist, self.seed)).to(
            self.device)
        centroids, assign = _kmeans(emb_dev, init, iters=self.kmeans_iters)
        centroids_np = centroids.cpu().numpy()
        assign = assign.cpu().numpy()
        laps.lap("kmeans")
        evicted = 0
        if self.balance_factor > 0:
            cap = max(1, int(np.ceil(n / nlist * self.balance_factor)))
            balanced = _rebalance(emb, centroids_np, assign, cap)
            evicted = int((balanced != assign).sum())
            assign = balanced
        laps.lap("rebalance")
        order, tile_start, tiles_per_cluster, tile, offset = _pack(assign,
                                                                    nlist)
        total_tiles = int(tile_start[-1])
        # the last tile is all padding: unused probe slots point there
        tiled = torch.zeros((total_tiles + 1, BLOCK_ROWS, d),
                            dtype=torch.float32, device=self.device)
        for lo in range(0, n, _PACK_CHUNK):
            part = slice(lo, lo + _PACK_CHUNK)
            t, o, src = (torch.from_numpy(x[part]).to(self.device)
                         for x in (tile, offset, order))
            tiled[t, o] = emb_dev[src]
        del emb_dev
        row_ids = np.full((total_tiles + 1, BLOCK_ROWS), -1, np.int32)
        row_ids[tile, offset] = order
        self.nlist = nlist
        self._set_built(centroids_np, tiled, row_ids, tile_start[:-1],
                        tiles_per_cluster, n)
        laps.lap("pack")
        self.last_build = {**laps.split, "evicted": evicted}
        logger.info("IVF built: %d tiles (%.1f%% padding), %d rows evicted; "
                    "%s", total_tiles,
                    100 * (1 - n / (total_tiles * BLOCK_ROWS)), evicted,
                    ", ".join(f"{k} {v:.3f} s" for k, v in laps.split.items()))

    def _set_built(self, centroids: np.ndarray, tiled: torch.Tensor,
                   row_ids: np.ndarray, tile_start: np.ndarray,
                   tiles_per_cluster: np.ndarray, n_built: int) -> None:
        """Take a built state; ``tiled`` on any device (on a mesh it is
        split over the devices and not kept)."""
        self._centroids_np = np.array(centroids, np.float32)
        self._centroids = torch.from_numpy(self._centroids_np).to(self.device)
        self._row_ids = np.ascontiguousarray(row_ids, np.int32)
        self._pad_tile = tiled.shape[0] - 1
        self._tile_start_np = np.asarray(tile_start, np.int64)
        self._tile_counts_np = np.asarray(tiles_per_cluster, np.int64)
        self._max_tiles = int(self._tile_counts_np.max())
        self._median_tiles = int(np.median(self._tile_counts_np))
        if self.mesh is None:
            self._tiled = tiled.to(self.device)
            self._row_ids_dev = torch.from_numpy(self._row_ids).to(
                self.device)
        else:
            self._tiled = self._row_ids_dev = None
            self._pack_sharded(tiled)
        self._n_built = int(n_built)
        self._fresh = None
        self._built = True

    def _pack_sharded(self, tiled: torch.Tensor) -> None:
        """Distribute the cluster tiles over the mesh's devices: clusters
        by stable descending tile count, each onto the least-loaded device
        (the lowest on ties); every device's tiles padded to one count plus
        a padding tile (zeros, ids -1), which its unused slots point at.
        Row ids stay global."""
        n_dev = len(self._devices)
        counts = self._tile_counts_np
        nlist = counts.shape[0]
        dev_of = np.zeros(nlist, np.int32)
        local_start = np.zeros(nlist, np.int64)
        load = np.zeros(n_dev, np.int64)
        for c in np.argsort(-counts, kind="stable"):
            d = int(np.argmin(load))
            dev_of[c] = d
            local_start[c] = load[d]
            load[d] += counts[c]
        t_local = max(1, int(load.max()))
        # each device's local tile -> global tile (the global padding tile
        # for unused slots and the local padding tile)
        src = np.full((n_dev, t_local + 1), self._pad_tile, np.int64)
        for c in range(nlist):
            s, g, n_t = local_start[c], self._tile_start_np[c], counts[c]
            src[dev_of[c], s: s + n_t] = np.arange(g, g + n_t)
        self._sh_tiled = [
            tiled[torch.from_numpy(src[d]).to(tiled.device)].to(dev)
            for d, dev in enumerate(self._devices)]
        self._sh_ids = [torch.from_numpy(self._row_ids[src[d]]).to(dev)
                        for d, dev in enumerate(self._devices)]
        self._cluster_dev = dev_of
        self._cluster_local_start = local_start
        self._local_pad_tile = t_local
        self._dev_load = load

    @classmethod
    def load_built(cls, centroids: np.ndarray, tiled: np.ndarray,
                   row_ids: np.ndarray, tile_start: np.ndarray,
                   tile_counts: np.ndarray, n_built: int, nlist: int,
                   nprobe: int, fresh: Optional[np.ndarray] = None,
                   mesh: Optional[CorpusMesh] = None,
                   device: str | torch.device = "cuda") -> "IVFIndex":
        """An index over a built state: centroids ``[C, D]``, tiles ``[T +
        1, BLOCK_ROWS, D]`` (the last all padding) and their row ids,
        each cluster's first tile and tile count, the built row count and
        the fresh buffer — the reference index's attributes as numpy
        arrays (on a mesh, packed onto its devices from them). It
        searches exactly what that index searches."""
        ivf = cls(nlist=nlist, nprobe=nprobe, mesh=mesh, device=device)
        tiled = torch.from_numpy(np.array(tiled, np.float32))
        ivf._set_built(centroids, tiled,
                       np.array(row_ids, np.int32).reshape(tiled.shape[:2]),
                       tile_start, tile_counts, n_built)
        if fresh is not None:
            ivf._fresh = np.array(fresh, np.float32)
        return ivf

    def stats(self) -> dict:
        """Operator-facing tier stats (``/api/stats`` through the
        engine)."""
        if not self._built:
            return {"built": False}
        total_tiles = int(self._tile_counts_np.sum())
        return {
            "built": True,
            "nlist": int(self.nlist),
            "nprobe": int(self.nprobe),
            "rows": int(self._n_built),
            "fresh_rows": 0 if self._fresh is None
            else int(self._fresh.shape[0]),
            "tiles": total_tiles,
            "max_tiles_per_cluster": int(self._max_tiles),
            "padding_pct": round(
                100 * (1 - self._n_built
                       / max(1, total_tiles * BLOCK_ROWS)), 2),
            "scanned_fraction": round(
                min(1.0, self.nprobe / max(1, self.nlist)), 4),
            **({"devices": len(self._devices),
                "tiles_per_device": self._dev_load.tolist()}
               if self.mesh is not None else {}),
        }

    def add(self, emb_new: np.ndarray) -> None:
        """Append rows without rebuilding: they land in the fresh buffer,
        with global ids continuing after the built corpus. The rows are
        copied: callers pass live slices of the index's host store, which
        ``remove_video`` compacts in place."""
        if not self._built:
            raise RuntimeError("IVFIndex.build() first")
        emb_new = np.array(emb_new, np.float32)
        self._fresh = emb_new if self._fresh is None else \
            np.concatenate([self._fresh, emb_new])

    @property
    def needs_rebuild(self) -> bool:
        return self._fresh is not None and \
            self._fresh.shape[0] > self.rebuild_fraction * self._n_built

    def _reconstruct_corpus(self) -> np.ndarray:
        """The built corpus, recovered from the tiles (no separate copy is
        kept)."""
        parts = ([(self._tiled, self._row_ids_dev)] if self.mesh is None
                 else zip(self._sh_tiled, self._sh_ids))
        emb = torch.empty((self._n_built, self._centroids.shape[-1]),
                          dtype=torch.float32, device=self.device)
        for tiled, ids in parts:
            mask = ids >= 0
            emb[ids[mask].long().to(self.device)] = tiled[mask].to(
                self.device)
        return emb.cpu().numpy()

    def rebuild(self) -> None:
        """Fold the fresh buffer into the clustered tiles."""
        if self._fresh is None:
            return
        merged = np.concatenate([self._reconstruct_corpus(), self._fresh])
        self.build(merged)

    def tile_budget(self) -> int:
        """Tiles a probed cluster contributes at most: 4x the median
        cluster, so skewed k-means clusters keep the scan bounded."""
        return min(self._max_tiles, max(1, 4 * self._median_tiles))

    def search(self, queries: np.ndarray, k: int = 5,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Normalized queries ``[B, D]`` or ``[D]`` → (scores, row ids);
        missing slots (fewer than k candidates probed) hold -inf / -1."""
        if not self._built:
            raise RuntimeError("IVFIndex.build() first")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"k must be in [1, {MAX_K}]")
        nprobe = min(nprobe or self.nprobe, self.nlist)
        queries = np.asarray(queries, np.float32)
        squeeze = queries.ndim == 1
        if squeeze:
            queries = queries[None]
        search = (self._search_probe if self.mesh is None
                  else self._search_sharded)
        vals, idxs = search(queries, k, nprobe)
        if self._fresh is not None and self._fresh.shape[0] > 0:
            vals, idxs = self._merge_fresh(queries, vals, idxs, k)
        if squeeze:
            return vals[0], idxs[0]
        return vals, idxs

    def _probe_pairs(self, queries: np.ndarray, nprobe: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """The flat (tile, query) pair list: query ``qi`` owns slots ``[qi
        · S, (qi + 1) · S)``, ``S = nprobe · tile_budget()``, filled with
        the first tiles of its ``nprobe`` best clusters (in
        ``np.argpartition`` order); unused slots point at the padding
        tile."""
        b = queries.shape[0]
        budget = self.tile_budget()
        slots = nprobe * budget
        csims = queries @ self._centroids_np.T                  # [B, C]
        tile_list = np.full(b * slots, self._pad_tile, np.int32)
        qidx = np.repeat(np.arange(b, dtype=np.int32), slots)
        for qi in range(b):
            clusters = np.argpartition(-csims[qi], nprobe - 1)[:nprobe]
            starts = self._tile_start_np[clusters]
            counts = np.minimum(self._tile_counts_np[clusters], budget)
            pos = qi * slots
            for s, c in zip(starts, counts):
                tile_list[pos: pos + c] = np.arange(s, s + c)
                pos += c
        return tile_list, qidx

    def _search_probe(self, queries: np.ndarray, k: int, nprobe: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """The probed clusters' top ``k`` per query: the pair list on the
        host, one :func:`probe_scan` over it, the merge on the host."""
        tile_list, qidx = self._probe_pairs(queries, nprobe)
        vals, idxs = probe_scan(
            self._tiled, self._row_ids_dev,
            *(torch.from_numpy(x).to(self.device)
              for x in (tile_list, qidx, queries)), k=k)
        return _merge_pairs(vals.cpu().numpy(), idxs.cpu().numpy(),
                            queries.shape[0], k)

    def _shard_pairs(self, queries: np.ndarray, nprobe: int
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
        """The mesh's per-device pair lists: each query's clusters (best
        first) routed to their devices' slot lists, ``S`` slots per query
        and device, ``S`` the exact worst case over the batch so no probed
        cluster is dropped, unused slots on the local padding tile.
        Returns ``(tile_lists [n_dev, B·S] i32, qidx [B·S] i32, S)``."""
        b, n_dev = queries.shape[0], len(self._devices)
        budget = self.tile_budget()
        csims = queries @ self._centroids_np.T                  # [B, C]
        probes, slots = [], 1
        for qi in range(b):
            cl = np.argpartition(-csims[qi], nprobe - 1)[:nprobe]
            cl = cl[np.argsort(-csims[qi][cl], kind="stable")]
            probes.append(cl)
            per_dev = np.zeros(n_dev, np.int64)
            np.add.at(per_dev, self._cluster_dev[cl],
                      np.minimum(self._tile_counts_np[cl], budget))
            slots = max(slots, int(per_dev.max()))
        tile_lists = np.full((n_dev, b * slots), self._local_pad_tile,
                             np.int32)
        for qi, cl in enumerate(probes):
            cursor = np.full(n_dev, qi * slots, np.int64)
            for c in cl:
                d, s = self._cluster_dev[c], self._cluster_local_start[c]
                cnt = int(min(self._tile_counts_np[c], budget))
                tile_lists[d, cursor[d]: cursor[d] + cnt] = np.arange(
                    s, s + cnt)
                cursor[d] += cnt
        qidx = np.repeat(np.arange(b, dtype=np.int32), slots)
        return tile_lists, qidx, slots

    def _search_sharded(self, queries: np.ndarray, k: int, nprobe: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """The mesh's probe: the per-device pair lists
        (:meth:`_shard_pairs`); B12 on every device; the per-device ``[B,
        S·k]`` lists merged on the first device in device order; pads
        ``(-inf, -1)``."""
        b = queries.shape[0]
        tile_lists, qidx, slots = self._shard_pairs(queries, nprobe)
        parts = []
        for d, dev in enumerate(self._devices):
            v, i = probe_scan(self._sh_tiled[d], self._sh_ids[d],
                              *(torch.from_numpy(x).to(dev) for x in (
                                  tile_lists[d], qidx, queries)), k=k)
            parts.append((v.view(b, slots * k), i.view(b, slots * k)))
        vals, idxs = _gather_merge(parts, k)
        out_v = vals.cpu().numpy()
        out_i = idxs.cpu().numpy().astype(np.int64)
        dead = ~np.isfinite(out_v)
        out_i[dead] = -1
        out_v[dead] = NEG_INF
        return out_v, out_i

    def _merge_fresh(self, queries: np.ndarray, vals: np.ndarray,
                     idxs: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact-scan the fresh buffer and merge it into the probed
        results (stable: probed candidates first on equal scores)."""
        fresh_scores = queries @ self._fresh.T                # [B, F]
        f = self._fresh.shape[0]
        fresh_ids = self._n_built + np.arange(f)
        out_v = np.full_like(vals, NEG_INF)
        out_i = np.full_like(idxs, -1)
        for b in range(vals.shape[0]):
            live = idxs[b] >= 0
            cand_v = np.concatenate([vals[b][live], fresh_scores[b]])
            cand_i = np.concatenate([idxs[b][live], fresh_ids])
            order = np.argsort(-cand_v, kind="stable")[:k]
            out_v[b, : order.size] = cand_v[order]
            out_i[b, : order.size] = cand_i[order]
        return out_v, out_i
