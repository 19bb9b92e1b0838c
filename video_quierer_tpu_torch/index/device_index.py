"""Device-resident video frame index (counterpart of
``video_quierer_tpu/index/device_index.py``).

Host-authoritative: the f32 rows, metadata columns and the pickle v1.0
cache live on the host, exactly as in the reference (the cache format is
an exact-parity surface: a cache written by either package loads in the
other). The device holds a **mirror** of the rows in ``device_dtype``:

- ``"float32"`` (the default, the exact tier): the rows in the identity
  layout; :func:`~video_quierer_tpu_torch.ops.topk.cosine_topk` scans it
  exactly and its scores are the results;
- ``"bfloat16"``, ``"int8"`` (codes + per-row f32 scales), ``"int4"``
  (split-halves packed codes + scales): candidate mirrors, on one card in
  the live-PREFIX layout: live rows fill mirror positions ``[0, count)`` in a
  uniformly shuffled order kept by incremental Fisher–Yates on append
  (:meth:`_extend_perm_to`, with the reference's numpy seeds, so both
  packages build the identical ``perm``), so near-duplicate adjacent
  frames scatter across the candidate scan's selection buckets; ``perm``
  (mirror position → host row) rides beside it. The candidate stage
  over-fetches host rows, re-ranked exactly against an identity-layout
  **re-rank store** (f32 by default) on the device when ``device_rerank``
  is active (``_device_exact_rerank``: (score desc, row asc) by two stable
  sorts), else on the host (:meth:`_rerank_f32`).

Three mirror layouts (:meth:`_mirror_layout`), as in the reference:
``"id"`` (the f32 tier; the bf16 and int8 mirrors under the
exact-candidate hatch ``VQT_CANDIDATE_TOPK=pallas``, whose exact scans
need it), ``"prefix"`` (the candidate mirrors on one card) and ``"perm"``
(the candidate mirrors on a corpus mesh: a fixed full-capacity
permutation, :meth:`_require_perm`, so live rows spread evenly over the
shards at any fill level). A layout change between searches (the hatch
flipped) re-places the mirror.

**Corpus meshes** (``mesh``, a
:class:`~video_quierer_tpu_torch.parallel.mesh.CorpusMesh`; not int4):
capacity is a multiple of the shard count times the kernels' blocks, the
mirror (rows or codes, scales, perm column) is split row-wise over the
shards' devices (``index/sharded.py``), and every search runs the
per-shard scans and the merge; candidates re-rank on the host. Any change
re-places the whole mirror at the next search (appends do not stream into
it), as in the reference. On a mesh that spans processes each process's
mirror holds only its own shards (:meth:`_full_place` quantizes and
uploads only those rows), while every process keeps the whole host f32
store, as every JAX process holds the same host arrays: the f32 re-rank,
the host video ranking and the similar-frame lookups stay local, and a
search's one collective is the merge's ``all_gather``. Every process
must then make the same searches in the same order.

Searches: :meth:`search_batch` (query vectors) and
:meth:`search_batch_fused_async` (token ids: text encode + scan + re-rank
enqueued on the device, resolved later) — the serving coalescer's
dispatch/resolve contract.

Ingest appends stream from the device (:meth:`add_batch_device`,
:meth:`stream_rows_device`): the host store takes the embedder's fetched
rows, and the mirrors are updated from the embedder's device output by
torch index operations — relocate the rows the Fisher–Yates inserts
displaced, cast or quantize the new rows, update the perm column, append
to the re-rank store — with no host→device copy of the features. The
result is bit-identical to the host sync path's. The index's device
tensors are always made and updated outside ``torch.inference_mode``, so
an append may come from inside it or not.

Video-level search (:meth:`search_videos`): per-video f64 embedding
sums and frame counts are kept at every append, removal and load, as the
reference keeps them; the videos rank by the cosine of the query with
their mean rows, and each winner's best frame is its highest-scoring row.
On one device with exact f32 rows on the card (the f32 mirror, or the
f32 re-rank store of the quantized tiers while the device re-rank is
active) the ranking and the best frames run on the device
(:func:`video_rank_device`: two GEMVs, a stable sort, masked first-max
argmaxes); elsewhere (a corpus mesh, a bf16 store, the re-rank on the
host) on the host over the means and each winner's own rows.
"""

from __future__ import annotations

import hashlib
import io
import logging
import math
import os
import pickle
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from video_quierer_tpu_torch.index.sharded import (
    is_multislice,
    local_rows,
    multislice_cosine_topk,
    multislice_cosine_topk_int8,
    place_local,
    sharded_cosine_topk,
    sharded_cosine_topk_int8,
)
from video_quierer_tpu_torch.ops.quantize import (
    quantize_rows,
    quantize_rows_int4,
    quantize_rows_int4_np,
    quantize_rows_np,
)
from video_quierer_tpu_torch.ops.topk import (
    APPROX_FETCH_CAP,
    CAND_BLOCK_ROWS,
    MAX_K,
    SCAN_TILE_ROWS,
    _approx_fetch,
    _candidate_mode,
    candidate_topk,
    candidate_topk_int4,
    candidate_topk_int8,
    cosine_topk,
)
from video_quierer_tpu_torch.parallel.mesh import CorpusMesh
from video_quierer_tpu_torch.utils.env import resolve_device
from video_quierer_tpu_torch.utils.stageprof import span

logger = logging.getLogger(__name__)

EMBED_DIM = 512
# Capacity granularity: the reference's (lcm of its exact-scan macro block
# and the candidate block), so both packages pad capacity identically —
# the Fisher–Yates seeds depend on it.
_CHUNK = math.lcm(8 * 1024, CAND_BLOCK_ROWS)
CACHE_VERSION = "1.0"
_IMAX = 2**31 - 1
_NEG_INF = float("-inf")
DEVICE_DTYPES = ("float32", "bfloat16", "int8", "int4")


# video-table padding granularity of the device ranking (the reference's)
_LANES_PAD = 128


def _round_capacity(n: int, granularity: int = _CHUNK) -> int:
    return max(granularity, -(-n // granularity) * granularity)


class _SafeUnpickler(pickle.Unpickler):
    """Unpickler restricted to the types the v1.0 cache uses (lists,
    dicts, str, numbers, numpy arrays)."""

    _ALLOWED = {
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"cache file requests forbidden global {module}.{name}")


def safe_pickle_loads(payload: bytes):
    return _SafeUnpickler(io.BytesIO(payload)).load()


def _device_exact_rerank(rows_store: torch.Tensor, q: torch.Tensor,
                         cand: torch.Tensor, valid: int, k: int):
    """Exact re-rank of candidate host rows on the device — the twin of
    :meth:`DeviceVideoIndex._rerank_f32`: dead/pad candidates and
    duplicate rows drop, order is (score desc, host row asc). ``cand
    [B, fetch]`` host rows; returns ``([B, k] f32, [B, k] i32)`` with
    ``-inf``/pad entries for short rows."""
    n_pad = rows_store.shape[0]
    cand = cand.to(torch.int32)
    rows = rows_store[torch.clamp(cand, 0, n_pad - 1).long()].float()
    exact = torch.einsum("bfd,bd->bf", rows, q.float())
    # duplicate drop: sort by row id, mask equal neighbours
    ids_s, order = torch.sort(cand, dim=-1, stable=True)
    sc_s = torch.gather(exact, 1, order)
    prev = torch.cat([torch.full_like(ids_s[:, :1], -1), ids_s[:, :-1]],
                     dim=1)
    dead = (ids_s == prev) | (ids_s >= valid)
    sc_s = sc_s.masked_fill(dead, _NEG_INF)
    ids_s = ids_s.masked_fill(dead, _IMAX)
    # ids are ascending, so a stable descending sort by score gives
    # (score desc, row asc)
    sc_f, order = torch.sort(sc_s, dim=-1, descending=True, stable=True)
    return sc_f[:, :k], torch.gather(ids_s, 1, order)[:, :k]


def _sequential_sums(rows: np.ndarray, ids: np.ndarray, n_groups: int
                     ) -> np.ndarray:
    """``[n_groups, D]`` f64 sums of ``rows [N, D]`` (f32) by group
    ``ids [N]``, each the sequential sum of its group's rows in row order
    from 0.0 — what ``np.add.at(sums, ids, rows.astype(np.float64))``
    computes, bit for bit, without its f64 copy of the rows or its
    per-element loop. The rows fall into runs of one group; the k-th run of
    every group is summed in round k, onto the group's sum so far, one row
    position of all the round's runs at a time."""
    sums = np.zeros((n_groups, rows.shape[1]), np.float64)
    if len(ids) == 0:
        return sums
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    lens = np.diff(np.r_[starts, len(ids)])
    group = ids[starts]
    # each run's round: how many runs of its group come before it
    order = np.argsort(group, kind="stable")
    firsts = np.r_[True, group[order][1:] != group[order][:-1]]
    rank = np.arange(len(order))
    run_round = np.empty(len(order), np.int64)
    run_round[order] = rank - np.maximum.accumulate(np.where(firsts, rank,
                                                             0))
    for k in range(int(run_round.max()) + 1):
        sel = np.flatnonzero(run_round == k)
        st, ln, g = starts[sel], lens[sel], group[sel]
        acc = sums[g]
        for j in range(int(ln.max())):
            live = np.flatnonzero(ln > j)
            if len(live) == len(ln):
                acc += rows[st + j]
            else:
                acc[live] += rows[st[live] + j]
        sums[g] = acc
    return sums


@torch.inference_mode()
def video_rank_device(rows: torch.Tensor, vid_ids: torch.Tensor,
                      means: torch.Tensor, counts: torch.Tensor,
                      q: torch.Tensor, valid: int, k: int):
    """The device video ranking (the reference's ``_video_rank_device``,
    a jitted XLA function, as plain torch ops): normalise the per-video
    means, score them against the unit query ``q`` (videos without rows
    score ``-inf``), take the top ``k`` by a stable descending sort (ties:
    lowest video id first, as ``lax.top_k``), score every exact f32 row
    ``rows [cap, D]`` (rows at ``valid`` and above: ``-inf``) and take each
    winner's first-max row among its own (``vid_ids [cap]``, -1 past the
    live rows). Returns ``(top scores [k], top video ids [k], best rows
    [k])`` on the device. ``launches`` counts the calls."""
    video_rank_device.launches += 1
    mnorm = means / torch.clamp(
        torch.linalg.vector_norm(means, dim=-1, keepdim=True), min=1e-10)
    vscores = (mnorm @ q).masked_fill(counts <= 0, _NEG_INF)
    top_vals, top_vids = torch.sort(vscores, descending=True, stable=True)
    top_vals, top_vids = top_vals[:k], top_vids[:k]
    fscores = rows @ q
    live = torch.arange(fscores.shape[0], device=rows.device) < valid
    fscores = torch.where(live, fscores, _NEG_INF)
    own = vid_ids[None, :] == top_vids[:, None].to(vid_ids.dtype)
    best = torch.argmax(torch.where(own, fscores[None, :], _NEG_INF), dim=1)
    return top_vals, top_vids, best


video_rank_device.launches = 0


class DeviceVideoIndex:
    """Frame index: host f32 rows + a device mirror in ``device_dtype``."""

    # appends up to this many rows scatter into the mirror; larger ones
    # re-place it
    _UPDATE_MAX = 4096

    def __init__(self, dim: int = EMBED_DIM,
                 device_dtype: str = "float32",
                 device: str | torch.device = "cuda",
                 device_rerank: str = "auto",
                 rerank_store_dtype: str = "float32",
                 mesh: Optional[CorpusMesh] = None):
        """``mesh``: shard the mirror over a corpus mesh; queries, merges
        and results then live on its first device (this process's first
        device on a mesh that spans processes; ``device`` is not read)."""
        if device_dtype not in DEVICE_DTYPES:
            raise ValueError(f"unsupported device_dtype {device_dtype!r}")
        if device_dtype == "int4" and mesh is not None:
            raise ValueError("device_dtype='int4' does not support a "
                             "corpus mesh — use 'int8' or 'bfloat16'")
        if device_rerank not in ("auto", "on", "off"):
            raise ValueError(f"unsupported device_rerank {device_rerank!r}")
        if rerank_store_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unsupported rerank_store_dtype {rerank_store_dtype!r}")
        self.dim = dim
        self.device_dtype = device_dtype
        self.mesh = mesh
        self._n_shards = 1 if mesh is None else mesh.n_shards
        self.device = resolve_device(device if mesh is None
                                     else mesh.devices[0])
        self.device_rerank = device_rerank
        self.rerank_store_dtype = rerank_store_dtype
        self.video_hashes: Dict[str, str] = {}
        # guards the lazy device syncs: searches run concurrently under
        # the engine's shared read lock, and the first search after an
        # append mutates the mirror state
        self._sync_lock = threading.Lock()
        self._reset_storage()

    # ------------------------------------------------------------------
    # Host-side storage
    # ------------------------------------------------------------------

    @property
    def _granularity(self) -> int:
        """Capacity granularity: each shard's rows a whole number of the
        exact scan's tiles and the candidate kernels' blocks (the
        reference's rule, so both packages pad capacity alike)."""
        return max(_CHUNK, self._n_shards * math.lcm(SCAN_TILE_ROWS,
                                                     CAND_BLOCK_ROWS))

    def _reset_storage(self) -> None:
        cap = self._granularity
        self._emb = np.zeros((cap, self.dim), dtype=np.float32)
        self._video_ids = np.zeros(cap, dtype=np.int32)
        self._timestamps = np.zeros(cap, dtype=np.float64)
        self._frame_ids = np.zeros(cap, dtype=np.int64)
        self._count = 0
        self._video_names: List[str] = []
        self._video_name_to_id: Dict[str, int] = {}
        # per-video embedding sums (f64) and frame counts, kept at every
        # append, removal and load; ``_video_rev`` moves with them
        self._video_sums = np.zeros((8, self.dim), dtype=np.float64)
        self._video_counts = np.zeros(8, dtype=np.int64)
        self._video_rev = 0
        # the device ranking's copy: means, counts and the row -> video id
        # column, uploaded whole when ``_video_rev`` moved
        self._dev_video_rev = -1
        self._dev_means: Optional[torch.Tensor] = None
        self._dev_counts: Optional[torch.Tensor] = None
        self._dev_vid_ids: Optional[torch.Tensor] = None
        # device mirror (rows or codes), the codes' per-row scales, and
        # the perm column of the prefix and perm layouts (on a mesh: lists
        # of per-shard tensors); the layout they were placed in
        self._mirror_layout_cur = "id"
        self._device_emb: Optional[torch.Tensor] = None
        self._device_scales: Optional[torch.Tensor] = None
        self._device_rows = 0
        self._device_cap = 0
        self._perm: Optional[np.ndarray] = None
        self._inv_perm: Optional[np.ndarray] = None
        self._perm_rows = 0
        self._fy_rng: Optional[np.random.Generator] = None
        # pre-append mirror position of each old row the last extension
        # displaced (host row -> position), for the device-streamed append
        self._fy_origin: Dict[int, int] = {}
        self._perm_dev: Optional[torch.Tensor] = None
        # identity-layout re-rank store
        self._device_f32: Optional[torch.Tensor] = None
        self._f32_rows = 0
        self._f32_cap = 0

    def _ensure_capacity(self, n: int) -> None:
        cap = self._emb.shape[0]
        if n <= cap:
            return
        new_cap = _round_capacity(max(n, cap * 2), self._granularity)
        for name in ("_emb", "_video_ids", "_timestamps", "_frame_ids"):
            old = getattr(self, name)
            new = np.zeros((new_cap,) + old.shape[1:], dtype=old.dtype)
            new[: self._count] = old[: self._count]
            setattr(self, name, new)

    def _video_id(self, video_name: str) -> int:
        vid = self._video_name_to_id.get(video_name)
        if vid is None:
            vid = len(self._video_names)
            self._video_names.append(video_name)
            self._video_name_to_id[video_name] = vid
            if vid >= self._video_sums.shape[0]:
                grow = max(8, 2 * self._video_sums.shape[0])
                self._video_sums = np.concatenate(
                    [self._video_sums,
                     np.zeros((grow, self.dim), np.float64)])
                self._video_counts = np.concatenate(
                    [self._video_counts, np.zeros(grow, np.int64)])
        return vid

    def __len__(self) -> int:
        return self._count

    @property
    def count(self) -> int:
        return self._count

    def video_names(self) -> List[str]:
        """Unique video names present in the index, insertion-ordered."""
        live = set(self._video_ids[: self._count].tolist())
        return [n for i, n in enumerate(self._video_names) if i in live]

    def video_frame_counts(self) -> Dict[str, int]:
        """Live frame count of each video present, in one O(N) pass."""
        counts = np.bincount(self._video_ids[: self._count],
                             minlength=len(self._video_names))
        return {name: int(counts[i])
                for i, name in enumerate(self._video_names)
                if i < len(counts) and counts[i] > 0}

    def nearest_frame(self, video_name: str, timestamp: float
                      ) -> Optional[int]:
        """Host row of ``video_name``'s frame nearest ``timestamp`` (the
        first on a tie); None when the video has no live rows."""
        vid = self._video_name_to_id.get(video_name)
        if vid is None:
            return None
        rows = np.nonzero(self._video_ids[: self._count] == vid)[0]
        if rows.size == 0:
            return None
        return int(rows[np.argmin(np.abs(self._timestamps[rows]
                                         - float(timestamp)))])

    def frame_embedding(self, row: int) -> np.ndarray:
        """A copy of live host row ``row``'s f32 embedding."""
        if not 0 <= row < self._count:
            raise IndexError(f"row {row} out of range [0, {self._count})")
        return self._emb[row].astype(np.float32, copy=True)

    def frame_info(self, row: int) -> Dict:
        """Live host row ``row``'s video name, timestamp and frame id."""
        if not 0 <= row < self._count:
            raise IndexError(f"row {row} out of range [0, {self._count})")
        return {
            "video_name": self._video_names[int(self._video_ids[row])],
            "timestamp": float(self._timestamps[row]),
            "frame_id": int(self._frame_ids[row]),
        }

    def reserve(self, n_rows: int) -> None:
        """Pre-size host capacity to at least ``n_rows`` (large builds
        then never re-grow mid-build)."""
        self._ensure_capacity(int(n_rows))

    def add_frame(self, embedding: np.ndarray, video_name: str,
                  timestamp: float) -> None:
        """Append one frame."""
        self.add_batch(np.asarray(embedding, np.float32)[None, :],
                       video_name, [timestamp])

    def add_batch(self, embeddings: np.ndarray, video_name: str,
                  timestamps: Sequence[float]) -> None:
        """Append a batch of frames of one video."""
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2 or embeddings.shape[1] != self.dim:
            raise ValueError(
                f"expected [n, {self.dim}] embeddings, got {embeddings.shape}")
        n = embeddings.shape[0]
        if n != len(timestamps):
            raise ValueError("timestamps length mismatch")
        if n == 0:
            return
        self._ensure_capacity(self._count + n)
        lo, hi = self._count, self._count + n
        self._emb[lo:hi] = embeddings
        self._video_ids[lo:hi] = self._video_id(video_name)
        self._timestamps[lo:hi] = np.asarray(timestamps, np.float64)
        # frame_id = insertion position, as in the reference
        self._frame_ids[lo:hi] = np.arange(lo, hi, dtype=np.int64)
        self._count = hi
        vid = self._video_ids[lo]
        self._video_sums[vid] += embeddings.sum(axis=0, dtype=np.float64)
        self._video_counts[vid] += n
        self._video_rev += 1

    def remove_video(self, video_name: str) -> int:
        """Drop all frames of a video, compacting rows (surviving rows keep
        their frame_id). Returns the number of rows removed."""
        vid = self._video_name_to_id.get(video_name)
        if vid is None:
            return 0
        keep = self._video_ids[: self._count] != vid
        removed = int((~keep).sum())
        if removed:
            n = int(keep.sum())
            for name in ("_emb", "_video_ids", "_timestamps", "_frame_ids"):
                arr = getattr(self, name)
                arr[:n] = arr[: self._count][keep]
            self._count = n
            # compaction shifted every surviving row: re-place the mirror,
            # the arrangement and the re-rank store
            self._device_emb = None
            self._perm = None
            self._perm_dev = None
            self._device_f32 = None
            self._f32_rows = 0
            self._f32_cap = 0
            self._video_sums[vid] = 0.0
            self._video_counts[vid] = 0
            self._video_rev += 1
        self.video_hashes.pop(video_name, None)
        return removed

    def clear(self) -> None:
        self.video_hashes = {}
        self._reset_storage()

    # ------------------------------------------------------------------
    # Device mirror
    # ------------------------------------------------------------------

    def _extend_perm_to(self, count: int, cap: int
                        ) -> Optional[np.ndarray]:
        """Maintain the live-PREFIX arrangement up to ``count`` host rows
        (the reference's incremental Fisher–Yates, same seeds and draws).

        Returns the sorted mirror positions whose content changed, or
        ``None`` when the arrangement was rebuilt from scratch (first
        build, compaction; the caller re-places the whole mirror).
        Capacity growth keeps the arrangement."""
        if (self._perm is not None and self._fy_rng is not None
                and self._perm_rows <= count
                and cap > self._perm.shape[0]):
            perm = np.arange(cap, dtype=np.int32)
            perm[: self._perm_rows] = self._perm[: self._perm_rows]
            inv = np.arange(cap, dtype=np.int32)
            inv[perm[: self._perm_rows]] = np.arange(
                self._perm_rows, dtype=np.int32)
            self._perm, self._inv_perm = perm, inv
        if (self._perm is None or self._perm.shape[0] != cap
                or self._perm_rows > count or self._fy_rng is None):
            rng = np.random.default_rng(0xC0FFEE ^ cap)
            perm = np.arange(cap, dtype=np.int32)
            perm[:count] = rng.permutation(count).astype(np.int32)
            inv = np.empty(cap, np.int32)
            inv[perm] = np.arange(cap, dtype=np.int32)
            self._perm, self._inv_perm = perm, inv
            self._perm_rows = count
            self._fy_rng = rng
            self._perm_dev = None
            self._fy_origin = {}
            return None
        self._fy_origin = {}
        if count == self._perm_rows:
            return np.empty(0, np.int32)
        lo, hi = self._perm_rows, count
        perm, inv = self._perm, self._inv_perm
        js = self._fy_rng.integers(0, np.arange(lo, hi) + 1)
        changed = []
        # an old row (< lo) displaced twice keeps its first, pre-append
        # position: the streamed append gathers it from there
        origin = self._fy_origin
        for i in range(hi - lo):
            m = lo + i   # prefix size before this insert == new host row
            j = int(js[i])
            if j != m:
                disp = int(perm[j])
                if disp < lo and disp not in origin:
                    origin[disp] = j
                perm[m] = disp
                inv[disp] = m
                perm[j] = m
                inv[m] = j
                changed.append(j)
            else:
                perm[m] = m
                inv[m] = m
            changed.append(m)
        self._perm_rows = count
        return np.unique(np.asarray(changed, np.int32))

    @property
    def _codes(self) -> bool:
        """Quantized-codes mirror (int8/int4): codes + per-row scales."""
        return self.device_dtype in ("int8", "int4")

    @property
    def _codes_width(self) -> int:
        """Mirror row width in bytes of the codes mirrors: D for int8, D/2
        for the packed int4 split-halves layout."""
        return self.dim // 2 if self.device_dtype == "int4" else self.dim

    @property
    def _row_dtype(self) -> torch.dtype:
        """Element type of the float mirrors (bf16 or f32)."""
        return (torch.bfloat16 if self.device_dtype == "bfloat16"
                else torch.float32)

    def _quantize_host(self, rows: np.ndarray):
        """Host-side per-row quantization for the codes dtype (bit-identical
        to the reference's): ``(codes, [n, 1] f32 scales)``."""
        if self.device_dtype == "int4":
            return quantize_rows_int4_np(rows)
        return quantize_rows_np(rows)

    def _mirror_permuted(self) -> bool:
        """Whether the mirror lives under a row permutation: the candidate
        mirrors, except bf16 and int8 under the exact-candidate hatch
        (``VQT_CANDIDATE_TOPK=pallas``), whose exact scans need the
        identity layout (int4 has no exact scan and stays permuted)."""
        if self.device_dtype == "int4":
            return True
        return self.device_dtype != "float32" and _candidate_mode() != "pallas"

    def _mirror_layout(self) -> str:
        """Target layout: ``"id"`` (f32, the hatch), ``"prefix"`` (the
        permuted mirrors of one card) or ``"perm"`` (on a corpus mesh)."""
        if not self._mirror_permuted():
            return "id"
        return "perm" if self.mesh is not None else "prefix"

    def _require_perm(self, cap: int) -> None:
        """(Re)build the fixed full-capacity permutation of the ``"perm"``
        layout, from the reference's seed (so both packages draw the same
        one)."""
        if self._perm is None or self._perm.shape[0] != cap \
                or self._perm_rows:
            rng = np.random.default_rng(0xC0FFEE + cap)
            self._perm = rng.permutation(cap).astype(np.int32)
            self._inv_perm = np.empty(cap, np.int32)
            self._inv_perm[self._perm] = np.arange(cap, dtype=np.int32)
            self._perm_rows = 0
            self._fy_rng = None

    def _perm_arg(self):
        """The perm operand of the candidate scans (per shard on a mesh);
        None for an identity-layout mirror."""
        return (self._perm_dev
                if self._mirror_layout_cur in ("perm", "prefix") else None)

    def _place(self, t: torch.Tensor, dtype: Optional[torch.dtype] = None):
        """A host tensor on the index's device, or (on a mesh: the rows of
        this process's shards, :meth:`_mirror_rows`) split over its
        local shards."""
        if self.mesh is None:
            return t.to(self.device, dtype)
        return place_local(t, self.mesh, dtype)

    def _mirror_rows(self, cap: int) -> slice:
        """The mirror positions this process places: all of them, or on a
        mesh its shards' rows."""
        if self.mesh is None:
            return slice(0, cap)
        return slice(*local_rows(cap, self.mesh))

    def _put(self, rows: np.ndarray, pos: Optional[torch.Tensor] = None,
             lo: int = 0) -> None:
        """Write f32 host ``rows`` into the mirror in its dtype: at
        positions ``pos``, else at ``lo:lo + n``."""
        where = pos if pos is not None else slice(lo, lo + rows.shape[0])
        if self._codes:
            codes, scales = self._quantize_host(rows)
            self._device_emb[where] = torch.from_numpy(codes).to(self.device)
            self._device_scales[where] = torch.from_numpy(scales).to(
                self.device)
        else:
            self._device_emb[where] = torch.from_numpy(rows).to(
                self.device, self._row_dtype)

    def _full_place(self, cap: int) -> None:
        layout = self._mirror_layout()
        if layout == "prefix":
            self._perm = None            # vectorized arrangement rebuild
            self._extend_perm_to(self._count, cap)
        elif layout == "perm":
            self._require_perm(cap)
        self._device_emb = self._device_scales = self._perm_dev = None
        mine = self._mirror_rows(cap)
        rows = (self._emb[mine] if layout == "id"
                else self._emb[self._perm[mine]])
        if self._codes:
            codes, scales = self._quantize_host(rows)
            self._device_emb = self._place(torch.from_numpy(codes))
            self._device_scales = self._place(torch.from_numpy(scales))
        else:
            self._device_emb = self._place(torch.from_numpy(rows),
                                           self._row_dtype)
        if layout != "id":
            self._perm_dev = self._place(torch.from_numpy(self._perm[mine]))
        self._mirror_layout_cur = layout
        self._device_cap = cap
        self._device_rows = self._count

    def _try_grow_mirror(self, cap: int) -> bool:
        """Grow the mirror on the device on a capacity increase (dead
        tail: zero rows and scales, identity perm). False when a full
        re-place is needed instead."""
        if (self._device_emb is None or cap <= self._device_cap
                or self._device_rows > self._count):
            return False

        def grow(old):
            grown = torch.zeros((cap,) + old.shape[1:], dtype=old.dtype,
                                device=self.device)
            grown[: old.shape[0]] = old
            return grown

        self._device_emb = grow(self._device_emb)
        if self._device_scales is not None:
            self._device_scales = grow(self._device_scales)
        if self._perm_dev is not None:
            self._perm_dev = torch.cat([
                self._perm_dev,
                torch.arange(self._perm_dev.shape[0], cap, dtype=torch.int32,
                             device=self.device)])
        self._device_cap = cap
        return True

    def _sync_device(self) -> None:
        with self._sync_lock:
            self._sync_device_locked()

    @torch.inference_mode(False)
    def _sync_device_locked(self) -> None:
        """Bring the mirror up to date: full upload on the first use, a
        layout change, a compaction or an append of more than
        ``_UPDATE_MAX`` rows, and on a mesh at any change; device-side
        growth on a capacity increase; otherwise the identity mirror
        copies the new rows and a prefix mirror scatters its <= 2n changed
        positions (rows or codes + scales, and the perm column)."""
        cap = self._emb.shape[0]
        layout = self._mirror_layout()
        stale = (self._device_emb is None
                 or self._mirror_layout_cur != layout
                 or self._device_rows > self._count
                 or self._count - self._device_rows > self._UPDATE_MAX)
        if self.mesh is not None:
            stale = stale or self._device_cap != cap \
                or self._device_rows != self._count
        if stale or (self._device_cap != cap
                     and not self._try_grow_mirror(cap)):
            self._full_place(cap)
            return
        if self._device_rows == self._count:
            return
        if layout == "id":
            lo, hi = self._device_rows, self._count
            self._put(self._emb[lo:hi], lo=lo)
            self._device_rows = hi
            return
        # Fisher–Yates extension: scatter the <= 2n changed positions
        changed = self._extend_perm_to(self._count, cap)
        if changed is None or self._perm_dev is None:
            self._full_place(cap)
            return
        pos = torch.from_numpy(changed.astype(np.int64)).to(self.device)
        self._put(self._emb[self._perm[changed]], pos=pos)
        self._perm_dev[pos] = torch.from_numpy(
            self._perm[changed]).to(self.device)
        self._device_rows = self._count

    # -- device re-rank store -------------------------------------------

    def _device_rerank_active(self) -> bool:
        """Whether searches re-rank on the device (never for the f32
        exact tier, whose scan is exact, nor on a mesh, whose candidates
        re-rank on the host): ``VQT_DEVICE_RERANK`` or ``device_rerank``
        "on"/"off", or "auto" while store + mirror fit
        ``VQT_DEVICE_RERANK_BUDGET_GB`` (default 12)."""
        if self.device_dtype == "float32" or self.mesh is not None:
            return False
        mode = os.environ.get("VQT_DEVICE_RERANK", self.device_rerank)
        if mode in ("on", "off"):
            return mode == "on"
        budget = float(os.environ.get("VQT_DEVICE_RERANK_BUDGET_GB",
                                      "12")) * 1e9
        cap = self._emb.shape[0]
        store = 2 if self.rerank_store_dtype == "bfloat16" else 4
        mirror = (cap * (self._codes_width + 4) if self._codes
                  else cap * self.dim * 2)
        return cap * self.dim * store + mirror <= budget

    @torch.inference_mode(False)
    def _sync_device_f32(self) -> torch.Tensor:
        """Bring the identity-layout re-rank store up to date (callers
        hold ``_sync_lock``): full upload on first use, dtype change or
        compaction; device-side growth on a capacity increase; appends
        copy only the new rows."""
        cap = self._emb.shape[0]
        dt = (torch.bfloat16 if self.rerank_store_dtype == "bfloat16"
              else torch.float32)
        if self._device_f32 is None or self._device_f32.dtype != dt \
                or self._f32_rows > self._count:
            self._device_f32 = torch.from_numpy(self._emb).to(self.device,
                                                               dt)
            self._f32_cap = cap
            self._f32_rows = self._count
            return self._device_f32
        if cap > self._f32_cap:
            grown = torch.zeros((cap, self.dim), dtype=dt,
                                device=self.device)
            grown[: self._f32_cap] = self._device_f32
            self._device_f32 = grown
            self._f32_cap = cap
        if self._f32_rows < self._count:
            lo, hi = self._f32_rows, self._count
            self._device_f32[lo:hi] = torch.from_numpy(
                self._emb[lo:hi]).to(self.device, dt)
            self._f32_rows = hi
        return self._device_f32

    def sync_mirror(self) -> None:
        """Eagerly bring the mirror (and the re-rank store, when active)
        up to date, so the first query costs what any other does."""
        if self._count == 0:
            return
        with self._sync_lock:
            self._sync_device_locked()
            if self._device_rerank_active():
                self._sync_device_f32()

    # -- device-streamed append (the features never leave the device) --

    def _place_empty(self, cap: int) -> None:
        """Fresh mirrors on the device for a build from zero rows: zero
        rows (and scales), the identity perm column, and the arrangement
        started at zero rows (the host path's first placement at count 0,
        without its upload)."""
        layout = self._mirror_layout()
        if layout == "prefix":
            self._perm = None
            self._extend_perm_to(0, cap)
            self._perm_dev = torch.arange(cap, dtype=torch.int32,
                                          device=self.device)
        self._mirror_layout_cur = layout
        width = self._codes_width if self._codes else self.dim
        self._device_emb = torch.zeros(
            (cap, width), device=self.device,
            dtype=torch.int8 if self._codes else self._row_dtype)
        self._device_scales = (torch.zeros((cap, 1), device=self.device)
                               if self._codes else None)
        self._device_cap = cap
        self._device_rows = 0

    def _cast_rows(self, rows: torch.Tensor):
        """Device rows → the mirror's ``(rows or codes, scales or None)``:
        the cast, or the quantizer bit-identical to :meth:`_quantize_host`
        (reciprocal-multiply scale, true divide, round half to even)."""
        if self.device_dtype == "int8":
            return quantize_rows(rows)
        if self.device_dtype == "int4":
            return quantize_rows_int4(rows)
        return rows.to(self._row_dtype), None

    def add_batch_device(self, feats: torch.Tensor, video_name: str,
                         timestamps: Sequence[float], *, offset: int = 0,
                         feats_np: Optional[np.ndarray] = None) -> None:
        """Append rows whose embeddings already live on the device:
        ``feats[offset : offset + len(timestamps)]``. The host store takes
        ``feats_np`` (the full batch fetched once; fetched here when
        omitted), the mirrors the device rows."""
        n = len(timestamps)
        if n == 0:
            return
        rows = (feats[offset: offset + n].float().cpu().numpy()
                if feats_np is None else feats_np[offset: offset + n])
        lo = self._count
        self.add_batch(rows, video_name, timestamps)
        self.stream_rows_device(feats, offset=offset, n=n, lo=lo)

    def stream_rows_device(self, feats: torch.Tensor, *, offset: int,
                           n: int, lo: int) -> None:
        """Stream host rows ``[lo, lo + n)`` — already appended to the
        host store — into the device mirrors from the device tensor
        ``feats`` (rows ``offset .. offset + n``). The engine appends an
        embed batch's per-video segments on the host first and streams
        once per batch."""
        if n == 0:
            return
        with self._sync_lock:
            self._stream_append_device_locked(feats, offset, n, lo)

    @torch.inference_mode(False)
    def _stream_append_device_locked(self, feats: torch.Tensor, offset: int,
                                     n: int, lo: int) -> None:
        """Bring the mirror and the active re-rank store up to date from
        device rows. Where the streaming invariant does not hold (an
        append over ``_UPDATE_MAX`` rows, a mirror not synced to ``lo`` or
        in another layout) the host sync path runs instead: the same
        result. So does the int8 mirror under the exact-candidate hatch
        (identity layout), whose host sync quantizes the rows. A mesh's
        mirror is re-placed at the next search instead."""
        if self.mesh is not None:
            return
        cap = self._emb.shape[0]
        rows = feats[offset: offset + n]
        if rows.device != self.device:
            raise ValueError(f"streamed rows on {rows.device}, index on "
                             f"{self.device}")
        layout = self._mirror_layout()
        codes_id = self._codes and layout == "id"
        if n <= self._UPDATE_MAX and self._device_emb is None and lo == 0 \
                and not codes_id:
            self._place_empty(cap)
        if (codes_id or n > self._UPDATE_MAX or self._device_emb is None
                or self._mirror_layout_cur != layout
                or (self._device_cap != cap
                    and not self._try_grow_mirror(cap))
                or self._device_rows != lo):
            self._sync_device_locked()
        elif layout == "id":
            self._device_emb[lo: lo + n] = rows.to(self._row_dtype)
            self._device_rows = lo + n
        elif self._extend_perm_to(lo + n, cap) is None \
                or self._perm_dev is None:
            self._full_place(cap)
        else:
            self._stream_prefix(rows, lo, n)
        if self._device_rerank_active():
            self._stream_store(rows, lo, n, cap)

    def _stream_prefix(self, rows: torch.Tensor, lo: int, n: int) -> None:
        """The live-prefix append after ``_extend_perm_to``: the displaced
        old rows move from their pre-append positions (all gathered before
        any write), the new rows land cast or quantized at theirs, and the
        perm column follows."""
        origin = self._fy_origin
        old_ids = np.fromiter(origin.keys(), np.int64, count=len(origin))
        old_src = np.fromiter(origin.values(), np.int64, count=len(origin))
        new_ids = np.arange(lo, lo + n, dtype=np.int64)
        idx = torch.from_numpy(np.concatenate([
            old_src, self._inv_perm[old_ids], old_ids,
            self._inv_perm[new_ids], new_ids])).to(self.device)
        m = len(origin)
        src, old_dst, old_val = idx[:m], idx[m:2 * m], idx[2 * m:3 * m]
        new_dst, new_val = idx[3 * m:3 * m + n], idx[3 * m + n:]
        emb, scales = self._device_emb, self._device_scales
        if m:
            moved = emb[src]
            emb[old_dst] = moved
            if scales is not None:
                moved_scales = scales[src]
                scales[old_dst] = moved_scales
        codes, new_scales = self._cast_rows(rows)
        emb[new_dst] = codes
        if scales is not None:
            scales[new_dst] = new_scales
        self._perm_dev[old_dst] = old_val.to(torch.int32)
        self._perm_dev[new_dst] = new_val.to(torch.int32)
        self._device_rows = lo + n

    def _stream_store(self, rows: torch.Tensor, lo: int, n: int,
                      cap: int) -> None:
        """Append the device rows to the identity-layout re-rank store
        (created empty on a build from zero rows, grown on the device),
        or sync it from the host where it is not at ``lo``."""
        dt = (torch.bfloat16 if self.rerank_store_dtype == "bfloat16"
              else torch.float32)
        if self._device_f32 is None and lo == 0:
            self._device_f32 = torch.zeros((cap, self.dim), dtype=dt,
                                           device=self.device)
            self._f32_cap, self._f32_rows = cap, 0
        if (self._device_f32 is None or self._device_f32.dtype != dt
                or self._f32_rows != lo or n > self._UPDATE_MAX):
            self._sync_device_f32()
            return
        if cap > self._f32_cap:
            grown = torch.zeros((cap, self.dim), dtype=dt,
                                device=self.device)
            grown[: self._f32_cap] = self._device_f32
            self._device_f32, self._f32_cap = grown, cap
        self._device_f32[lo: lo + n] = rows.to(dt)
        self._f32_rows = lo + n

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    @staticmethod
    def _candidate_impl() -> str:
        """The candidate stage's scan: ``"exact"`` under the hatch
        (``VQT_CANDIDATE_TOPK=pallas``), else ``"cand"``."""
        return "exact" if _candidate_mode() == "pallas" else "cand"

    def _rerank_fetch(self, k: int) -> int:
        """Candidate over-fetch of the re-ranked candidate mirrors. int4's
        candidate noise band is about twice int8's (step absmax/7 vs
        /127), so its fetch doubles (capped), as in the reference. The
        hatch's exact scans fetch shallow, ``min(max(4k, k + 16),
        MAX_K)``."""
        if self._candidate_impl() == "exact":
            return min(max(4 * k, k + 16), MAX_K)
        fetch = min(_approx_fetch(k), APPROX_FETCH_CAP)
        if self.device_dtype == "int4":
            fetch = min(2 * fetch, APPROX_FETCH_CAP)
        return fetch

    @staticmethod
    def normalize_query(query: np.ndarray) -> np.ndarray:
        """Reference query normalization (``q / (||q|| + 1e-10)``)."""
        q = np.asarray(query, np.float32)
        return q / (np.linalg.norm(q) + 1e-10)

    def _synced_mirror(self) -> tuple:
        """Sync the mirror (callers hold ``_sync_lock``) and return its
        ``(rows or codes, scales or None, perm or None)`` (per-shard lists
        on a mesh)."""
        self._sync_device_locked()
        return self._device_emb, self._device_scales, self._perm_arg()

    def _scan(self, mirror: tuple, q: torch.Tensor, live: int, k: int):
        """Enqueue the scan of ``mirror`` for the unit queries ``q``:
        ``(scores, host rows)`` of the exact f32 scan's top ``k``, or of
        the dtype's top ``k`` candidates for the re-rank."""
        emb, scales, perm = mirror
        if self.mesh is not None:
            return self._sharded_scan(mirror, q, live, k)
        if self.device_dtype == "float32":
            return cosine_topk(emb, q, live, k=k)
        prefix = self._mirror_layout_cur == "prefix"
        if self.device_dtype == "bfloat16":
            return candidate_topk(emb, q, live, k=k, perm=perm,
                                  prefix=prefix, live=live)
        cand = (candidate_topk_int8 if self.device_dtype == "int8"
                else candidate_topk_int4)
        return cand(emb, scales, q, live, k=k, perm=perm, prefix=prefix,
                    live=live)

    def _sharded_scan(self, mirror: tuple, q: torch.Tensor, live: int,
                      k: int):
        """The mesh's scan (``index/sharded.py``): the exact f32 scan, or
        the candidate impl of the bf16 and int8 mirrors — the perm-layout
        stages, or the exact scans under the hatch."""
        emb, scales, perm = mirror
        impl = ("exact" if self.device_dtype == "float32"
                else self._candidate_impl())
        ms = is_multislice(self.mesh)
        if self._codes:
            scan = (multislice_cosine_topk_int8 if ms
                    else sharded_cosine_topk_int8)
            return scan(emb, scales, q, live, k=k, mesh=self.mesh,
                        impl=impl, perm=perm)
        scan = multislice_cosine_topk if ms else sharded_cosine_topk
        return scan(emb, q, live, k=k, mesh=self.mesh, impl=impl, perm=perm)

    def search(self, query_embedding: np.ndarray, k: int = 5) -> List[Dict]:
        """One query vector: :meth:`search_batch`'s rows for it."""
        return self.search_batch(np.asarray(query_embedding)[None, :], k)[0]

    def search_batch(self, queries: np.ndarray, k: int = 5
                     ) -> List[List[Dict]]:
        """Batched vector search: the exact f32 scan's rows, or the
        candidate scan on the device and the exact f32 re-rank on the host
        (the reference's two-step path)."""
        if self._count == 0:
            return [[] for _ in range(len(queries))]
        k = max(1, min(int(k), MAX_K))
        q = np.stack([self.normalize_query(r) for r in np.asarray(queries)])
        count = self._count
        with self._sync_lock:
            mirror = self._synced_mirror()
        q_dev = torch.from_numpy(q).to(self.device)
        if self.device_dtype == "float32":
            vals, idxs = self._scan(mirror, q_dev, count, k)
            return self._rows_from(vals.cpu().numpy(), idxs.cpu().numpy())
        _, idxs = self._scan(mirror, q_dev, count, self._rerank_fetch(k))
        return self._rerank_f32(q, idxs.cpu().numpy(), k)

    def _rows_from(self, vals: np.ndarray, idxs: np.ndarray
                   ) -> List[List[Dict]]:
        """(scores, host rows) → reference result rows; non-finite scores
        (pads, rows past the live count) are skipped."""
        names = self._video_names
        finite = np.isfinite(vals)
        out: List[List[Dict]] = []
        for b in range(vals.shape[0]):
            m = finite[b]
            iv = idxs[b][m]
            out.append([
                {"video_name": names[v], "timestamp": t,
                 "frame_id": f, "score": s}
                for v, t, f, s in zip(self._video_ids[iv].tolist(),
                                      self._timestamps[iv].tolist(),
                                      self._frame_ids[iv].tolist(),
                                      vals[b][m].tolist())
            ])
        return out

    def search_batch_fused(self, encode_fn, params, ids, k: int = 5
                           ) -> List[List[Dict]]:
        """Text search: :meth:`search_batch_fused_async` resolved now."""
        return self.search_batch_fused_async(encode_fn, params, ids, k)()

    def search_batch_fused_async(self, encode_fn: Callable, params, ids,
                                 k: int = 5
                                 ) -> Callable[[], List[List[Dict]]]:
        """Dispatch phase of text search: ``encode_fn(params, ids)`` (the
        embedder's text tower, ``[B, D]`` unit rows), the scan and — for
        the candidate mirrors, when active — the exact re-rank are
        ENQUEUED on the device stream (PyTorch returns before the device
        finishes); the returned ``resolve()`` copies the results to the
        host and builds the rows.

        Contract: no index mutation between dispatch and resolve (rows
        could move under the in-flight indices); callers hold the engine's
        shared read lock across both phases."""
        ids = np.asarray(ids)
        n_q = int(ids.shape[0])
        if self._count == 0:
            return lambda: [[] for _ in range(n_q)]
        k = max(1, min(int(k), MAX_K))
        exact = self.device_dtype == "float32"
        k_dev = k if exact else self._rerank_fetch(k)
        count = self._count
        with span("mirror_sync"), self._sync_lock:
            mirror = self._synced_mirror()
            store = (self._sync_device_f32()
                     if self._device_rerank_active() else None)
        with torch.inference_mode():
            with span("encode"):
                ids_t = torch.from_numpy(np.ascontiguousarray(
                    ids, np.int64)).to(self.device)
                q = encode_fn(params, ids_t)
                q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True)
                         + 1e-10)
            with span("scan"):
                vals, idxs = self._scan(mirror, q, count, k_dev)
            if store is not None:
                with span("rerank"):
                    vals, idxs = _device_exact_rerank(store, q, idxs, count,
                                                      k)
            if exact or store is not None:
                def rows() -> List[List[Dict]]:
                    with span("results"):
                        return self._rows_from(vals.cpu().numpy(),
                                               idxs.cpu().numpy())
                return rows

        def rerank_rows() -> List[List[Dict]]:
            with span("results"):
                return self._rerank_f32(q.cpu().numpy(), idxs.cpu().numpy(),
                                        k)
        return rerank_rows

    def _rerank_f32(self, q: np.ndarray, idxs: np.ndarray, k: int
                    ) -> List[List[Dict]]:
        """Exact f32 re-rank of candidate rows against the host matrix,
        (score desc, row asc)."""
        out: List[List[Dict]] = []
        for b in range(idxs.shape[0]):
            # unique: never emit a row twice
            cand = np.unique(idxs[b][idxs[b] < self._count])
            scores = self._emb[cand] @ q[b]
            order = np.lexsort((cand, -scores))[:k]
            out.append([{
                "video_name": self._video_names[self._video_ids[i]],
                "timestamp": float(self._timestamps[i]),
                "frame_id": int(self._frame_ids[i]),
                "score": float(scores[o]),
            } for o, i in zip(order, cand[order].tolist())])
        return out

    # ------------------------------------------------------------------
    # Video-level search
    # ------------------------------------------------------------------

    @torch.inference_mode(False)
    def _sync_video_state_locked(self) -> tuple:
        """Upload the per-video means (f32, padded to a multiple of 128
        videos, count 0 past the last) and counts, and the capacity-long
        row -> video id column (-1 past the live rows), when
        ``_video_rev`` moved or the capacity changed (callers hold
        ``_sync_lock``). Returns ``(vid_ids, means, counts)``."""
        cap = self._emb.shape[0]
        if (self._dev_video_rev != self._video_rev
                or self._dev_vid_ids is None
                or self._dev_vid_ids.shape[0] != cap):
            v = len(self._video_names)
            v_pad = max(_LANES_PAD,
                        -(-max(v, 1) // _LANES_PAD) * _LANES_PAD)
            counts = self._video_counts[:v]
            means = np.zeros((v_pad, self.dim), np.float32)
            means[:v] = (self._video_sums[:v]
                         / np.maximum(counts, 1)[:, None]).astype(np.float32)
            cnt = np.zeros(v_pad, np.int32)
            cnt[:v] = counts
            ids = np.full(cap, -1, np.int32)
            ids[: self._count] = self._video_ids[: self._count]
            self._dev_means = torch.from_numpy(means).to(self.device)
            self._dev_counts = torch.from_numpy(cnt).to(self.device)
            self._dev_vid_ids = torch.from_numpy(ids).to(self.device)
            self._dev_video_rev = self._video_rev
        return self._dev_vid_ids, self._dev_means, self._dev_counts

    def _video_rank_on_device(self) -> bool:
        """Whether :meth:`search_videos` ranks on the device — the
        reference's rule: on one device with exact f32 rows there (the f32
        mirror, or the identity-layout f32 re-rank store of a quantized
        tier while the device re-rank is active); not on a mesh, with a
        bf16 store or with the re-rank on the host."""
        if self.mesh is not None:
            return False
        if self.device_dtype == "float32":
            return True
        return (self._device_rerank_active()
                and self.rerank_store_dtype == "float32")

    def _video_rank_rows(self) -> Optional[torch.Tensor]:
        """The synced exact f32 rows the device ranking reads, None on
        the host path (callers hold ``_sync_lock``)."""
        if not self._video_rank_on_device():
            return None
        if self.device_dtype == "float32":
            self._sync_device_locked()
            return self._device_emb
        return self._sync_device_f32()

    def search_videos(self, query_embedding: np.ndarray, k: int = 5
                      ) -> List[Dict]:
        """Rank whole videos by the cosine of the query with their mean
        frame embedding: ``[{video_name, score, frame_count,
        best_timestamp}]``, best frame = the video's highest-scoring row
        (the lowest on a tie). On the device where exact f32 rows live
        there (:meth:`_video_rank_on_device`), else on the host; a failure
        on the device raises."""
        if self._count == 0:
            return []
        k = max(1, min(int(k), MAX_K))
        q = self.normalize_query(query_embedding)
        with self._sync_lock:
            rows = self._video_rank_rows()
            if rows is not None:
                vid_ids, means, counts = self._sync_video_state_locked()
        if rows is None:
            return self._search_videos_host(q, k)
        tv, tvid, best = video_rank_device(
            rows, vid_ids, means, counts, torch.from_numpy(q).to(self.device),
            self._count, k)
        return self._video_rows(tv.cpu().numpy(), tvid.cpu().numpy(),
                                best.cpu().numpy())

    def _search_videos_host(self, q: np.ndarray, k: int) -> List[Dict]:
        """The exact f32 ranking on the host: the means rank the videos,
        each winner's best frame comes from its own rows."""
        v = len(self._video_names)
        counts = self._video_counts[:v]
        means = (self._video_sums[:v]
                 / np.maximum(counts, 1)[:, None]).astype(np.float32)
        means /= np.maximum(
            np.linalg.norm(means, axis=-1, keepdims=True), 1e-10)
        scores = means @ q
        scores = np.where(counts > 0, scores, -np.inf)
        order = np.argsort(-scores, kind="stable")[:k]
        best = self._best_frames_host(q, order)
        return self._video_rows(scores[order], order, best)

    def _best_frames_host(self, q: np.ndarray, vids: np.ndarray
                          ) -> np.ndarray:
        """Each video's highest-scoring live row (the lowest on a tie),
        from its own rows only."""
        ids = self._video_ids[: self._count]
        best = []
        for vid in vids:
            rows = np.nonzero(ids == int(vid))[0]
            if rows.size == 0:
                best.append(0)
                continue
            s = self._emb[rows] @ q
            best.append(int(rows[np.argmax(s)]))
        return np.asarray(best, np.int64)

    def _video_rows(self, vals: np.ndarray, vids: np.ndarray,
                    best_rows: np.ndarray) -> List[Dict]:
        """Result rows; non-finite scores (videos without rows, k above
        the live videos) are dropped."""
        out: List[Dict] = []
        for score, vid, row in zip(vals, vids, best_rows):
            if not np.isfinite(score):
                continue
            vid = int(vid)
            out.append({
                "video_name": self._video_names[vid],
                "score": float(score),
                "frame_count": int(self._video_counts[vid]),
                "best_timestamp": float(self._timestamps[int(row)]),
            })
        return out

    # ------------------------------------------------------------------
    # Persistence — pickle v1.0 (exact parity with the reference)
    # ------------------------------------------------------------------

    def to_cache_dict(self) -> Dict:
        """The reference pickle payload."""
        emb_list = [self._emb[i].copy() for i in range(self._count)]
        metadata = [{
            "video_name": self._video_names[self._video_ids[i]],
            "timestamp": float(self._timestamps[i]),
            "frame_id": int(self._frame_ids[i]),
        } for i in range(self._count)]
        return {
            "embeddings": emb_list,
            "metadata": metadata,
            "video_hashes": dict(self.video_hashes),
            "version": CACHE_VERSION,
        }

    def load_cache_dict(self, cache_data: Dict) -> None:
        """Replace the contents with a cache payload, validated and
        materialised BEFORE the live index is touched."""
        embeddings = cache_data.get("embeddings", [])
        metadata = cache_data.get("metadata", [])
        hashes = dict(cache_data.get("video_hashes", {}))
        n = len(embeddings)
        if len(metadata) != n:
            raise ValueError("embeddings/metadata length mismatch")
        cap = _round_capacity(max(n, 1), self._granularity)
        emb = np.zeros((cap, self.dim), dtype=np.float32)
        video_ids = np.zeros(cap, dtype=np.int32)
        timestamps = np.zeros(cap, dtype=np.float64)
        frame_ids = np.zeros(cap, dtype=np.int64)
        names: List[str] = []
        name_to_id: Dict[str, int] = {}
        for i, (row, meta) in enumerate(zip(embeddings, metadata)):
            emb[i] = np.asarray(row, np.float32).reshape(self.dim)
            name = meta["video_name"]
            vid = name_to_id.get(name)
            if vid is None:
                vid = len(names)
                names.append(name)
                name_to_id[name] = vid
            video_ids[i] = vid
            timestamps[i] = float(meta["timestamp"])
            frame_ids[i] = int(meta.get("frame_id", i))
        self._reset_storage()
        self._emb, self._video_ids = emb, video_ids
        self._timestamps, self._frame_ids = timestamps, frame_ids
        self._video_names, self._video_name_to_id = names, name_to_id
        self.video_hashes = hashes
        self._count = n
        self._rebuild_video_stats()

    def _rebuild_video_stats(self) -> None:
        """Recompute the per-video sums and counts from the rows (the load
        paths; appends and removals keep them incrementally): the
        reference's ``np.add.at`` sums, bit for bit
        (:func:`_sequential_sums`)."""
        v = max(8, len(self._video_names))
        self._video_counts = np.zeros(v, np.int64)
        n = self._count
        ids = self._video_ids[:n]
        self._video_sums = _sequential_sums(self._emb[:n], ids, v)
        if n:
            self._video_counts[:] = np.bincount(ids, minlength=v)
        self._video_rev += 1

    @staticmethod
    def _sidecar(cache_path: Path) -> Path:
        return Path(str(cache_path) + ".sha256")

    def save_to_disk(self, cache_path: Path, checksum: bool = True) -> bool:
        """Write the v1.0 pickle; with ``checksum`` also its SHA-256
        sidecar. True on success; a failed write is logged and gives False,
        as the reference's."""
        try:
            payload = pickle.dumps(self.to_cache_dict())
            Path(cache_path).write_bytes(payload)
            if checksum:
                self._sidecar(cache_path).write_text(
                    hashlib.sha256(payload).hexdigest())
        except Exception as e:  # boundary: the caller decides on a miss
            logger.error("Failed to save cache: %s", e)
            return False
        logger.info("Saved %d embeddings to %s", self._count, cache_path)
        return True

    def load_from_disk(self, cache_path: Path, verify: bool = True) -> bool:
        """Load the v1.0 pickle. False when the file is absent, its
        checksum sidecar disagrees, or it cannot be read (truncated or
        malformed: logged, the index left as it was), as the reference's;
        the engine then reprocesses its videos."""
        cache_path = Path(cache_path)
        try:
            if not cache_path.exists():
                return False
            payload = cache_path.read_bytes()
            sidecar = self._sidecar(cache_path)
            if verify and sidecar.exists():
                expected = sidecar.read_text().strip()
                actual = hashlib.sha256(payload).hexdigest()
                if actual != expected:
                    logger.error("Cache checksum mismatch for %s (expected "
                                 "%s..., got %s...)", cache_path,
                                 expected[:12], actual[:12])
                    return False
            self.load_cache_dict(safe_pickle_loads(payload))
        except Exception as e:  # boundary: an unreadable cache is a miss
            logger.error("Failed to load cache: %s", e)
            return False
        logger.info("Loaded %d embeddings from %s", self._count, cache_path)
        return True

    # -- native persistence: one compressed .npz, either package's --------

    def save_native(self, path: Path) -> None:
        """Write the live rows, metadata columns, video names and hashes
        as one compressed ``.npz`` (the reference's layout)."""
        np.savez_compressed(
            path,
            embeddings=self._emb[: self._count],
            video_ids=self._video_ids[: self._count],
            timestamps=self._timestamps[: self._count],
            frame_ids=self._frame_ids[: self._count],
            video_names=np.array(self._video_names, dtype=object),
            video_hashes=np.array([list(self.video_hashes.keys()),
                                   list(self.video_hashes.values())],
                                  dtype=object),
        )

    def load_native(self, path: Path) -> None:
        """Replace the contents with a :meth:`save_native` file."""
        data = np.load(path, allow_pickle=True)
        self.clear()
        n = data["embeddings"].shape[0]
        self._ensure_capacity(n)
        self._emb[:n] = data["embeddings"]
        self._video_ids[:n] = data["video_ids"]
        self._timestamps[:n] = data["timestamps"]
        self._frame_ids[:n] = data["frame_ids"]
        self._video_names = list(data["video_names"])
        self._video_name_to_id = {name: i for i, name in
                                  enumerate(self._video_names)}
        keys, vals = data["video_hashes"]
        self.video_hashes = dict(zip(keys, vals))
        self._count = n
        self._rebuild_video_stats()
