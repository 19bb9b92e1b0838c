"""Candidate-stage top-k over the bf16 live-prefix mirror (counterpart of
the pieces of ``video_quierer_tpu/ops/topk.py`` that text search reads).

The bf16 mirror never returns scores to the caller: the candidate stage
over-fetches ``fetch`` host rows per query, and the index re-ranks them
exactly in f32. Two candidate stages, routed as in the reference:

- the fused scan (:func:`cand_scan_prefix`, kernel B1 on a CUDA tensor):
  per ``CAND_BUCKET``-row bucket of the mirror, the top ``CAND_ROUNDS``
  rows by packed key, then an exact top-``fetch`` merge over the winner
  list and the mirror-position → host-row translation through ``perm``;
- the exact scan (:func:`_approx_scan`) for corpora too small for the
  bucket winners to cover the fetch (:func:`prefix_fused_ok`) or whose
  capacity the kernel cannot tile (:func:`_fused_usable`). The reference
  uses hardware ApproxTopK there; on this card the exact top-k is the
  plain choice.

Every top-k here is descending-stable: ties break to the lowest index
(stable sorts — ``torch.topk`` promises no tie order).

Only the live-PREFIX mirror layout is ported (single device: live rows
fill mirror positions ``[0, valid)``); the perm-layout and quantized scans
are later ports.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch

from video_quierer_tpu_torch.ops import kernels

MAX_K = 64                 # reference API cap on k
APPROX_FETCH_CAP = 1024    # deepest candidate fetch
# the reference's scan geometry: winners per bucket, rows per bucket and
# per block (the index pads capacity to a multiple of the block)
CAND_BUCKET = 1024
CAND_ROUNDS = 2
CAND_BLOCK_ROWS = 4096
# widest query batch one fused scan takes; wider batches chunk
CAND_MAX_B = 256
_KEY_BIAS = 2.0
_IMAX = 2**31 - 1
NEG_INF = float("-inf")

Pair = Tuple[torch.Tensor, torch.Tensor]


def _approx_fetch(k: int) -> int:
    """Candidate depth for a final k (``VQT_RERANK_FETCH`` overrides; never
    below k)."""
    return max(k, int(os.environ.get("VQT_RERANK_FETCH",
                                     str(max(128, 4 * k)))))


def _lowmask(bucket: int) -> int:
    return (1 << max((bucket - 1).bit_length(), 1)) - 1


def _stable_topk(vals: torch.Tensor, k: int) -> Pair:
    """Top ``k`` along the last axis, descending, lowest index first on
    ties."""
    sv, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return sv[..., :k], order[..., :k]


def cand_scan_prefix_ref(emb: torch.Tensor, queries: torch.Tensor,
                         valid: int, *, bucket: int, rounds: int,
                         block_rows: int) -> Pair:
    """Plain PyTorch version of kernel B1: f32 scores ``emb @ q``, the
    packed-key selection per bucket, the ``[n_blocks, w, B]`` layout."""
    n_pad, _ = emb.shape
    b = queries.shape[0]
    lowmask = _lowmask(bucket)
    nb = block_rows // bucket
    sc = emb.float() @ queries.to(emb.dtype).float().t()        # [N, B]
    pos = torch.arange(n_pad, device=emb.device, dtype=torch.int32)
    keys = (sc + _KEY_BIAS).view(torch.int32)
    keys = torch.where((pos < valid)[:, None], keys, torch.zeros_like(keys))
    keys = (keys & ~lowmask) + (lowmask - pos % bucket)[:, None]
    # keys are unique inside a bucket, so any top-k order is exact
    wk = torch.topk(keys.view(n_pad // bucket, bucket, b), rounds,
                    dim=1).values                       # [G, rounds, B]
    vb = wk & ~lowmask
    # vb == 0 <=> every row of the bucket is dead
    vals = (vb.view(torch.float32) - _KEY_BIAS).masked_fill(vb == 0, NEG_INF)
    starts = torch.arange(0, n_pad, bucket, device=emb.device,
                          dtype=torch.int32)
    idxs = starts[:, None, None] + (lowmask - (wk & lowmask))
    n_blocks = n_pad // block_rows

    def layout(t):   # [G, r, B] -> [n_blocks, r * nb + j, B]
        return t.view(n_blocks, nb, rounds, b).transpose(1, 2).reshape(
            n_blocks, rounds * nb, b)

    return layout(vals), layout(idxs)


def cand_scan_prefix(emb: torch.Tensor, queries: torch.Tensor, valid: int,
                     *, bucket: int, rounds: int,
                     block_rows: int = None) -> Pair:
    """Bucket winners of the live-prefix candidate scan: ``(vals, idxs)``
    ``[n_blocks, rounds·block_rows/bucket, B]`` (f32 scores, i32 mirror
    positions). Kernel B1 on a CUDA mirror (bf16, the serving mirror), the
    plain version on a CPU one (any float dtype)."""
    block_rows = block_rows or CAND_BLOCK_ROWS
    q = queries.to(emb.dtype).contiguous()
    if emb.device.type == "cpu":
        return cand_scan_prefix_ref(emb, q, valid, bucket=bucket,
                                    rounds=rounds, block_rows=block_rows)
    dev = kernels.require_cuda(emb, q)
    n_pad, d = emb.shape
    b = q.shape[0]
    if emb.dtype != torch.bfloat16:
        raise TypeError(f"the candidate scan kernel takes a bf16 mirror, "
                        f"got {emb.dtype}")
    if q.ndim != 2 or q.shape[1] != d or n_pad % block_rows \
            or block_rows % bucket or bucket % 16 or d % 16 \
            or not 1 <= rounds <= 4 or emb.data_ptr() % 32:
        raise ValueError(f"unsupported candidate scan: N={n_pad} D={d} "
                         f"B={b} bucket={bucket} rounds={rounds} (the "
                         "mirror must start 32-byte aligned)")
    w = rounds * (block_rows // bucket)
    vals = torch.empty((n_pad // block_rows, w, b), dtype=torch.float32,
                       device=dev)
    idxs = torch.empty((n_pad // block_rows, w, b), dtype=torch.int32,
                       device=dev)
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().vqt_cand_scan_prefix(
            kernels.ptr(emb), kernels.ptr(q), kernels.ptr(vals),
            kernels.ptr(idxs), n_pad, d, b, int(valid), bucket, rounds,
            block_rows, kernels.stream(dev)), "candidate scan")
    kernels.count_launch(cand_scan_prefix)
    return vals, idxs


cand_scan_prefix.launches = 0


def _merge_tail(cand_vals: torch.Tensor, cand_idxs: torch.Tensor,
                perm: torch.Tensor, *, fetch: int) -> Pair:
    """Exact top-``fetch`` over the winner list, then mirror position →
    host row through ``perm`` (``_IMAX`` for positions past it)."""
    k_eff = min(fetch, cand_vals.shape[1])
    vals, pos = _stable_topk(cand_vals, k_eff)
    idxs = torch.gather(cand_idxs, 1, pos)
    n_pad = perm.shape[0]
    idxs = torch.where(idxs < n_pad,
                       perm[torch.clamp(idxs, max=n_pad - 1).long()],
                       torch.full_like(idxs, _IMAX))
    if k_eff < fetch:
        pad = fetch - k_eff
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        idxs = torch.nn.functional.pad(idxs, (0, pad), value=_IMAX)
    return vals, idxs


def _cand_merge_cols(bvals: torch.Tensor, bidxs: torch.Tensor,
                     perm: torch.Tensor, *, fetch: int) -> Pair:
    """Block-major winners ``[n_blocks, w, B]`` → per-query top-``fetch``
    (candidate order is the reference's: block-major, then w)."""
    n_blocks, w, b = bvals.shape
    return _merge_tail(bvals.reshape(n_blocks * w, b).t(),
                       bidxs.reshape(n_blocks * w, b).t(), perm,
                       fetch=fetch)


def _approx_scan(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
                 k: int, perm: Optional[torch.Tensor]) -> Pair:
    """Exact scan over the live prefix: f32 scores of the dtype-rounded
    queries, rows ``>= valid`` masked, stable top-k, perm translation."""
    n_pad = emb.shape[0]
    scores = queries.to(emb.dtype).float() @ emb.float().t()    # [B, N]
    rows = torch.arange(n_pad, device=emb.device)
    scores = scores.masked_fill((rows >= valid)[None, :], NEG_INF)
    k_eff = min(k, n_pad)
    vals, idxs = _stable_topk(scores, k_eff)
    idxs = idxs.to(torch.int32)
    if perm is not None:
        idxs = perm[idxs.long()]
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff), value=NEG_INF)
        idxs = torch.nn.functional.pad(idxs, (0, k - k_eff), value=_IMAX)
    return vals, idxs


def _fused_usable(n_pad: int, fetch: int, b: int) -> bool:
    """The fused scan engages when blocks and buckets divide evenly and
    the bucket winners can cover the fetch."""
    if b < 1 or n_pad <= 0 or n_pad % CAND_BLOCK_ROWS:
        return False
    if CAND_BLOCK_ROWS % CAND_BUCKET or CAND_BUCKET % 128:
        return False
    return (n_pad // CAND_BUCKET) * CAND_ROUNDS >= fetch


def prefix_fused_ok(live: int, fetch: int) -> bool:
    """Live-count gate: under the prefix layout the kernel emits
    ``rounds · ceil(live / bucket)`` live candidates; below ``min(fetch,
    live)`` the exact scan serves."""
    if live <= 0:
        return True
    winners = CAND_ROUNDS * -(-live // CAND_BUCKET)
    return winners >= min(fetch, live)


def _chunked_stage(stage: Callable[[torch.Tensor], Pair],
                   queries: torch.Tensor) -> Pair:
    step = CAND_MAX_B
    outs = [stage(queries[i:i + step])
            for i in range(0, queries.shape[0], step)]
    return (torch.cat([v for v, _ in outs]), torch.cat([i for _, i in outs]))


def candidate_stage(emb: torch.Tensor, queries: torch.Tensor, valid: int,
                    *, k: int, perm: Optional[torch.Tensor] = None,
                    live: Optional[int] = None) -> Pair:
    """Candidate scan over a live-prefix mirror: the fused scan when
    usable, the exact scan otherwise; batches wider than
    ``CAND_MAX_B`` chunk. Returns host rows when ``perm`` is given."""
    if queries.shape[0] > CAND_MAX_B:
        return _chunked_stage(
            lambda q: candidate_stage(emb, q, valid, k=k, perm=perm,
                                      live=live), queries)
    if _fused_usable(emb.shape[0], k, queries.shape[0]) \
            and (live is None or prefix_fused_ok(live, k)):
        if perm is None:
            perm = torch.arange(emb.shape[0], dtype=torch.int32,
                                device=emb.device)
        bvals, bidxs = cand_scan_prefix(emb, queries, valid,
                                        bucket=CAND_BUCKET,
                                        rounds=CAND_ROUNDS)
        return _cand_merge_cols(bvals, bidxs, perm, fetch=k)
    return _approx_scan(emb, queries, valid, k=k, perm=perm)


def candidate_topk(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
                   k: int, perm: Optional[torch.Tensor] = None,
                   live: Optional[int] = None) -> Pair:
    """Top-``k`` candidates (``k`` up to ``APPROX_FETCH_CAP``) of f32
    ``queries`` ``[B, D]`` or ``[D]`` over the live-prefix mirror, in
    host row space when ``perm`` is given."""
    if k <= 0 or k > APPROX_FETCH_CAP:
        raise ValueError(f"k must be in [1, {APPROX_FETCH_CAP}], got {k}")
    squeeze = queries.ndim == 1
    if squeeze:
        queries = queries[None, :]
    vals, idxs = candidate_stage(emb, queries.float(), int(valid), k=k,
                                 perm=perm, live=live)
    return (vals[0], idxs[0]) if squeeze else (vals, idxs)
