"""Similarity top-k over the device mirrors (counterpart of the pieces of
``video_quierer_tpu/ops/topk.py`` that single-device search reads).

Four mirror dtypes, as in the reference:

- **float32**, the exact tier: :func:`cosine_topk` scores every live row
  exactly in f32 (:func:`block_scan`, kernel B8 on a CUDA tensor: the top
  ``k`` of every ``SCAN_TILE_ROWS``-row tile) and merges the tiles' lists
  (:func:`merge_topk`). Its scores are the results; nothing is re-ranked.
- **bfloat16**, **int8**, **int4**: candidate stages. They never return
  scores to the caller: they over-fetch ``fetch`` host rows per query, and
  the index re-ranks them exactly in f32. Each has two routes, chosen as
  in the reference:

  - the fused scan: per ``CAND_BUCKET``-row bucket of the mirror, the top
    ``CAND_ROUNDS`` rows by packed key (:func:`cand_scan_prefix`, kernel
    B1, over bf16 rows; :func:`cand_scan_int8_prefix`, B4, over int8
    codes; :func:`cand_scan_int4_prefix`, B7, over packed int4 codes),
    then an exact top-``fetch`` merge over the winner list and the
    mirror-position → host-row translation through ``perm``;
  - the exact scan (:func:`_approx_scan` and its int8/int4 twins) for
    corpora too small for the bucket winners to cover the fetch
    (:func:`prefix_fused_ok`) or whose capacity the kernel cannot tile
    (:func:`_fused_usable`). The reference uses hardware ApproxTopK there;
    on this card the exact top-k is the plain choice.

The quantized tiers use the reference's native contract: queries are
quantized to int8 like the rows (:func:`quantize_rows`), the products are exact
integer sums, and the scales multiply in the reference's order for each
path (``raw * row_scale * query_scale`` in the fused kernels, ``raw *
query_scale * row_scale`` in the exact scans). Their winners are
bit-identical to the JAX kernels'.

Every top-k here is descending-stable: ties break to the lowest index
(stable sorts — ``torch.topk`` promises no tie order).

Only the live-PREFIX mirror layout of the candidate stages is ported
(single device: live rows fill mirror positions ``[0, valid)``); the
perm-layout scans of the corpus meshes are later ports.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch

from video_quierer_tpu_torch.ops import kernels
from video_quierer_tpu_torch.ops.quantize import quantize_rows

MAX_K = 64                 # reference API cap on k
APPROX_FETCH_CAP = 1024    # deepest candidate fetch
# the reference's scan geometry: winners per bucket, rows per bucket and
# per block (the index pads capacity to a multiple of the block)
CAND_BUCKET = 1024
CAND_ROUNDS = 2
CAND_BLOCK_ROWS = 4096
# widest query batch one fused scan takes; wider batches chunk
CAND_MAX_B = 256
# narrowest query batch the fused scan takes (VQT_FUSED_MIN_B, as in the
# reference; the int4 tier takes the fused scan from B=1 regardless)
FUSED_MIN_B = int(os.environ.get("VQT_FUSED_MIN_B", "1"))
# rows of one tile of the exact scan (its per-tile top-k lists)
SCAN_TILE_ROWS = 1024
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


def _pad_k(vals: torch.Tensor, idxs: torch.Tensor, k: int) -> Pair:
    """Pad the last axis to ``k`` with ``(-inf, _IMAX)``."""
    pad = k - vals.shape[-1]
    if pad > 0:
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        idxs = torch.nn.functional.pad(idxs, (0, pad), value=_IMAX)
    return vals, idxs


# -- fused candidate scans: kernels B1, B4, B7 and their plain versions ---

def _bucket_winners(sc: torch.Tensor, valid: int, *, bucket: int,
                    rounds: int, block_rows: int) -> Pair:
    """The packed-key selection of the candidate kernels over f32 scores
    ``sc [N, B]``: the top ``rounds`` rows of every bucket, in the
    kernels' block-major ``[n_blocks, rounds·nb, B]`` layout."""
    n_pad, b = sc.shape
    lowmask = _lowmask(bucket)
    nb = block_rows // bucket
    pos = torch.arange(n_pad, device=sc.device, dtype=torch.int32)
    keys = (sc + _KEY_BIAS).view(torch.int32)
    keys = torch.where((pos < valid)[:, None], keys, torch.zeros_like(keys))
    keys = (keys & ~lowmask) + (lowmask - pos % bucket)[:, None]
    # keys are unique inside a bucket, so any top-k order is exact
    wk = torch.topk(keys.view(n_pad // bucket, bucket, b), rounds,
                    dim=1).values                       # [G, rounds, B]
    vb = wk & ~lowmask
    # vb == 0 <=> every row of the bucket is dead
    vals = (vb.view(torch.float32) - _KEY_BIAS).masked_fill(vb == 0, NEG_INF)
    starts = torch.arange(0, n_pad, bucket, device=sc.device,
                          dtype=torch.int32)
    idxs = starts[:, None, None] + (lowmask - (wk & lowmask))
    n_blocks = n_pad // block_rows

    def layout(t):   # [G, r, B] -> [n_blocks, r * nb + j, B]
        return t.view(n_blocks, nb, rounds, b).transpose(1, 2).reshape(
            n_blocks, rounds * nb, b)

    return layout(vals), layout(idxs)


def cand_scan_prefix_ref(emb: torch.Tensor, queries: torch.Tensor,
                         valid: int, *, bucket: int, rounds: int,
                         block_rows: int) -> Pair:
    """Plain PyTorch version of kernel B1: f32 scores ``emb @ q``, the
    packed-key selection per bucket, the ``[n_blocks, w, B]`` layout."""
    sc = emb.float() @ queries.to(emb.dtype).float().t()        # [N, B]
    return _bucket_winners(sc, valid, bucket=bucket, rounds=rounds,
                           block_rows=block_rows)


def _winner_buffers(n_pad: int, b: int, rounds: int, bucket: int,
                    block_rows: int, dev) -> Pair:
    w = rounds * (block_rows // bucket)
    shape = (n_pad // block_rows, w, b)
    return (torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


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
    vals, idxs = _winner_buffers(n_pad, b, rounds, bucket, block_rows, dev)
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().vqt_cand_scan_prefix(
            kernels.ptr(emb), kernels.ptr(q), kernels.ptr(vals),
            kernels.ptr(idxs), n_pad, d, b, int(valid), bucket, rounds,
            block_rows, kernels.stream(dev)), "candidate scan")
    kernels.count_launch(cand_scan_prefix)
    return vals, idxs


cand_scan_prefix.launches = 0


def _unpack_nibbles(packed: torch.Tensor) -> Pair:
    """``[..., D/2] int8`` packed → ``(lo, hi)`` int8 nibbles, sign
    extended by arithmetic shifts in int32 (values in [-8, 7])."""
    x = packed.to(torch.int32)
    return ((x << 28) >> 28).to(torch.int8), (x >> 4).to(torch.int8)


def _dot_codes(codes: torch.Tensor, q_codes: torch.Tensor) -> torch.Tensor:
    """Integer dot products ``codes @ q_codes.T`` ``[N, B]`` as f32. The
    sums are exact: |sum| <= D·127·127 < 2^24 for D <= 1040 (an f32
    matmul of integer codes, TF32 off; CUDA has no int8 matmul)."""
    return codes.float() @ q_codes.float().t()


def _dot_packed(packed: torch.Tensor, q_codes: torch.Tensor
                ) -> torch.Tensor:
    """Integer dot products of the packed int4 rows: low nibbles with
    ``q[:, :D/2]`` plus high nibbles with ``q[:, D/2:]`` (exact, as
    :func:`_dot_codes`)."""
    half = packed.shape[1]
    lo, hi = _unpack_nibbles(packed)
    return (_dot_codes(lo, q_codes[:, :half])
            + _dot_codes(hi, q_codes[:, half:]))


def cand_scan_int8_prefix_ref(codes: torch.Tensor, scales: torch.Tensor,
                              q_codes: torch.Tensor, qscale: torch.Tensor,
                              valid: int, *, bucket: int, rounds: int,
                              block_rows: int) -> Pair:
    """Plain PyTorch version of kernel B4: ``raw * row_scale * qscale``,
    then B1's selection and layout."""
    sc = _dot_codes(codes, q_codes) * scales * qscale.t()
    return _bucket_winners(sc, valid, bucket=bucket, rounds=rounds,
                           block_rows=block_rows)


def cand_scan_int4_prefix_ref(packed: torch.Tensor, scales: torch.Tensor,
                              q_codes: torch.Tensor, qscale: torch.Tensor,
                              valid: int, *, bucket: int, rounds: int,
                              block_rows: int) -> Pair:
    """Plain PyTorch version of kernel B7 (B4 over the packed int4
    mirror)."""
    sc = _dot_packed(packed, q_codes) * scales * qscale.t()
    return _bucket_winners(sc, valid, bucket=bucket, rounds=rounds,
                           block_rows=block_rows)


def _cand_scan_codes(fn_name: str, wrapper, ref, codes: torch.Tensor,
                     scales: torch.Tensor, q_codes: torch.Tensor,
                     qscale: torch.Tensor, valid: int, *, bucket: int,
                     rounds: int, block_rows: Optional[int], d: int
                     ) -> Pair:
    block_rows = block_rows or CAND_BLOCK_ROWS
    if codes.device.type == "cpu":
        return ref(codes, scales, q_codes, qscale, valid, bucket=bucket,
                   rounds=rounds, block_rows=block_rows)
    dev = kernels.require_cuda(codes, scales, q_codes, qscale)
    n_pad = codes.shape[0]
    b = q_codes.shape[0]
    if codes.dtype != torch.int8 or q_codes.dtype != torch.int8 \
            or scales.dtype != torch.float32 \
            or qscale.dtype != torch.float32:
        raise TypeError("the quantized candidate scans take int8 codes and "
                        "f32 scales")
    if q_codes.ndim != 2 or q_codes.shape[1] != d \
            or scales.shape != (n_pad, 1) or qscale.shape != (b, 1) \
            or codes.shape[1] % 64 or n_pad % block_rows \
            or block_rows % bucket or bucket % 16 \
            or not 1 <= rounds <= 4 or codes.data_ptr() % 16 \
            or q_codes.data_ptr() % 16:
        raise ValueError(f"unsupported candidate scan: rows {codes.shape} "
                         f"D={d} B={b} bucket={bucket} rounds={rounds} "
                         "(row bytes a multiple of 64, codes and queries "
                         "16-byte aligned)")
    vals, idxs = _winner_buffers(n_pad, b, rounds, bucket, block_rows, dev)
    with torch.cuda.device(dev):
        kernels.check(getattr(kernels.lib(), fn_name)(
            kernels.ptr(codes), kernels.ptr(scales), kernels.ptr(q_codes),
            kernels.ptr(qscale), kernels.ptr(vals), kernels.ptr(idxs),
            n_pad, d, b, int(valid), bucket, rounds, block_rows,
            kernels.stream(dev)), fn_name)
    kernels.count_launch(wrapper)
    return vals, idxs


def cand_scan_int8_prefix(codes: torch.Tensor, scales: torch.Tensor,
                          q_codes: torch.Tensor, qscale: torch.Tensor,
                          valid: int, *, bucket: int, rounds: int,
                          block_rows: int = None) -> Pair:
    """Bucket winners over the int8 live-prefix mirror (codes ``[N, D]``,
    scales ``[N, 1]``) for int8 queries (codes ``[B, D]``, scales ``[B,
    1]``), in B1's layout. Kernel B4 on CUDA tensors, the plain version on
    CPU ones."""
    return _cand_scan_codes(
        "vqt_cand_scan_int8_prefix", cand_scan_int8_prefix,
        cand_scan_int8_prefix_ref, codes, scales, q_codes, qscale, valid,
        bucket=bucket, rounds=rounds, block_rows=block_rows,
        d=codes.shape[1])


cand_scan_int8_prefix.launches = 0


def cand_scan_int4_prefix(packed: torch.Tensor, scales: torch.Tensor,
                          q_codes: torch.Tensor, qscale: torch.Tensor,
                          valid: int, *, bucket: int, rounds: int,
                          block_rows: int = None) -> Pair:
    """:func:`cand_scan_int8_prefix` over the packed int4 mirror
    (``[N, D/2]``, split-halves nibbles). Kernel B7 on CUDA tensors."""
    return _cand_scan_codes(
        "vqt_cand_scan_int4_prefix", cand_scan_int4_prefix,
        cand_scan_int4_prefix_ref, packed, scales, q_codes, qscale, valid,
        bucket=bucket, rounds=rounds, block_rows=block_rows,
        d=2 * packed.shape[1])


cand_scan_int4_prefix.launches = 0


# -- merges ---------------------------------------------------------------

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
    return _pad_k(vals, idxs, fetch)


def _cand_merge_cols(bvals: torch.Tensor, bidxs: torch.Tensor,
                     perm: torch.Tensor, *, fetch: int) -> Pair:
    """Block-major winners ``[n_blocks, w, B]`` → per-query top-``fetch``
    in the reference's col-orient candidate order (block-major, then w:
    the bf16 tier)."""
    n_blocks, w, b = bvals.shape
    return _merge_tail(bvals.reshape(n_blocks * w, b).t(),
                       bidxs.reshape(n_blocks * w, b).t(), perm,
                       fetch=fetch)


def _cand_merge(bvals: torch.Tensor, bidxs: torch.Tensor,
                perm: torch.Tensor, *, fetch: int) -> Pair:
    """Winners ``[n_blocks, w, B]`` → per-query top-``fetch`` in the
    reference's row-orient candidate order (winner-slot-major, then block:
    the int8/int4 tiers). Winner values carry floored low bits, so many tie
    at the fetch cut; the order decides which survive, as in JAX."""
    n_blocks, w, b = bvals.shape
    return _merge_tail(bvals.permute(2, 1, 0).reshape(b, w * n_blocks),
                       bidxs.permute(2, 1, 0).reshape(b, w * n_blocks),
                       perm, fetch=fetch)


# -- exact scans for small corpora ----------------------------------------

def _approx_tail(scores: torch.Tensor, valid: int, *, k: int,
                 perm: Optional[torch.Tensor]) -> Pair:
    """Rows ``>= valid`` masked, stable top-k, perm translation, pads."""
    n_pad = scores.shape[1]
    rows = torch.arange(n_pad, device=scores.device)
    scores = scores.masked_fill((rows >= valid)[None, :], NEG_INF)
    vals, idxs = _stable_topk(scores, min(k, n_pad))
    idxs = idxs.to(torch.int32)
    if perm is not None:
        idxs = perm[idxs.long()]
    return _pad_k(vals, idxs, k)


def _approx_scan(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
                 k: int, perm: Optional[torch.Tensor]) -> Pair:
    """Exact scan over the live prefix: f32 scores of the dtype-rounded
    queries."""
    scores = queries.to(emb.dtype).float() @ emb.float().t()    # [B, N]
    return _approx_tail(scores, valid, k=k, perm=perm)


def _approx_scan_int8(codes: torch.Tensor, scales: torch.Tensor,
                      queries: torch.Tensor, valid: int, *, k: int,
                      perm: Optional[torch.Tensor]) -> Pair:
    """Exact scan of the int8 mirror: ``raw * qscale * row_scale``."""
    q_codes, qscale = quantize_rows(queries)
    scores = _dot_codes(codes, q_codes).t() * qscale * scales[:, 0][None, :]
    return _approx_tail(scores, valid, k=k, perm=perm)


def _approx_scan_int4(packed: torch.Tensor, scales: torch.Tensor,
                      queries: torch.Tensor, valid: int, *, k: int,
                      perm: Optional[torch.Tensor]) -> Pair:
    """Exact scan of the packed int4 mirror (two half-depth dots)."""
    q_codes, qscale = quantize_rows(queries)
    scores = (_dot_packed(packed, q_codes).t() * qscale
              * scales[:, 0][None, :])
    return _approx_tail(scores, valid, k=k, perm=perm)


# -- routing ----------------------------------------------------------------

def _fused_usable(n_pad: int, fetch: int, b: int,
                  min_b: Optional[int] = None) -> bool:
    """The fused scan engages for batches of at least ``FUSED_MIN_B``
    queries (``min_b`` overrides: the int4 tier pins 1) when blocks and
    buckets divide evenly and the bucket winners can cover the fetch."""
    if b < (FUSED_MIN_B if min_b is None else min_b):
        return False
    if n_pad <= 0 or n_pad % CAND_BLOCK_ROWS:
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


def _fused_route(n_pad: int, k: int, b: int, live: Optional[int],
                 min_b: Optional[int] = None) -> bool:
    return _fused_usable(n_pad, k, b, min_b) \
        and (live is None or prefix_fused_ok(live, k))


def _identity(n_pad: int, device) -> torch.Tensor:
    return torch.arange(n_pad, dtype=torch.int32, device=device)


def candidate_stage(emb: torch.Tensor, queries: torch.Tensor, valid: int,
                    *, k: int, perm: Optional[torch.Tensor] = None,
                    live: Optional[int] = None) -> Pair:
    """Candidate scan over a bf16 live-prefix mirror: the fused scan when
    usable, the exact scan otherwise; batches wider than ``CAND_MAX_B``
    chunk. Returns host rows when ``perm`` is given."""
    if queries.shape[0] > CAND_MAX_B:
        return _chunked_stage(
            lambda q: candidate_stage(emb, q, valid, k=k, perm=perm,
                                      live=live), queries)
    if _fused_route(emb.shape[0], k, queries.shape[0], live):
        if perm is None:
            perm = _identity(emb.shape[0], emb.device)
        bvals, bidxs = cand_scan_prefix(emb, queries, valid,
                                        bucket=CAND_BUCKET,
                                        rounds=CAND_ROUNDS)
        return _cand_merge_cols(bvals, bidxs, perm, fetch=k)
    return _approx_scan(emb, queries, valid, k=k, perm=perm)


def candidate_stage_int8(codes: torch.Tensor, scales: torch.Tensor,
                         queries: torch.Tensor, valid: int, *, k: int,
                         perm: Optional[torch.Tensor] = None,
                         live: Optional[int] = None) -> Pair:
    """Int8 twin of :func:`candidate_stage` (kernel B4)."""
    if queries.shape[0] > CAND_MAX_B:
        return _chunked_stage(
            lambda q: candidate_stage_int8(codes, scales, q, valid, k=k,
                                           perm=perm, live=live), queries)
    if _fused_route(codes.shape[0], k, queries.shape[0], live):
        if perm is None:
            perm = _identity(codes.shape[0], codes.device)
        q_codes, qscale = quantize_rows(queries)
        bvals, bidxs = cand_scan_int8_prefix(
            codes, scales, q_codes, qscale, valid, bucket=CAND_BUCKET,
            rounds=CAND_ROUNDS)
        return _cand_merge(bvals, bidxs, perm, fetch=k)
    return _approx_scan_int8(codes, scales, queries, valid, k=k, perm=perm)


def candidate_stage_int4(packed: torch.Tensor, scales: torch.Tensor,
                         queries: torch.Tensor, valid: int, *, k: int,
                         perm: Optional[torch.Tensor] = None,
                         live: Optional[int] = None) -> Pair:
    """Int4 twin of :func:`candidate_stage_int8` over the packed
    split-halves mirror (kernel B7). The fused scan serves from B=1 even
    when ``VQT_FUSED_MIN_B`` is raised: the exact scan materializes the
    unpacked codes."""
    if queries.shape[0] > CAND_MAX_B:
        return _chunked_stage(
            lambda q: candidate_stage_int4(packed, scales, q, valid, k=k,
                                           perm=perm, live=live), queries)
    if _fused_route(packed.shape[0], k, queries.shape[0], live, min_b=1):
        if perm is None:
            perm = _identity(packed.shape[0], packed.device)
        q_codes, qscale = quantize_rows(queries)
        bvals, bidxs = cand_scan_int4_prefix(
            packed, scales, q_codes, qscale, valid, bucket=CAND_BUCKET,
            rounds=CAND_ROUNDS)
        return _cand_merge(bvals, bidxs, perm, fetch=k)
    return _approx_scan_int4(packed, scales, queries, valid, k=k, perm=perm)


def _candidate_dispatch(stage: Callable[[torch.Tensor], Pair],
                        queries: torch.Tensor, k: int) -> Pair:
    """Check ``k``, squeeze 1-D queries, run ``stage(queries [B, D] f32)``."""
    if k <= 0 or k > APPROX_FETCH_CAP:
        raise ValueError(f"k must be in [1, {APPROX_FETCH_CAP}], got {k}")
    squeeze = queries.ndim == 1
    if squeeze:
        queries = queries[None, :]
    vals, idxs = stage(queries.float())
    return (vals[0], idxs[0]) if squeeze else (vals, idxs)


def candidate_topk(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
                   k: int, perm: Optional[torch.Tensor] = None,
                   live: Optional[int] = None) -> Pair:
    """Top-``k`` candidates (``k`` up to ``APPROX_FETCH_CAP``) of f32
    ``queries`` ``[B, D]`` or ``[D]`` over the bf16 live-prefix mirror, in
    host row space when ``perm`` is given."""
    return _candidate_dispatch(
        lambda q: candidate_stage(emb, q, int(valid), k=k, perm=perm,
                                  live=live), queries, k)


def candidate_topk_int8(codes: torch.Tensor, scales: torch.Tensor,
                        queries: torch.Tensor, valid: int, *, k: int,
                        perm: Optional[torch.Tensor] = None,
                        live: Optional[int] = None) -> Pair:
    """:func:`candidate_topk` over the int8 mirror."""
    return _candidate_dispatch(
        lambda q: candidate_stage_int8(codes, scales, q, int(valid), k=k,
                                       perm=perm, live=live), queries, k)


def candidate_topk_int4(packed: torch.Tensor, scales: torch.Tensor,
                        queries: torch.Tensor, valid: int, *, k: int,
                        perm: Optional[torch.Tensor] = None,
                        live: Optional[int] = None) -> Pair:
    """:func:`candidate_topk` over the packed int4 mirror."""
    return _candidate_dispatch(
        lambda q: candidate_stage_int4(packed, scales, q, int(valid), k=k,
                                       perm=perm, live=live), queries, k)


# -- the exact f32 tier: kernel B8 ------------------------------------------

def block_scan_ref(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
                   k: int, tile_rows: int) -> Pair:
    """Plain PyTorch version of kernel B8: per ``tile_rows``-row tile and
    query, the top ``k`` rows by (f32 score desc, row asc), rows ``>=
    valid`` scored ``-inf``; ``[n_tiles, B, k]``, short tiles padded with
    ``(-inf, _IMAX)``."""
    n = emb.shape[0]
    b = queries.shape[0]
    n_tiles = -(-n // tile_rows)
    sc = queries.float() @ emb.float().t()                     # [B, N]
    rows = torch.arange(n, device=emb.device)
    sc = sc.masked_fill((rows >= valid)[None, :], NEG_INF)
    # pad rows sort after every real row of their tile (-inf, higher row)
    sc = torch.nn.functional.pad(sc, (0, n_tiles * tile_rows - n),
                                 value=NEG_INF)
    vals, pos = _stable_topk(sc.view(b, n_tiles, tile_rows),
                             min(k, tile_rows))
    starts = torch.arange(0, n_tiles * tile_rows, tile_rows,
                          device=emb.device)
    idxs = pos + starts[None, :, None]
    idxs = idxs.masked_fill(idxs >= n, _IMAX).to(torch.int32)
    vals, idxs = _pad_k(vals, idxs, k)
    return vals.transpose(0, 1).contiguous(), idxs.transpose(0, 1).contiguous()


def block_scan(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
               k: int, tile_rows: int = None) -> Pair:
    """Per-tile top-``k`` lists ``[n_tiles, B, k]`` of the exact f32 scan
    (``k <= MAX_K``). Kernel B8 on CUDA tensors (f32 matrix), the plain
    version on CPU ones."""
    tile_rows = tile_rows or SCAN_TILE_ROWS
    q = queries.float().contiguous()
    if emb.device.type == "cpu":
        return block_scan_ref(emb, q, valid, k=k, tile_rows=tile_rows)
    dev = kernels.require_cuda(emb, q)
    n, d = emb.shape
    b = q.shape[0]
    if emb.dtype != torch.float32:
        raise TypeError(f"the exact scan kernel takes an f32 matrix, got "
                        f"{emb.dtype}")
    if q.ndim != 2 or q.shape[1] != d or d % 32 or not 1 <= k <= MAX_K \
            or emb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"unsupported exact scan: N={n} D={d} B={b} k={k} "
                         "(D a multiple of 32, 16-byte aligned operands)")
    n_tiles = -(-n // tile_rows)
    vals = torch.empty((n_tiles, b, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((n_tiles, b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().vqt_block_scan(
            kernels.ptr(emb), kernels.ptr(q), kernels.ptr(vals),
            kernels.ptr(idxs), n, d, b, int(valid), k, tile_rows,
            kernels.stream(dev)), "exact scan")
    kernels.count_launch(block_scan)
    return vals, idxs


block_scan.launches = 0


def merge_topk(vals: torch.Tensor, idxs: torch.Tensor, *, k: int) -> Pair:
    """Global top-``k`` of candidate lists ``[B, M]`` whose positions put
    lower rows first among equal values (tile lists in ascending tile
    order): descending-stable, lowest row first on ties."""
    k_eff = min(k, vals.shape[-1])
    top_vals, pos = _stable_topk(vals, k_eff)
    return _pad_k(top_vals, torch.gather(idxs, -1, pos), k)


def cosine_topk(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
                k: int) -> Pair:
    """Exact top-``k`` similarity scan of the f32 matrix ``emb [N, D]``:
    ``(scores [B, k] f32, rows [B, k] i32)`` for ``queries`` ``[B, D]`` or
    ``[D]`` (already normalized by the caller), descending-stable, entries
    past ``valid`` scored ``-inf``. ``k <= MAX_K``."""
    if k <= 0 or k > MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    squeeze = queries.ndim == 1
    if squeeze:
        queries = queries[None, :]
    bvals, bidxs = block_scan(emb, queries, int(valid), k=k)
    n_tiles, b, _ = bvals.shape
    vals, idxs = merge_topk(bvals.transpose(0, 1).reshape(b, n_tiles * k),
                            bidxs.transpose(0, 1).reshape(b, n_tiles * k),
                            k=k)
    return (vals[0], idxs[0]) if squeeze else (vals, idxs)
