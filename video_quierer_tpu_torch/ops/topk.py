"""Similarity top-k over the device mirrors (counterpart of the pieces of
``video_quierer_tpu/ops/topk.py`` that search reads).

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
    ``CAND_ROUNDS`` rows by packed key, then an exact top-``fetch`` merge
    over the winner list and the mirror-position → host-row translation
    through ``perm``. Two mirror layouts: the live PREFIX of one card
    (``prefix=True``, liveness ``position < valid``: :func:`cand_scan_prefix`,
    kernel B1, over bf16 rows; :func:`cand_scan_int8_prefix`, B4, over int8
    codes; :func:`cand_scan_int4_prefix`, B7, over packed int4 codes) and
    the fixed-permutation layout of a corpus shard (``prefix=False``,
    liveness ``perm[position] < valid`` against the global live count:
    :func:`cand_scan`, B10, bf16; :func:`cand_scan_int8`, B11, int8);
  - the exact scan (:func:`_approx_scan` and its int8/int4 twins) for
    corpora too small for the bucket winners to cover the fetch
    (:func:`prefix_fused_ok`), whose capacity the kernel cannot tile
    (:func:`_fused_usable`), or under ``VQT_CANDIDATE_TOPK=approx``. The
    reference uses hardware ApproxTopK there; on this card the exact top-k
    is the plain choice.

  ``VQT_CANDIDATE_TOPK=pallas`` (the reference's exact-candidate hatch,
  read at call time) sends the bf16 and int8 stages of an identity-layout
  mirror (``perm=None``) to the exact scans instead: :func:`cosine_topk`
  over the bf16 rows (:func:`block_scan_bf16`, B8 on bf16 rows) and
  :func:`cosine_topk_int8` (:func:`block_scan_int8`, kernel B9), one
  top-k list per ``SCAN_SPAN_ROWS``-row span, the reference's macro. The int4
  stage keeps its fused scan under the hatch, as the reference's code does.

The quantized tiers use the reference's native contract: queries are
quantized to int8 like the rows (:func:`quantize_rows`), the products are exact
integer sums, and the scales multiply in the reference's order for each
path (``raw * row_scale * query_scale`` in the fused kernels, ``raw *
query_scale * row_scale`` in the exact scans). Their winners are
bit-identical to the JAX kernels'. The exact int8 scan (B9) is not
quantized: codes times the f32 query (B = 1) or the bf16-rounded query
(B > 1), summed in f32, times the row scale — the reference kernel's two
contracts.

Every top-k here is descending-stable: ties break to the lowest index
(stable sorts — ``torch.topk`` promises no tie order).
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
# rows of one tile of the exact f32 scan (its per-tile top-k lists): the
# reference's row block (video_quierer_tpu/ops/topk.py:64, BLOCK_ROWS)
SCAN_TILE_ROWS = 1024
# rows of one span of the exact scans over bf16 rows and int8 codes (one
# top-k list each): the reference's macro block, BLOCK_ROWS x SELECT_BLOCKS
# (video_quierer_tpu/ops/topk.py:64, :78)
SCAN_SPAN_ROWS = 8 * SCAN_TILE_ROWS
_KEY_BIAS = 2.0
_IMAX = 2**31 - 1
NEG_INF = float("-inf")

Pair = Tuple[torch.Tensor, torch.Tensor]


def _candidate_mode() -> str:
    """``VQT_CANDIDATE_TOPK``, read at every call as in the reference:
    ``"fused"`` (default), ``"approx"`` (the exact small-corpus scans
    serve) or ``"pallas"`` (the exact-candidate hatch)."""
    return os.environ.get("VQT_CANDIDATE_TOPK", "fused")


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


# -- fused candidate scans: kernels B1, B4, B7, B10, B11 and their plain
# versions ---------------------------------------------------------------

def _bucket_winners(sc: torch.Tensor, valid: int, *, bucket: int,
                    rounds: int, block_rows: int,
                    perm: Optional[torch.Tensor] = None) -> Pair:
    """The packed-key selection of the candidate kernels over f32 scores
    ``sc [N, B]``: the top ``rounds`` rows of every bucket, in the
    kernels' block-major ``[n_blocks, rounds·nb, B]`` layout. Row ``p`` is
    live when ``p < valid`` (live prefix), or ``perm[p] < valid`` when
    ``perm`` is given (perm layout)."""
    n_pad, b = sc.shape
    lowmask = _lowmask(bucket)
    nb = block_rows // bucket
    pos = torch.arange(n_pad, device=sc.device, dtype=torch.int32)
    live = (pos if perm is None else perm) < valid
    keys = (sc + _KEY_BIAS).view(torch.int32)
    keys = torch.where(live[:, None], keys, torch.zeros_like(keys))
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


def cand_scan_ref(emb: torch.Tensor, perm: torch.Tensor,
                  queries: torch.Tensor, valid: int, *, bucket: int,
                  rounds: int, block_rows: int) -> Pair:
    """Plain PyTorch version of kernel B10: B1 with row ``p`` live when
    ``perm[p] < valid``."""
    sc = emb.float() @ queries.to(emb.dtype).float().t()        # [N, B]
    return _bucket_winners(sc, valid, bucket=bucket, rounds=rounds,
                           block_rows=block_rows, perm=perm)


def _check_perm(perm: torch.Tensor, n_pad: int) -> None:
    if perm.dtype != torch.int32 or perm.shape != (n_pad,):
        raise ValueError(f"the perm column must be [{n_pad}] int32, got "
                         f"{tuple(perm.shape)} {perm.dtype}")


def _cand_scan_bf16(fn_name: str, wrapper, emb: torch.Tensor,
                    perm: Optional[torch.Tensor], q: torch.Tensor,
                    valid: int, *, bucket: int, rounds: int,
                    block_rows: int) -> Pair:
    """Launch B1 (``perm`` None) or B10 on CUDA operands."""
    dev = kernels.require_cuda(emb, q, *(() if perm is None else (perm,)))
    n_pad, d = emb.shape
    b = q.shape[0]
    if emb.dtype != torch.bfloat16:
        raise TypeError(f"the candidate scan kernel takes a bf16 mirror, "
                        f"got {emb.dtype}")
    if q.ndim != 2 or q.shape[1] != d or n_pad % block_rows \
            or block_rows % bucket or bucket % 64 or d % 16 \
            or not 1 <= rounds <= 4 or emb.data_ptr() % 32:
        raise ValueError(f"unsupported candidate scan: N={n_pad} D={d} "
                         f"B={b} bucket={bucket} rounds={rounds} (buckets "
                         "of whole 64-row tiles; the mirror must start "
                         "32-byte aligned)")
    if perm is not None:
        _check_perm(perm, n_pad)
    if q.data_ptr() % 16:            # the kernel loads 16-byte pieces
        q = q.clone()
    vals, idxs = _winner_buffers(n_pad, b, rounds, bucket, block_rows, dev)
    head = [kernels.ptr(emb)] + ([] if perm is None else [kernels.ptr(perm)])
    with torch.cuda.device(dev):
        kernels.check(getattr(kernels.lib(), fn_name)(
            *head, kernels.ptr(q), kernels.ptr(vals), kernels.ptr(idxs),
            n_pad, d, b, int(valid), bucket, rounds, block_rows,
            kernels.stream(dev)), fn_name)
    kernels.count_launch(wrapper)
    return vals, idxs


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
    return _cand_scan_bf16("vqt_cand_scan_prefix", cand_scan_prefix, emb,
                           None, q, valid, bucket=bucket, rounds=rounds,
                           block_rows=block_rows)


cand_scan_prefix.launches = 0


def cand_scan(emb: torch.Tensor, perm: torch.Tensor, queries: torch.Tensor,
              valid: int, *, bucket: int, rounds: int,
              block_rows: int = None) -> Pair:
    """Bucket winners of the perm-layout candidate scan (a corpus shard's
    bf16 mirror, ``perm [N]`` i32 its mirror position → host row column,
    ``valid`` the global live count), in B1's layout. Kernel B10 on CUDA
    tensors, the plain version on CPU ones."""
    block_rows = block_rows or CAND_BLOCK_ROWS
    q = queries.to(emb.dtype).contiguous()
    if emb.device.type == "cpu":
        return cand_scan_ref(emb, perm, q, valid, bucket=bucket,
                             rounds=rounds, block_rows=block_rows)
    return _cand_scan_bf16("vqt_cand_scan", cand_scan, emb, perm, q, valid,
                           bucket=bucket, rounds=rounds,
                           block_rows=block_rows)


cand_scan.launches = 0


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


def cand_scan_int8_ref(codes: torch.Tensor, scales: torch.Tensor,
                       perm: torch.Tensor, q_codes: torch.Tensor,
                       qscale: torch.Tensor, valid: int, *, bucket: int,
                       rounds: int, block_rows: int) -> Pair:
    """Plain PyTorch version of kernel B11: B4 with row ``p`` live when
    ``perm[p] < valid``."""
    sc = _dot_codes(codes, q_codes) * scales * qscale.t()
    return _bucket_winners(sc, valid, bucket=bucket, rounds=rounds,
                           block_rows=block_rows, perm=perm)


def _cand_scan_codes(fn_name: str, wrapper, ref, codes: torch.Tensor,
                     scales: torch.Tensor, q_codes: torch.Tensor,
                     qscale: torch.Tensor, valid: int, *, bucket: int,
                     rounds: int, block_rows: Optional[int], d: int,
                     perm: Optional[torch.Tensor] = None) -> Pair:
    """The quantized candidate scans: B4/B7 (``perm`` None, live prefix)
    or B11 (perm layout); the plain version ``ref`` for CPU tensors.
    Buckets are whole 64-row tiles of the kernels' tensor-core tile."""
    block_rows = block_rows or CAND_BLOCK_ROWS
    head = (codes, scales) + (() if perm is None else (perm,))
    if codes.device.type == "cpu":
        return ref(*head, q_codes, qscale, valid, bucket=bucket,
                   rounds=rounds, block_rows=block_rows)
    dev = kernels.require_cuda(*head, q_codes, qscale)
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
            or block_rows % bucket or bucket % 64 \
            or not 1 <= rounds <= 4 or codes.data_ptr() % 16 \
            or q_codes.data_ptr() % 16:
        raise ValueError(f"unsupported candidate scan: rows {codes.shape} "
                         f"D={d} B={b} bucket={bucket} rounds={rounds} "
                         "(row bytes a multiple of 64, buckets of whole "
                         "64-row tiles, codes and queries 16-byte aligned)")
    if perm is not None:
        _check_perm(perm, n_pad)
    # the tile copies each tile's scales (and perm entries) by TMA, which
    # takes 16-byte aligned columns
    scales = scales if scales.data_ptr() % 16 == 0 else scales.clone()
    if perm is not None and perm.data_ptr() % 16:
        perm = perm.clone()
    head = (codes, scales) + (() if perm is None else (perm,))
    vals, idxs = _winner_buffers(n_pad, b, rounds, bucket, block_rows, dev)
    with torch.cuda.device(dev):
        kernels.check(getattr(kernels.lib(), fn_name)(
            *(kernels.ptr(t) for t in head), kernels.ptr(q_codes),
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


def cand_ring_stages(emb: torch.Tensor, b: int, rounds: int) -> int:
    """The ring stages a warpgroup of B1 or B10 takes for ``b`` queries
    and ``rounds`` over the bf16 mirror ``emb`` ``[N, D]`` (chosen at
    launch from the shared memory the query panel and lists leave)."""
    with torch.cuda.device(emb.device):
        return kernels.lib().vqt_cand_scan_stages(emb.shape[1], b, rounds)


def codes_ring_stages(codes: torch.Tensor, b: int, rounds: int, *,
                      int4: bool) -> int:
    """The ring stages a warpgroup of B4 (int8 ``codes`` ``[N, D]``) or B7
    (``int4``: packed rows ``[N, D/2]``) takes for ``b`` queries and
    ``rounds`` (chosen at launch from the shared memory the panel and
    lists leave)."""
    d = codes.shape[1] * (2 if int4 else 1)
    with torch.cuda.device(codes.device):
        return kernels.lib().vqt_cand_scan_codes_stages(d, b, rounds,
                                                        int(int4))


def cand_scan_int8(codes: torch.Tensor, scales: torch.Tensor,
                   perm: torch.Tensor, q_codes: torch.Tensor,
                   qscale: torch.Tensor, valid: int, *, bucket: int,
                   rounds: int, block_rows: int = None) -> Pair:
    """Bucket winners over a corpus shard's perm-layout int8 mirror (row
    ``p`` live when ``perm[p] < valid``, the global live count), in B1's
    layout. Kernel B11 on CUDA tensors, the plain version on CPU ones."""
    return _cand_scan_codes(
        "vqt_cand_scan_int8", cand_scan_int8, cand_scan_int8_ref, codes,
        scales, q_codes, qscale, valid, bucket=bucket, rounds=rounds,
        block_rows=block_rows, d=codes.shape[1], perm=perm)


cand_scan_int8.launches = 0


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
                 perm: Optional[torch.Tensor], prefix: bool) -> Pair:
    """Dead rows masked (position ``>= valid``, or ``perm[position] >=
    valid`` under the perm layout: ``perm`` given and ``prefix`` False),
    stable top-k, perm translation, pads."""
    n_pad = scores.shape[1]
    if perm is None or prefix:
        dead = torch.arange(n_pad, device=scores.device) >= valid
    else:
        dead = perm >= valid
    scores = scores.masked_fill(dead[None, :], NEG_INF)
    vals, idxs = _stable_topk(scores, min(k, n_pad))
    idxs = idxs.to(torch.int32)
    if perm is not None:
        idxs = perm[idxs.long()]
    return _pad_k(vals, idxs, k)


def _approx_scan(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
                 k: int, perm: Optional[torch.Tensor],
                 prefix: bool = True) -> Pair:
    """Exact scan of a float mirror: f32 scores of the dtype-rounded
    queries."""
    scores = queries.to(emb.dtype).float() @ emb.float().t()    # [B, N]
    return _approx_tail(scores, valid, k=k, perm=perm, prefix=prefix)


def _approx_scan_int8(codes: torch.Tensor, scales: torch.Tensor,
                      queries: torch.Tensor, valid: int, *, k: int,
                      perm: Optional[torch.Tensor],
                      prefix: bool = True) -> Pair:
    """Exact scan of the int8 mirror: ``raw * qscale * row_scale``."""
    q_codes, qscale = quantize_rows(queries)
    scores = _dot_codes(codes, q_codes).t() * qscale * scales[:, 0][None, :]
    return _approx_tail(scores, valid, k=k, perm=perm, prefix=prefix)


def _approx_scan_int4(packed: torch.Tensor, scales: torch.Tensor,
                      queries: torch.Tensor, valid: int, *, k: int,
                      perm: Optional[torch.Tensor],
                      prefix: bool = True) -> Pair:
    """Exact scan of the packed int4 mirror (two half-depth dots)."""
    q_codes, qscale = quantize_rows(queries)
    scores = (_dot_packed(packed, q_codes).t() * qscale
              * scales[:, 0][None, :])
    return _approx_tail(scores, valid, k=k, perm=perm, prefix=prefix)


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
    live)`` the exact scan serves. (The perm layout spreads live rows over
    every bucket, so it has no such gate.)"""
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
                 min_b: Optional[int] = None, *, prefix: bool = True) -> bool:
    return _candidate_mode() != "approx" \
        and _fused_usable(n_pad, k, b, min_b) \
        and (not prefix or live is None or prefix_fused_ok(live, k))


def _identity(n_pad: int, device) -> torch.Tensor:
    return torch.arange(n_pad, dtype=torch.int32, device=device)


def candidate_stage(emb: torch.Tensor, queries: torch.Tensor, valid: int,
                    *, k: int, perm: Optional[torch.Tensor] = None,
                    prefix: bool = True,
                    live: Optional[int] = None) -> Pair:
    """Candidate scan over a bf16 mirror: the fused scan when usable (B1
    over a live-prefix mirror, B10 over a perm-layout one,
    ``prefix=False``), the exact scan otherwise; batches wider than
    ``CAND_MAX_B`` chunk. Returns host rows when ``perm`` is given. (The
    reference's ``prefix`` defaults to False; the port's single-card
    callers are the prefix ones, so its default is True and the sharded
    scans pass False.)"""
    if queries.shape[0] > CAND_MAX_B:
        return _chunked_stage(
            lambda q: candidate_stage(emb, q, valid, k=k, perm=perm,
                                      prefix=prefix, live=live), queries)
    if _fused_route(emb.shape[0], k, queries.shape[0], live,
                    prefix=prefix):
        if perm is None:
            perm = _identity(emb.shape[0], emb.device)
        if prefix:
            bvals, bidxs = cand_scan_prefix(emb, queries, valid,
                                            bucket=CAND_BUCKET,
                                            rounds=CAND_ROUNDS)
            return _cand_merge_cols(bvals, bidxs, perm, fetch=k)
        bvals, bidxs = cand_scan(emb, perm, queries, valid,
                                 bucket=CAND_BUCKET, rounds=CAND_ROUNDS)
        return _cand_merge(bvals, bidxs, perm, fetch=k)
    return _approx_scan(emb, queries, valid, k=k, perm=perm, prefix=prefix)


def candidate_stage_int8(codes: torch.Tensor, scales: torch.Tensor,
                         queries: torch.Tensor, valid: int, *, k: int,
                         perm: Optional[torch.Tensor] = None,
                         prefix: bool = True,
                         live: Optional[int] = None) -> Pair:
    """Int8 twin of :func:`candidate_stage` (kernels B4 and B11)."""
    if queries.shape[0] > CAND_MAX_B:
        return _chunked_stage(
            lambda q: candidate_stage_int8(codes, scales, q, valid, k=k,
                                           perm=perm, prefix=prefix,
                                           live=live), queries)
    if _fused_route(codes.shape[0], k, queries.shape[0], live,
                    prefix=prefix):
        if perm is None:
            perm = _identity(codes.shape[0], codes.device)
        q_codes, qscale = quantize_rows(queries)
        if prefix:
            bvals, bidxs = cand_scan_int8_prefix(
                codes, scales, q_codes, qscale, valid, bucket=CAND_BUCKET,
                rounds=CAND_ROUNDS)
        else:
            bvals, bidxs = cand_scan_int8(
                codes, scales, perm, q_codes, qscale, valid,
                bucket=CAND_BUCKET, rounds=CAND_ROUNDS)
        return _cand_merge(bvals, bidxs, perm, fetch=k)
    return _approx_scan_int8(codes, scales, queries, valid, k=k, perm=perm,
                             prefix=prefix)


def candidate_stage_int4(packed: torch.Tensor, scales: torch.Tensor,
                         queries: torch.Tensor, valid: int, *, k: int,
                         perm: Optional[torch.Tensor] = None,
                         prefix: bool = True,
                         live: Optional[int] = None) -> Pair:
    """Int4 twin of :func:`candidate_stage_int8` over the packed
    split-halves mirror (kernel B7, live-prefix layout only; another
    layout takes the exact scan). The fused scan serves from B=1 even
    when ``VQT_FUSED_MIN_B`` is raised: the exact scan materializes the
    unpacked codes."""
    if queries.shape[0] > CAND_MAX_B:
        return _chunked_stage(
            lambda q: candidate_stage_int4(packed, scales, q, valid, k=k,
                                           perm=perm, prefix=prefix,
                                           live=live), queries)
    if prefix and _fused_route(packed.shape[0], k, queries.shape[0], live,
                               min_b=1):
        if perm is None:
            perm = _identity(packed.shape[0], packed.device)
        q_codes, qscale = quantize_rows(queries)
        bvals, bidxs = cand_scan_int4_prefix(
            packed, scales, q_codes, qscale, valid, bucket=CAND_BUCKET,
            rounds=CAND_ROUNDS)
        return _cand_merge(bvals, bidxs, perm, fetch=k)
    return _approx_scan_int4(packed, scales, queries, valid, k=k, perm=perm,
                             prefix=prefix)


def _candidate_dispatch(stage: Callable[[torch.Tensor], Pair],
                        queries: torch.Tensor, k: int,
                        exact: Optional[Callable[[int], Pair]] = None,
                        perm: Optional[torch.Tensor] = None) -> Pair:
    """The hatch (``VQT_CANDIDATE_TOPK=pallas``: ``exact(min(k, MAX_K))``
    for an identity-layout mirror, ``perm`` None), else check ``k``,
    squeeze 1-D queries and run ``stage(queries [B, D] f32)``."""
    if exact is not None and perm is None and _candidate_mode() == "pallas":
        return exact(min(k, MAX_K))
    if k <= 0 or k > APPROX_FETCH_CAP:
        raise ValueError(f"k must be in [1, {APPROX_FETCH_CAP}], got {k}")
    squeeze = queries.ndim == 1
    if squeeze:
        queries = queries[None, :]
    vals, idxs = stage(queries.float())
    return (vals[0], idxs[0]) if squeeze else (vals, idxs)


def candidate_topk(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
                   k: int, perm: Optional[torch.Tensor] = None,
                   prefix: bool = True,
                   live: Optional[int] = None) -> Pair:
    """Top-``k`` candidates (``k`` up to ``APPROX_FETCH_CAP``) of f32
    ``queries`` ``[B, D]`` or ``[D]`` over the bf16 mirror, in host row
    space when ``perm`` is given; the exact scan over the bf16 rows under
    the hatch."""
    return _candidate_dispatch(
        lambda q: candidate_stage(emb, q, int(valid), k=k, perm=perm,
                                  prefix=prefix, live=live), queries, k,
        lambda kk: cosine_topk(emb, queries, valid, k=kk), perm)


def candidate_topk_int8(codes: torch.Tensor, scales: torch.Tensor,
                        queries: torch.Tensor, valid: int, *, k: int,
                        perm: Optional[torch.Tensor] = None,
                        prefix: bool = True,
                        live: Optional[int] = None) -> Pair:
    """:func:`candidate_topk` over the int8 mirror (the hatch:
    :func:`cosine_topk_int8`)."""
    return _candidate_dispatch(
        lambda q: candidate_stage_int8(codes, scales, q, int(valid), k=k,
                                       perm=perm, prefix=prefix, live=live),
        queries, k,
        lambda kk: cosine_topk_int8(codes, scales, queries, valid, k=kk),
        perm)


def candidate_topk_int4(packed: torch.Tensor, scales: torch.Tensor,
                        queries: torch.Tensor, valid: int, *, k: int,
                        perm: Optional[torch.Tensor] = None,
                        prefix: bool = True,
                        live: Optional[int] = None) -> Pair:
    """:func:`candidate_topk` over the packed int4 mirror. The hatch does
    not apply: int4 has no exact kernel, and the reference's code keeps
    the fused scan (its docstring says the approx scan; the code
    rules)."""
    return _candidate_dispatch(
        lambda q: candidate_stage_int4(packed, scales, q, int(valid), k=k,
                                       perm=perm, prefix=prefix, live=live),
        queries, k)


# -- the exact scans: kernels B8 (f32 and bf16 rows) and B9 (int8) ---------

def _tile_topk(sc: torch.Tensor, valid: int, *, k: int, tile_rows: int
               ) -> Pair:
    """Per ``tile_rows``-row tile of the scores ``sc [B, N]`` and query,
    the top ``k`` rows by (score desc, row asc), rows ``>= valid`` scored
    ``-inf``; ``[n_tiles, B, k]``, short tiles padded with ``(-inf,
    _IMAX)``."""
    b, n = sc.shape
    n_tiles = -(-n // tile_rows)
    rows = torch.arange(n, device=sc.device)
    sc = sc.masked_fill((rows >= valid)[None, :], NEG_INF)
    # pad rows sort after every real row of their tile (-inf, higher row)
    sc = torch.nn.functional.pad(sc, (0, n_tiles * tile_rows - n),
                                 value=NEG_INF)
    vals, pos = _stable_topk(sc.view(b, n_tiles, tile_rows),
                             min(k, tile_rows))
    starts = torch.arange(0, n_tiles * tile_rows, tile_rows,
                          device=sc.device)
    idxs = pos + starts[None, :, None]
    idxs = idxs.masked_fill(idxs >= n, _IMAX).to(torch.int32)
    vals, idxs = _pad_k(vals, idxs, k)
    return vals.transpose(0, 1).contiguous(), idxs.transpose(0, 1).contiguous()


def block_scan_ref(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
                   k: int, tile_rows: int) -> Pair:
    """Plain PyTorch version of kernel B8 (f32 or bf16 rows, the queries
    already rounded to the rows' dtype): f32 scores, then the per-tile
    top ``k`` (:func:`_tile_topk`)."""
    return _tile_topk(queries.float() @ emb.float().t(), valid, k=k,
                      tile_rows=tile_rows)


def block_scan_int8_ref(codes: torch.Tensor, scales: torch.Tensor,
                        queries: torch.Tensor, valid: int, *, k: int,
                        tile_rows: int) -> Pair:
    """Plain PyTorch version of kernel B9: ``(q · codes) * row_scale`` in
    f32 for the contract's queries (:func:`_int8_scan_queries`), then the
    per-tile top ``k``."""
    sc = (queries.float() @ codes.float().t()) * scales[:, 0][None, :]
    return _tile_topk(sc, valid, k=k, tile_rows=tile_rows)


def span_ring_stages(emb: torch.Tensor, b: int, k: int) -> int:
    """The ring stages a warpgroup of the span tile takes for ``b`` queries
    and ``k`` over the bf16 rows or int8 codes ``emb`` (chosen at launch
    from the shared memory the panel, parks and lists leave)."""
    with torch.cuda.device(emb.device):
        return kernels.lib().vqt_block_scan_stages(
            emb.shape[1], b, k, kernels.dtype_code(emb))


def _block_scan(wrapper, emb: torch.Tensor, scales: Optional[torch.Tensor],
                q: torch.Tensor, valid: int, *, k: int,
                tile_rows: int) -> Pair:
    """Launch B8 (``scales`` None; f32 or bf16 rows) or B9 (int8 codes)
    on CUDA operands; ``q`` f32 ``[B, D]``. bf16 rows and int8 codes take
    the span tile, whose spans are whole 64-row tiles."""
    dev = kernels.require_cuda(emb, q,
                               *(() if scales is None else (scales,)))
    n, d = emb.shape
    b = q.shape[0]
    if q.ndim != 2 or q.shape[1] != d or d % 32 or not 1 <= k <= MAX_K \
            or emb.data_ptr() % 16 or q.data_ptr() % 16 \
            or (scales is not None and (scales.shape != (n, 1)
                                        or scales.dtype != torch.float32
                                        or scales.data_ptr() % 16)) \
            or (emb.dtype != torch.float32 and tile_rows % 64):
        raise ValueError(f"unsupported exact scan: N={n} D={d} B={b} k={k} "
                         f"rows={tile_rows} (D a multiple of 32, 16-byte "
                         "aligned operands, 16-byte aligned [N, 1] f32 "
                         "scales, spans of whole 64-row tiles)")
    n_tiles = -(-n // tile_rows)
    vals = torch.empty((n_tiles, b, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((n_tiles, b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().vqt_block_scan(
            kernels.ptr(emb),
            None if scales is None else kernels.ptr(scales), kernels.ptr(q),
            kernels.ptr(vals), kernels.ptr(idxs), n, d, b, int(valid), k,
            tile_rows, kernels.dtype_code(emb), kernels.stream(dev)),
            "exact scan")
    kernels.count_launch(wrapper)
    return vals, idxs


def _require_dtype(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} takes a {dtype} matrix, got {t.dtype}")


def block_scan(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
               k: int, tile_rows: int = None) -> Pair:
    """Per-tile top-``k`` lists ``[n_tiles, B, k]`` of the exact f32 scan
    (``k <= MAX_K``). Kernel B8 on CUDA tensors (f32 matrix: the FMA tile
    up to B = 8, the 3xTF32 tensor-core tile past it), the plain version
    on CPU ones."""
    tile_rows = tile_rows or SCAN_TILE_ROWS
    q = queries.float().contiguous()
    if emb.device.type == "cpu":
        return block_scan_ref(emb, q, valid, k=k, tile_rows=tile_rows)
    _require_dtype(emb, torch.float32, "the exact scan kernel")
    return _block_scan(block_scan, emb, None, q, valid, k=k,
                       tile_rows=tile_rows)


block_scan.launches = 0


def block_scan_bf16(emb: torch.Tensor, queries: torch.Tensor, valid: int,
                    *, k: int, tile_rows: int = None) -> Pair:
    """Per-span top-``k`` lists ``[n_spans, B, k]`` (``SCAN_SPAN_ROWS``
    rows a span unless ``tile_rows`` says otherwise) of the exact scan over
    bf16 rows, the queries rounded to bf16 as the reference's
    ``cosine_topk`` rounds them (every product then exact in f32). Kernel
    B8 on bf16 rows (the span tile) on CUDA tensors, counted apart from
    the f32 scan's launches."""
    tile_rows = tile_rows or SCAN_SPAN_ROWS
    q = queries.to(torch.bfloat16).float().contiguous()
    if emb.device.type == "cpu":
        return block_scan_ref(emb, q, valid, k=k, tile_rows=tile_rows)
    _require_dtype(emb, torch.bfloat16, "the bf16 exact scan kernel")
    return _block_scan(block_scan_bf16, emb, None, q, valid, k=k,
                       tile_rows=tile_rows)


block_scan_bf16.launches = 0


def _int8_scan_queries(queries: torch.Tensor, n: int) -> torch.Tensor:
    """The reference exact int8 scan's query contract: the f32 query for
    one query over a whole number of ``SCAN_TILE_ROWS`` tiles (its kernel's
    flat B = 1 layout, ``topk.py:_use_flat_layout``), else the query
    rounded to bf16 (its MXU layout, and its XLA path for other row
    counts)."""
    q = queries.float()
    if q.shape[0] == 1 and n % SCAN_TILE_ROWS == 0:
        return q.contiguous()
    return q.to(torch.bfloat16).float().contiguous()


def block_scan_int8(codes: torch.Tensor, scales: torch.Tensor,
                    queries: torch.Tensor, valid: int, *, k: int,
                    tile_rows: int = None) -> Pair:
    """Per-span top-``k`` lists ``[n_spans, B, k]`` of the exact int8
    scan (``SCAN_SPAN_ROWS`` rows a span unless ``tile_rows`` says
    otherwise): codes ``[N, D]`` int8 times the contract's f32 queries
    (:func:`_int8_scan_queries`), summed in f32, times the row scales
    ``[N, 1]`` f32. Kernel B9 (the span tile) on CUDA tensors, the plain
    version on CPU ones."""
    tile_rows = tile_rows or SCAN_SPAN_ROWS
    q = _int8_scan_queries(queries, codes.shape[0])
    if codes.device.type == "cpu":
        return block_scan_int8_ref(codes, scales, q, valid, k=k,
                                   tile_rows=tile_rows)
    _require_dtype(codes, torch.int8, "the exact int8 scan kernel")
    return _block_scan(block_scan_int8, codes, scales, q, valid, k=k,
                       tile_rows=tile_rows)


block_scan_int8.launches = 0


def merge_topk(vals: torch.Tensor, idxs: torch.Tensor, *, k: int) -> Pair:
    """Global top-``k`` of candidate lists ``[B, M]`` whose positions put
    lower rows first among equal values (tile or span lists in ascending
    row order): descending-stable, lowest row first on ties."""
    k_eff = min(k, vals.shape[-1])
    top_vals, pos = _stable_topk(vals, k_eff)
    return _pad_k(top_vals, torch.gather(idxs, -1, pos), k)


def _exact_topk(scan: Callable[[torch.Tensor], Pair], queries: torch.Tensor,
                k: int) -> Pair:
    """Check ``k``, squeeze 1-D queries, run the per-tile ``scan`` and
    merge its lists."""
    if k <= 0 or k > MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    squeeze = queries.ndim == 1
    if squeeze:
        queries = queries[None, :]
    bvals, bidxs = scan(queries)
    n_tiles, b, _ = bvals.shape
    vals, idxs = merge_topk(bvals.transpose(0, 1).reshape(b, n_tiles * k),
                            bidxs.transpose(0, 1).reshape(b, n_tiles * k),
                            k=k)
    return (vals[0], idxs[0]) if squeeze else (vals, idxs)


def cosine_topk(emb: torch.Tensor, queries: torch.Tensor, valid: int, *,
                k: int) -> Pair:
    """Exact top-``k`` similarity scan of the matrix ``emb [N, D]`` (f32,
    or bf16 rows with the queries rounded to bf16): ``(scores [B, k] f32,
    rows [B, k] i32)`` for ``queries`` ``[B, D]`` or ``[D]`` (already
    normalized by the caller), descending-stable, entries past ``valid``
    scored ``-inf``. ``k <= MAX_K``."""
    if emb.dtype not in (torch.float32, torch.bfloat16):
        emb = emb.float()
    scan = block_scan_bf16 if emb.dtype == torch.bfloat16 else block_scan
    return _exact_topk(lambda q: scan(emb, q, int(valid), k=k), queries, k)


def cosine_topk_int8(codes: torch.Tensor, scales: torch.Tensor,
                     queries: torch.Tensor, valid: int, *, k: int) -> Pair:
    """:func:`cosine_topk` over int8 codes and their row scales (kernel
    B9): scores carry the codes' quantization error, so callers that want
    exact ordering re-rank the candidates in f32 (the index does)."""
    return _exact_topk(
        lambda q: block_scan_int8(codes, scales, q, int(valid), k=k),
        queries, k)
