"""The bucket fold of the bf16 candidate scan (kernels B1 and B10,
``video_quierer_tpu_torch/csrc/cand_scan.cu``), emulated in numpy step by
step and held against the port's plain selection
``ops/topk.py:_bucket_winners``.

The kernel never parks scores in shared memory: each thread of a
warpgroup folds the scores its ``wgmma`` m64nN accumulator fragment holds
(2 rows x N/4 query columns of every 64-row tile) into running top-R
packed-key lists, one per column; at the bucket's end the 8 lanes that
share a column merge by xor shuffles 4, 8 and 16, then the 4 warps merge
through shared memory and one thread a query writes the winners. Buckets
of the live prefix wholly past ``valid`` are not read and emit (-inf,
row0 + r). These tests run that decomposition on the CPU: the ownership
map, the per-thread lists over a bucket's tiles, the shuffle merge and the
cross-warp merge, on random, tied, all-dead, mid-bucket-``valid`` and
perm-liveness scores. Winners must be bit-identical to the plain
version's: keys are unique inside a bucket, so every merge order gives the
same top R.

The int8 scans (kernels B4 and B11, ``csrc/cand_scan_codes.cu``) fold the
same way from the ``wgmma`` m64nNk32 s32 fragment, whose ownership is the
f32 one's; each thread first forms its elements' scores as
``fmul_rn(fmul_rn(float32(raw), row_scale), query_scale)``. The int8 cases
emulate that rounding in numpy float32 and hold the winners against
``cand_scan_int8_prefix_ref`` and ``cand_scan_int8_ref``.

The int4 scan (kernel B7, the same tile over packed int4 rows) widens the
nibbles in registers into ``wgmma``'s A fragment: per 32-bit word of
packed bytes, ``(w << 4) & 0xF0F0F0F0`` is 16 x the low nibbles and ``w &
0xF0F0F0F0`` 16 x the high ones, as s8 bytes; each thread feeds its two
16-byte chunks of a box as k32 steps in its own order, and the query panel
holds its feature columns in that order. The int4 cases emulate the
widening over every byte value, the fragments and the panel as the kernel
builds them (the 128-byte swizzle is an address map that ``wgmma`` undoes,
so it is left out), the s32 sum (16 x raw), ``raw = acc >> 4``, the score
and the fold, and hold the winners against ``cand_scan_int4_prefix_ref``
and, once, the JAX kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

from video_quierer_tpu_torch.ops import topk
from video_quierer_tpu_torch.ops.quantize import (
    quantize_rows,
    quantize_rows_int4,
)

TILE = 64
WARPS = 4
LANES = 32
INT_MIN = np.iinfo(np.int32).min


def owner_map(n):
    """(row, col) of accumulator element ``i`` of lane ``l`` of warp ``w``
    in a wgmma m64nN f32 fragment: ``acc[4 j + 2 h + e]`` is row ``16 w +
    l / 4 + 8 h``, column ``8 j + 2 (l % 4) + e``. Arrays [4, 32, N/2]."""
    w = np.arange(WARPS)[:, None, None]
    lane = np.arange(LANES)[None, :, None]
    i = np.arange(n // 2)[None, None, :]
    rows = 16 * w + lane // 4 + 8 * ((i // 2) % 2)
    cols = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return np.broadcast_arrays(rows, cols)


def owner_map_s32(n):
    """The m64nNk32 s32 fragment as the PTX ISA draws it: lane ``l`` of
    warp ``w`` holds pairs of adjacent columns, pair ``p`` (registers ``2
    p``, ``2 p + 1``) in row ``16 w + l / 4`` for even ``p`` and 8 rows
    lower for odd ``p``, columns ``8 (p / 2) + 2 (l % 4)`` on."""
    w = np.arange(WARPS)[:, None, None]
    lane = np.arange(LANES)[None, :, None]
    i = np.arange(n // 2)[None, None, :]
    pair = i // 2
    rows = 16 * w + lane // 4 + 8 * (pair % 2)
    cols = 8 * (pair // 2) + 2 * (lane % 4) + i % 2
    return np.broadcast_arrays(rows, cols)


def insert(top, key):
    """Insert ``key`` [...] into the descending lists ``top`` [..., R] as
    the kernel does (a max/min chain; keys unique, INT_MIN pads last)."""
    top = top.copy()
    for r in range(top.shape[-1]):
        hi = np.maximum(top[..., r], key)
        key = np.minimum(top[..., r], key)
        top[..., r] = hi
    return top


def row_keys(sc, live, pos, lowmask):
    """cand_select.cuh:row_key — (bits(score + 2.0) & ~lowmask) + lowmask
    - pos, bits 0 for a dead row; the add rounded on its own in f32."""
    bits = (sc.astype(np.float32) + np.float32(2.0)).view(np.int32)
    bits = np.where(live, bits, np.int32(0)).astype(np.int64)
    return (bits & ~lowmask) + (lowmask - pos)


def thread_lists(score, live, n, rounds, lowmask, tiles):
    """Per-thread lists over a bucket's tiles: [4, 32, N/4, R] keys.
    ``score(pos, cols)`` gives the f32 scores a thread forms for its
    fragment elements (bucket positions ``pos``, query columns ``cols``).
    Column list ``2 j + e`` of a thread takes elements ``4 j + e`` (row
    pos) and ``4 j + 2 + e`` (row pos + 8) of each tile's fragment."""
    rows, cols = owner_map(n)
    top = np.full((WARPS, LANES, n // 4, rounds), INT_MIN, np.int64)
    for t in range(tiles):
        for i in range(n // 2):
            pos = t * TILE + rows[..., i]
            key = row_keys(score(pos, cols[..., i]), live[pos], pos,
                           lowmask)
            c = 2 * (i // 4) + i % 2
            top[:, :, c] = insert(top[:, :, c], key)
    return top


def xor_merge(top):
    """The shuffle merge: lanes ``l`` and ``l ^ o`` swap lists and keep the
    top R of both, for o = 4, 8, 16."""
    lane = np.arange(LANES)
    for o in (4, 8, 16):
        other = top[:, lane ^ o]
        for r in range(top.shape[-1]):
            top = insert(top, other[..., r])
    return top


def cross_warp(top, n, rounds):
    """Lanes 0-3 of every warp park their column lists ([4, N, R]); the
    thread of query column c merges the 4 warps' lists."""
    _, cols = owner_map(n)
    red = np.zeros((WARPS, n, rounds), np.int64)
    for i in range(0, n // 2, 4):                 # element 4 j (+ e)
        for e in range(2):
            c = 2 * (i // 4) + e
            red[:, cols[0, :4, i + e]] = top[:, :4, c]
    best = np.full((n, rounds), INT_MIN, np.int64)
    for w in range(WARPS):
        for r in range(rounds):
            best = insert(best, red[w, :, r])
    return best


def emulate(sc, valid, *, n, bucket, rounds, block_rows, perm=None):
    """The bf16 kernel's whole selection over scores ``sc [rows, B]`` (B <=
    N; the panel's padding queries score 0 and are not emitted), in the
    ``[n_blocks, R nb, B]`` layout."""
    rows_n, b = sc.shape
    pad = np.zeros((rows_n, n), np.float32)
    pad[:, :b] = sc
    return fold(lambda row0: lambda pos, cols: pad[row0 + pos, cols],
                rows_n, b, valid, n=n, bucket=bucket, rounds=rounds,
                block_rows=block_rows, perm=perm)


def emulate_int8(codes, scales, q_codes, qscale, valid, *, n, bucket,
                 rounds, block_rows, perm=None):
    """The int8 kernel's whole selection: exact integer sums of the codes
    ``[rows, D]`` and the query codes ``[B, D]`` (zero codes and scale 0
    pad the panel to N queries), each owned element scored by its thread
    as ``(float32(raw) * row_scale) * query_scale``, rounded after each
    multiply, then B1's fold."""
    rows_n, b = codes.shape[0], q_codes.shape[0]
    qpad = np.zeros((n, codes.shape[1]), np.int64)
    qpad[:b] = q_codes
    qs = np.zeros(n, np.float32)
    qs[:b] = qscale[:, 0]
    raw = codes.astype(np.int64) @ qpad.T            # exact: < 2^24
    assert np.abs(raw).max() < 2 ** 24

    def score(row0):
        def at(pos, cols):
            r = raw[row0 + pos, cols].astype(np.float32)
            return (r * scales[row0 + pos, 0]) * qs[cols]
        return at

    return fold(score, rows_n, b, valid, n=n, bucket=bucket, rounds=rounds,
                block_rows=block_rows, perm=perm)


def fold(score, rows_n, b, valid, *, n, bucket, rounds, block_rows, perm):
    """The selection of both kernels: ``score(row0)`` gives the scores of
    the bucket starting at mirror row ``row0`` (as ``thread_lists`` takes
    them); per-thread lists, the shuffle merge, the cross-warp merge and
    the winners in the ``[n_blocks, R nb, B]`` layout."""
    lowmask = topk._lowmask(bucket)
    nb = block_rows // bucket
    pos_all = np.arange(rows_n)
    live_all = (pos_all if perm is None else perm) < valid
    vals = np.zeros((rows_n // block_rows, rounds * nb, b), np.float32)
    idxs = np.zeros(vals.shape, np.int32)
    for g in range(rows_n // bucket):
        row0 = g * bucket
        blk, jb = divmod(g, nb)
        if perm is None and row0 >= valid:        # not read: all dead
            for r in range(rounds):
                vals[blk, r * nb + jb] = -np.inf
                idxs[blk, r * nb + jb] = row0 + r
            continue
        lists = thread_lists(score(row0), live_all[row0:row0 + bucket], n,
                             rounds, lowmask, bucket // TILE)
        best = cross_warp(xor_merge(lists), n, rounds)[:b]
        for r in range(rounds):
            wk = best[:, r]
            vb = (wk & ~lowmask).astype(np.int32)
            v = vb.view(np.float32) - np.float32(2.0)
            vals[blk, r * nb + jb] = np.where(vb == 0, -np.inf, v)
            idxs[blk, r * nb + jb] = row0 + (lowmask - (wk & lowmask))
    return vals, idxs


def _scores(case, rows, b, seed):
    rng = np.random.default_rng(seed)
    if case == "tied":
        # few distinct values: equal keys break to the lowest position
        return (rng.integers(-3, 4, (rows, b)) / 8).astype(np.float32)
    return rng.uniform(-1, 1, (rows, b)).astype(np.float32)


# (case, valid, perm) over 4,096 rows
CASES = {
    "random": (4096, False),
    "tied": (4096, False),
    "all_dead": (0, False),
    "mid_bucket_valid": (1500, False),
    "perm": (5000, True),
}


@pytest.mark.parametrize("n", [16, 64])
def test_ownership_map_covers_the_tile_once(n):
    rows, cols = owner_map(n)
    flat = (rows * n + cols).ravel()
    assert sorted(flat.tolist()) == list(range(TILE * n))
    # a thread's N/4 columns, shared by the 8 lanes of equal lane % 4
    for lane in range(LANES):
        assert set(cols[0, lane].tolist()) == {
            8 * j + 2 * (lane % 4) + e for j in range(n // 8)
            for e in range(2)}


@pytest.mark.parametrize("n", [16, 64])
def test_s32_fragment_is_owned_as_the_f32_one(n):
    """The int8 scan's s32 accumulator fragment, drawn on its own, is the
    bf16 scan's f32 map: the same fold applies to both."""
    rows, cols = owner_map_s32(n)
    f_rows, f_cols = owner_map(n)
    assert np.array_equal(rows, f_rows) and np.array_equal(cols, f_cols)


@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_xor_merge_gives_each_lane_its_columns_top(rounds):
    rng = np.random.default_rng(rounds)
    keys = rng.permutation(WARPS * LANES * 4 * 8)[:WARPS * LANES * 4 * rounds]
    top = -np.sort(-keys.reshape(WARPS, LANES, 4, rounds), axis=-1)
    merged = xor_merge(top.astype(np.int64))
    for w in range(WARPS):
        for lane in range(LANES):
            group = top[w, lane % 4::4]           # the 8 lanes of its t4
            want = -np.sort(-group.transpose(1, 0, 2).reshape(4, -1),
                            axis=-1)[:, :rounds]
            assert np.array_equal(merged[w, lane], want)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("rounds", [1, 2, 4])
@pytest.mark.parametrize("n,b", [(16, 1), (16, 13), (64, 64), (64, 37)])
def test_fold_matches_bucket_winners(case, rounds, n, b):
    valid, use_perm = CASES[case]
    rows, bucket, block_rows = 4096, 1024, 2048
    sc = _scores(case, rows, b, seed=rounds * 100 + b)
    perm = None
    if use_perm:
        perm = np.random.default_rng(b).permutation(2 * rows)[:rows]
        perm[1024:2048] = valid + np.arange(1024)   # a bucket dead by perm
    got_v, got_i = emulate(sc, valid, n=n, bucket=bucket, rounds=rounds,
                           block_rows=block_rows, perm=perm)
    want_v, want_i = topk._bucket_winners(
        torch.from_numpy(sc), valid, bucket=bucket, rounds=rounds,
        block_rows=block_rows,
        perm=None if perm is None else torch.from_numpy(perm.astype(
            np.int32)))
    assert np.array_equal(got_v, want_v.numpy())
    assert np.array_equal(got_i, want_i.numpy())


@pytest.mark.parametrize("valid", [0, 100, 1024, 1100])
def test_fold_small_buckets(valid):
    """128-row buckets (two tiles), a mid-tile and an edge ``valid``."""
    sc = _scores("random", 1024, 5, seed=valid)
    got = emulate(sc, valid, n=16, bucket=128, rounds=2, block_rows=512)
    want = topk._bucket_winners(torch.from_numpy(sc), valid, bucket=128,
                                rounds=2, block_rows=512)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())


def _int8_case(case, rows, b, d, seed):
    """int8 codes and scales of seeded unit rows (``tied``: a quarter of
    the rows repeat earlier ones, equal keys; zero rows, scale 0), and
    quantized unit queries — the port's quantization."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((rows, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    if case == "tied":
        emb[1::4] = emb[0::4]
    emb[200:210] = 0
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    codes, scales = quantize_rows(torch.from_numpy(emb))
    q_codes, qscale = quantize_rows(torch.from_numpy(q))
    return codes, scales, q_codes, qscale


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("rounds", [1, 2, 4])
@pytest.mark.parametrize("n,b", [(16, 1), (64, 64), (64, 37)])
def test_int8_fold_matches_plain_scan(case, rounds, n, b):
    """B4 (live prefix) and B11 (``perm``: dead rows scattered, one bucket
    dead by perm) as the int8 tile folds them, bit-identical to their
    plain versions."""
    valid, use_perm = CASES[case]
    rows, bucket, block_rows, d = 4096, 1024, 2048, 64
    codes, scales, q_codes, qscale = _int8_case(case, rows, b, d,
                                                seed=rounds * 100 + b)
    scan = dict(bucket=bucket, rounds=rounds, block_rows=block_rows)
    perm = None
    if use_perm:
        perm = np.random.default_rng(b).permutation(2 * rows)[:rows]
        perm[1024:2048] = valid + np.arange(1024)   # a bucket dead by perm
        want = topk.cand_scan_int8_ref(
            codes, scales, torch.from_numpy(perm.astype(np.int32)), q_codes,
            qscale, valid, **scan)
    else:
        want = topk.cand_scan_int8_prefix_ref(codes, scales, q_codes,
                                              qscale, valid, **scan)
    got = emulate_int8(codes.numpy(), scales.numpy(), q_codes.numpy(),
                       qscale.numpy(), valid, n=n, perm=perm, **scan)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("valid", [0, 100, 1024, 1100])
def test_int8_fold_small_buckets(valid):
    """128-row buckets (two tiles), a mid-tile and an edge ``valid``."""
    codes, scales, q_codes, qscale = _int8_case("random", 1024, 5, 128,
                                                seed=valid)
    scan = dict(bucket=128, rounds=2, block_rows=512)
    got = emulate_int8(codes.numpy(), scales.numpy(), q_codes.numpy(),
                       qscale.numpy(), valid, n=16, **scan)
    want = topk.cand_scan_int8_prefix_ref(codes, scales, q_codes, qscale,
                                          valid, **scan)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())


# -- B7: the int4 rows, widened in registers ------------------------------

KBOX = 128          # packed bytes of a row in one TMA box


def widen16(words):
    """cand_scan_codes.cu:low16 / high16 on uint32 words: 16 x the low
    nibbles and 16 x the high ones of each byte, as s8 bytes (words of the
    same shape)."""
    w = np.asarray(words, np.uint32)
    return (w << np.uint32(4)) & np.uint32(0xF0F0F0F0), \
        w & np.uint32(0xF0F0F0F0)


def a_fragments(packed):
    """The s8 values of every k-slot of the kernel's k32 steps for each row
    ``[rows, kc_n * 256]``, in its step order (box kc, chunk r, step u,
    slot s). A row's box is its packed bytes, zeros past D/2 (TMA's fill);
    thread t of a quad loads 16-byte chunk 2 t + r of the box (words m = 0
    .. 3); step u takes words 2 (u % 2) and + 1, widened low (u < 2) or
    high, as the fragment's slots 4 t .. 4 t + 3 (a[0]) and 16 + 4 t ..
    (a[2]), byte i as slot + i."""
    rows, half = packed.shape
    kc_n = -(-half // KBOX)
    box = np.zeros((rows, kc_n * KBOX), np.uint8)
    box[:, :half] = packed.view(np.uint8)
    lo, hi = widen16(box.view("<u4"))
    lo8, hi8 = lo.view(np.int8), hi.view(np.int8)   # 4 bytes a word
    cols, sides = [], []
    for kc in range(kc_n):
        for r in range(2):
            for u in range(4):
                for s in range(32):
                    hs, t, i = s // 16, s % 16 // 4, s % 4
                    word = kc * 32 + 4 * (2 * t + r) + 2 * (u % 2) + hs
                    cols.append(4 * word + i)
                    sides.append(u >= 2)
    cols, sides = np.array(cols), np.array(sides)
    return np.where(sides, hi8[:, cols], lo8[:, cols]).astype(np.int64)


def query_panel(q_codes, d):
    """The query panel as the kernel writes it, unswizzled ``[QN, kc_n *
    256]``: block 2 kc + r, 16-byte piece p, word t holds packed bytes
    ``128 kc + 32 t + 16 r + 8 (p / 2 % 2) + 4 (p % 2)`` .. + 3 of the row
    (features j, or j + D/2 for p >= 4), zeros past the row."""
    qn = q_codes.shape[0]
    half = d // 2
    kc_n = -(-half // KBOX)
    panel = np.zeros((qn, kc_n * 2 * KBOX), np.int64)
    for blk in range(2 * kc_n):
        for p in range(8):
            base = 128 * (blk // 2) + 16 * (blk % 2) + 8 * (p // 2 % 2) + \
                4 * (p % 2)
            for t in range(4):
                j = base + 32 * t
                if j >= half:
                    continue
                f = j + (half if p >= 4 else 0)
                col = blk * KBOX + 16 * p + 4 * t
                panel[:, col:col + 4] = q_codes[:, f:f + 4]
    return panel


def emulate_int4(packed, scales, q_codes, qscale, valid, *, n, bucket,
                 rounds, block_rows):
    """The int4 kernel's whole selection: the s32 sums of the widened
    fragments and the panel (16 x raw, exact), ``raw = acc >> 4``, each
    owned element scored as ``(float32(raw) * row_scale) * query_scale``,
    then B1's fold."""
    rows_n, half = packed.shape
    b = q_codes.shape[0]
    qpad = np.zeros((n, 2 * half), np.int64)
    qpad[:b] = q_codes
    qs = np.zeros(n, np.float32)
    qs[:b] = qscale[:, 0]
    acc = a_fragments(packed) @ query_panel(qpad, 2 * half).T
    assert np.abs(acc).max() < 2 ** 31 and not (acc % 16).any()
    raw = acc >> 4

    def score(row0):
        def at(pos, cols):
            r = raw[row0 + pos, cols].astype(np.float32)
            return (r * scales[row0 + pos, 0]) * qs[cols]
        return at

    return fold(score, rows_n, b, valid, n=n, bucket=bucket, rounds=rounds,
                block_rows=block_rows, perm=None)


def test_int4_widening_covers_every_byte():
    """Every byte value: the widened bytes are 16 x the reference's sign
    extended nibbles (``(x << 28) >> 28`` and ``x >> 4`` on int32)."""
    every = np.arange(256, dtype=np.uint8)
    lo, hi = widen16(every.view("<u4"))
    want_lo, want_hi = topk._unpack_nibbles(torch.from_numpy(
        every.view(np.int8)))
    assert np.array_equal(lo.view(np.int8).astype(np.int64),
                          16 * want_lo.numpy().astype(np.int64))
    assert np.array_equal(hi.view(np.int8).astype(np.int64),
                          16 * want_hi.numpy().astype(np.int64))


@pytest.mark.parametrize("d", [128, 384, 512, 768])
def test_int4_k_order_sums_the_split_halves(d):
    """The fragments' k order and the panel's columns meet: the s32 sum is
    exactly 16 x the split-halves dot product, for random bytes (every
    nibble, -8 and 7 included) against query codes at +-127 and random
    ones; every panel column past the packed row is zero."""
    rng = np.random.default_rng(d)
    packed = rng.integers(-128, 128, (64, d // 2)).astype(np.int8)
    packed[0] = np.int8(-120)                      # 0x88: every nibble -8
    packed[1] = 0x77                               # every nibble 7
    q = rng.integers(-127, 128, (16, d)).astype(np.int8)
    q[0] = 127
    q[1] = -127
    panel = query_panel(q.astype(np.int64), d)
    acc = a_fragments(packed) @ panel.T
    want = topk._dot_packed(torch.from_numpy(packed), torch.from_numpy(q))
    assert np.array_equal(acc, 16 * want.numpy().astype(np.int64))
    # the columns no feature fills: past D/2 in the last box
    filled = np.zeros(panel.shape[1], bool)
    ones = query_panel(np.ones((1, d), np.int64), d)[0]
    filled[ones != 0] = True
    assert filled.sum() == d
    assert not panel[:, ~filled].any()


def _int4_case(case, rows, b, d, seed):
    """Packed int4 rows and scales of seeded unit rows (``tied``: a quarter
    of the rows repeat earlier ones; zero rows, scale 0), and quantized
    unit queries — the port's quantization."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((rows, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    if case == "tied":
        emb[1::4] = emb[0::4]
    emb[200:210] = 0
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    packed, scales = quantize_rows_int4(torch.from_numpy(emb))
    q_codes, qscale = quantize_rows(torch.from_numpy(q))
    return packed, scales, q_codes, qscale


def _check_int4(case, valid, *, rows, b, d, n, seed, **scan):
    packed, scales, q_codes, qscale = _int4_case(case, rows, b, d, seed)
    want = topk.cand_scan_int4_prefix_ref(packed, scales, q_codes, qscale,
                                          valid, **scan)
    got = emulate_int4(packed.numpy(), scales.numpy(), q_codes.numpy(),
                       qscale.numpy(), valid, n=n, **scan)
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())


INT4_CASES = {"random": 4096, "tied": 4096, "all_dead": 0,
              "mid_bucket_valid": 1500}


@pytest.mark.parametrize("case", list(INT4_CASES))
@pytest.mark.parametrize("rounds", [1, 2, 4])
@pytest.mark.parametrize("n,b", [(16, 1), (64, 64), (64, 37)])
def test_int4_fold_matches_plain_scan(case, rounds, n, b):
    """B7 as the tile folds it at D = 512, bit-identical to its plain
    version."""
    _check_int4(case, INT4_CASES[case], rows=4096, b=b, d=512, n=n,
                seed=rounds * 100 + b, bucket=1024, rounds=rounds,
                block_rows=2048)


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("n,b", [(16, 1), (64, 37)])
def test_int4_fold_other_widths(d, n, b):
    """D = 128 (half a box) and 384 (the second box's far half zeros)."""
    _check_int4("tied", 2500, rows=4096, b=b, d=d, n=n, seed=d + b,
                bucket=1024, rounds=2, block_rows=2048)


@pytest.mark.parametrize("valid", [0, 100, 1024, 1100])
def test_int4_fold_small_buckets(valid):
    """128-row buckets (two tiles), a mid-tile and an edge ``valid``."""
    _check_int4("random", valid, rows=1024, b=5, d=128, n=16, seed=valid,
                bucket=128, rounds=2, block_rows=512)


def test_int4_fold_matches_jax_kernel(monkeypatch):
    """The emulated tile's winners, merged in the row-orient order, equal
    JAX's ``_pallas_cand_scan_int4_prefix`` in interpret mode (which
    quantizes the f32 queries itself; the port's quantizer gives the same
    codes and scales)."""
    import jax.numpy as jnp

    from video_quierer_tpu.ops import topk as jax_topk

    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    rows, d, b, fetch, valid = 4 * 4096, 128, 6, 128, 2 * 4096 + 1500
    rng = np.random.default_rng(13)
    emb = rng.standard_normal((rows, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    emb[3000:3200] = emb[100:300]
    emb[9000:9010] = 0
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    perm = rng.permutation(rows).astype(np.int32)
    packed, scales = quantize_rows_int4(torch.from_numpy(emb))
    q_codes, qscale = quantize_rows(torch.from_numpy(q))
    jv, ji = jax_topk._pallas_cand_scan_int4_prefix(
        jnp.asarray(packed.numpy()), jnp.asarray(scales.numpy()),
        jnp.asarray(perm), jnp.asarray(q), jnp.int32(valid), fetch=fetch,
        rounds=2, bucket=128, native=True, orient="row", select="packb",
        interpret=True)
    bv, bi = emulate_int4(packed.numpy(), scales.numpy(), q_codes.numpy(),
                          qscale.numpy(), valid, n=16, bucket=128, rounds=2,
                          block_rows=topk.CAND_BLOCK_ROWS)
    tv, ti = topk._cand_merge(torch.from_numpy(bv), torch.from_numpy(bi),
                              torch.from_numpy(perm), fetch=fetch)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
