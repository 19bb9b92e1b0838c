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
"""

import numpy as np
import pytest
import torch

from video_quierer_tpu_torch.ops import topk
from video_quierer_tpu_torch.ops.quantize import quantize_rows

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
