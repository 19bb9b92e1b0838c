"""B12's plan and chunk merge (``video_quierer_tpu_torch/index/ivf.py``:
``probe_plan_ref``, ``probe_scan_items_ref``), on the CPU.

The kernel scores work items — up to ``PROBE_GROUP`` pairs of one tile
times one chunk of its rows — and merges each pair's chunk lists. Its
plain counterpart builds the same items and emulates the scan over them;
here the emulation is held against the plain version ``probe_scan_ref``
and against the JAX package's Pallas kernel ``_pallas_probe_scan`` in
interpret mode: bit for bit on inputs whose products are exact in f32
(multiples of 1/256), and on unit rows with scores within rtol 1e-5 and
rows identical except where two scores tie within 1e-5 (against the
Pallas kernel, whose sums run in another order, also within atol 1e-6,
as ``tests/test_torch_ivf.py`` allows). Every item
covers each live row of each live pair exactly once, whatever the chunk
count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import unit_rows
from video_quierer_tpu.index import ivf as jax_ivf
from video_quierer_tpu_torch.index import ivf
from video_quierer_tpu_torch.index.ivf import BLOCK_ROWS, PROBE_GROUP

D = 64
B = 24
CHUNKS = [1, 2, 4, 8, 16]


def _case(exact: bool, seed: int = 3):
    """Eight tiles: full; 700 live rows; 5 live rows (fewer than k); live
    ids in descending order; every row twice (rows 512-1023 repeat rows
    0-511, so equal scores straddle every chunk boundary at two chunks);
    all padding; full, probed by all ``B`` queries (more than a group);
    live rows 0-39 only (a chunk of 64 rows holds them all). Pairs: every
    query with the wide tile, each with three random tiles, duplicates,
    pairs on the padding tile, and pairs whose query (``B``, -1) or tile
    (-1) is out of range; shuffled."""
    rng = np.random.default_rng(seed)
    t = 8
    if exact:
        tiles = (rng.integers(-64, 65, (t, BLOCK_ROWS, D)) / 256).astype(
            np.float32)
        queries = (rng.integers(-64, 65, (B, D)) / 256).astype(np.float32)
    else:
        tiles = unit_rows(rng, t * BLOCK_ROWS, D).reshape(t, BLOCK_ROWS, D)
        queries = unit_rows(rng, B, D)
    ids = rng.permutation(t * BLOCK_ROWS).astype(np.int32).reshape(
        t, BLOCK_ROWS)
    ids[1, 700:] = -1
    ids[2, 5:] = -1
    ids[3] = np.sort(ids[3])[::-1]
    tiles[4, 512:] = tiles[4, :512]
    ids[5] = -1
    tiles[5] = 0
    ids[7, 40:] = -1
    pairs = [(6, q) for q in range(B)]
    pairs += [(int(x), q) for q in range(B)
              for x in rng.choice([0, 1, 2, 3, 4, 7], 3, replace=False)]
    pairs += pairs[:5] + pairs[30:33]                  # duplicates
    pairs += [(5, q) for q in range(0, B, 3)]          # the padding tile
    pairs += [(0, B), (3, -1), (-1, 2), (4, B + 7)]    # out of range
    pairs = rng.permutation(np.array(pairs, np.int32))
    return (torch.from_numpy(tiles), torch.from_numpy(ids),
            torch.from_numpy(np.ascontiguousarray(pairs[:, 0])),
            torch.from_numpy(np.ascontiguousarray(pairs[:, 1])),
            torch.from_numpy(queries))


def _valid(tl, qi):
    return (tl >= 0) & (qi >= 0) & (qi < B)


def _check(got, want, exact, atol=0.0):
    """Pads in the same places; exact: identical; else scores within rtol
    1e-5 (plus ``atol``) and rows identical except among scores tied
    within that."""
    (gv, gi), (wv, wi) = got, want
    pad = ~torch.isfinite(wv)
    assert torch.equal(~torch.isfinite(gv), pad)
    assert (gi[pad] == -1).all() and (wi[pad] == -1).all()
    if exact:
        assert torch.equal(gv, wv) and torch.equal(gi, wi)
        return
    torch.testing.assert_close(gv[~pad], wv[~pad], rtol=1e-5, atol=atol)
    gap = torch.full_like(wv, float("inf"))
    gap[:, 1:] = wv[:, :-1] - wv[:, 1:]
    gap[:, :-1] = torch.minimum(gap[:, :-1], wv[:, :-1] - wv[:, 1:])
    apart = (gap > 1e-5 * wv.abs() + atol) & ~pad
    assert torch.equal(gi[apart], wi[apart])


def _items(groups, chunks):
    """Every (pair, row) an item covers: each group times each chunk, the
    chunk's rows."""
    rows = BLOCK_ROWS // chunks
    for tile, n, *pairs in groups.tolist():
        for c in range(chunks):
            for p in pairs[:n]:
                yield from ((p, tile, r)
                            for r in range(c * rows, (c + 1) * rows))


@pytest.mark.parametrize("n_pairs,chunks", [
    (0, 16), (1, 16), (32, 16), (512, 16), (513, 8), (1024, 8), (1025, 4),
    (2048, 4), (2049, 2), (8192, 2), (65536, 2)])
def test_probe_chunks(n_pairs, chunks):
    assert ivf.probe_chunks(n_pairs) == chunks
    assert BLOCK_ROWS // chunks % 64 == 0


@pytest.mark.parametrize("group", [1, PROBE_GROUP])
@pytest.mark.parametrize("window", [ivf.PROBE_WINDOW, 16])
@pytest.mark.parametrize("chunks", CHUNKS)
def test_items_cover_each_live_row_once(monkeypatch, chunks, window, group):
    monkeypatch.setattr(ivf, "PROBE_WINDOW", window)
    monkeypatch.setattr(ivf, "PROBE_GROUP", group)
    _, ids, tl, qi, _ = _case(True)
    groups, dead = ivf.probe_plan_ref(ids, tl, qi, B)
    # dead: out-of-range pairs and the padding tile's
    want_dead = ~_valid(tl, qi) | (tl == 5)
    assert torch.equal(dead, want_dead)
    covered = [(p, r) for p, t, r in _items(groups, chunks)
               if ids[t, r] >= 0]
    assert len(covered) == len(set(covered))
    want = {(p, r) for p in range(tl.shape[0]) if not dead[p]
            for r in range(BLOCK_ROWS) if ids[tl[p], r] >= 0}
    assert set(covered) == want
    # each group: one tile, 1..PROBE_GROUP distinct pairs on it, in pair
    # order within the window's stable sort by tile
    order = []
    assert groups.shape[1] == 2 + group
    for tile, n, *pairs in groups.tolist():
        assert 1 <= n <= group
        assert all(p == -1 for p in pairs[n:])
        assert all(int(tl[p]) == tile for p in pairs[:n])
        order += pairs[:n]
    want_order = []
    for lo in range(0, tl.shape[0], window):
        live = [p for p in range(lo, min(tl.shape[0], lo + window))
                if not dead[p]]
        want_order += sorted(live, key=lambda p: int(tl[p]))
    assert order == want_order


def test_tile_with_more_pairs_than_a_group():
    _, ids, tl, qi, _ = _case(True)
    groups, _ = ivf.probe_plan_ref(ids, tl, qi, B)
    wide = groups[groups[:, 0] == 6]
    # every query once, five of them twice: 29 pairs in 4 groups
    assert int((tl == 6).sum()) == B + 5
    assert wide[:, 1].tolist() == [8, 8, 8, 5]


def test_plan_of_no_pairs():
    _, ids, _, _, q = _case(True)
    none = torch.zeros(0, dtype=torch.int32)
    groups, dead = ivf.probe_plan_ref(ids, none, none, B)
    assert groups.shape == (0, 2 + PROBE_GROUP) and dead.shape == (0,)
    v, i = ivf.probe_scan_items_ref(torch.zeros(2, BLOCK_ROWS, D), ids[:2],
                                    none, none, q, k=10)
    assert v.shape == i.shape == (0, 10)


@pytest.mark.parametrize("group", [1, PROBE_GROUP])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("chunks", CHUNKS)
def test_items_match_plain_version(monkeypatch, exact, k, chunks, group):
    monkeypatch.setattr(ivf, "PROBE_GROUP", group)
    tiles, ids, tl, qi, q = _case(exact)
    got = ivf.probe_scan_items_ref(tiles, ids, tl, qi, q, k=k,
                                   chunks=chunks)
    assert got[0].shape == got[1].shape == (tl.shape[0], k)
    assert got[1].dtype == torch.int32
    ok = _valid(tl, qi)
    # pairs outside the tiles or queries: pads only
    assert (~torch.isfinite(got[0][~ok])).all() and (got[1][~ok] == -1).all()
    want = ivf.probe_scan_ref(tiles, ids, tl[ok], qi[ok], q, k=k)
    _check((got[0][ok], got[1][ok]), want, exact)
    if k > 5:       # the 5-live-row tile pads from slot 5 on
        assert (got[1][tl == 2][:, 5:] == -1).all()
    assert (got[1][tl == 5] == -1).all()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("chunks", [2, 16])
def test_items_match_pallas_kernel(exact, k, chunks):
    tiles, ids, tl, qi, q = _case(exact)
    ok = _valid(tl, qi)
    tl, qi = tl[ok].contiguous(), qi[ok].contiguous()
    got = ivf.probe_scan_items_ref(tiles, ids, tl, qi, q, k=k,
                                   chunks=chunks)
    v, i = jax_ivf._pallas_probe_scan(
        jnp.asarray(tiles.numpy()), jnp.asarray(ids.numpy()[:, :, None]),
        jnp.asarray(tl.numpy()), jnp.asarray(qi.numpy()),
        jnp.asarray(q.numpy().T), k=k, total=tl.shape[0], interpret=True)
    want = (torch.from_numpy(np.asarray(v)[:, 0]),
            torch.from_numpy(np.asarray(i)[:, 0]))
    # XLA sums the products in another order: scores near 0 (the 64th
    # entry of a tile with few live rows) differ by ~1e-8, as
    # tests/test_torch_ivf.py allows
    _check(got, want, exact, atol=1e-6)


@pytest.mark.parametrize("k", [1, 10])
def test_items_match_plain_version_over_windows(monkeypatch, k):
    """Windows of 16 pairs: a tile's pairs in several windows make several
    groups; the results do not depend on it."""
    monkeypatch.setattr(ivf, "PROBE_WINDOW", 16)
    tiles, ids, tl, qi, q = _case(False)
    ok = _valid(tl, qi)
    tl, qi = tl[ok].contiguous(), qi[ok].contiguous()
    groups, _ = ivf.probe_plan_ref(ids, tl, qi, B)
    assert (groups[:, 0] == 6).sum() > 3
    got = ivf.probe_scan_items_ref(tiles, ids, tl, qi, q, k=k, chunks=4)
    _check(got, ivf.probe_scan_ref(tiles, ids, tl, qi, q, k=k), False)


def test_duplicate_pairs_get_the_same_lists():
    tiles, ids, tl, qi, q = _case(False)
    v, i = ivf.probe_scan_items_ref(tiles, ids, tl, qi, q, k=10, chunks=8)
    seen = {}
    for p, key in enumerate(zip(tl.tolist(), qi.tolist())):
        if key in seen:
            assert torch.equal(v[p], v[seen[key]])
            assert torch.equal(i[p], i[seen[key]])
        seen.setdefault(key, p)
    assert len(seen) < tl.shape[0]
