"""The port's IVF tier (``video_quierer_tpu_torch/index/ivf.py``) vs the JAX
package's (``video_quierer_tpu/index/ivf.py``), on the CPU.

- the probe scan: the plain version of kernel B12 (``probe_scan_ref``, what
  ``probe_scan`` runs on CPU tensors) against the Pallas kernel
  ``_pallas_probe_scan`` in interpret mode, pair by pair: full tiles, tiles
  with fewer than k live rows, the padding tile, exact ties (inputs whose
  products are exact in f32, so both break them by global id);
- the build: ``_kmeans`` from the reference's seed rows (assignments
  identical, centroid cosine >= 1 - 1e-5), ``_rebalance`` and the packing
  (row ids, tile ranges identical);
- search through the reference's built state (``IVFIndex.load_built``):
  rows identical to the reference's Pallas search (interpret mode, the
  path the JAX package serves on its chip), scores within 1e-5, and the
  same candidate sets as its XLA path; full probe equals the exact scan;
  the fresh buffer, ``needs_rebuild``, ``rebuild`` and ``stats()``;
- the errors.

The port draws its k-means seed rows from a ``torch.Generator``; where a
test holds a port build against a JAX build, it hands the port the JAX
seed rows (``tests/torch_parity.py:jax_kmeans_init``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import ivf_state, jax_kmeans_init, unit_rows
from video_quierer_tpu.index import ivf as jax_ivf
from video_quierer_tpu.ops.topk import cosine_topk as jax_cosine_topk
from video_quierer_tpu_torch.index import ivf as port_ivf
from video_quierer_tpu_torch.index.ivf import BLOCK_ROWS, IVFIndex
from video_quierer_tpu_torch.ops.topk import cosine_topk
from video_quierer_tpu_torch.parallel.mesh import corpus_mesh

D = 64


def _clustered(rng, sizes, d=D, spread=0.05):
    """Rows around ``len(sizes)`` random unit centres, ``sizes[c]`` each."""
    centres = unit_rows(rng, len(sizes), d)
    rows = [centres[c] + spread * rng.standard_normal((n, d)).astype(
        np.float32) for c, n in enumerate(sizes)]
    emb = np.concatenate(rows)
    return emb / np.linalg.norm(emb, axis=-1, keepdims=True)


@pytest.fixture
def jax_seeds(monkeypatch):
    """Port builds start from the reference's k-means seed rows."""
    monkeypatch.setattr(port_ivf, "init_indices", jax_kmeans_init)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX index searches through its Pallas kernel (interpret mode)."""
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")


def _assert_same_rows(got_v, got_i, want_v, want_i, tol=1e-6):
    """Scores within 1e-5; rows identical except among scores tied within
    ``tol`` (the two frameworks sum the products in other orders), pads
    in the same places."""
    live = np.isfinite(want_v)
    assert np.array_equal(np.isfinite(got_v), live)
    assert np.array_equal(got_i[~live], want_i[~live])
    np.testing.assert_allclose(got_v[live], want_v[live], atol=1e-5)
    with np.errstate(invalid="ignore"):
        step = want_v[:, :-1] - want_v[:, 1:]
        gap = np.full_like(want_v, np.inf)
        gap[:, 1:] = step
        gap[:, :-1] = np.minimum(gap[:, :-1], step)
        apart = live & ~(gap <= tol)
    np.testing.assert_array_equal(got_i[apart], want_i[apart])


def _built_pair(rng, sizes=(150,) * 8, nlist=8, nprobe=3):
    emb = _clustered(rng, sizes)
    jax_index = jax_ivf.IVFIndex(nlist=nlist, nprobe=nprobe, seed=0)
    jax_index.build(emb)
    port = IVFIndex.load_built(**ivf_state(jax_index), device="cpu")
    return emb, jax_index, port


# -- the probe scan: plain version vs the Pallas kernel -------------------

def _probe_case(exact: bool):
    """Five tiles and the padding tile: full, 700 live rows, 5 live rows
    (fewer than k), live ids in descending order, duplicated rows (equal
    scores), all padding; pairs over every tile and three queries."""
    rng = np.random.default_rng(7)
    t = 6
    if exact:       # multiples of 1/256: every product sum exact in f32
        tiles = (rng.integers(-64, 65, (t, BLOCK_ROWS, D)) / 256).astype(
            np.float32)
        queries = (rng.integers(-64, 65, (3, D)) / 256).astype(np.float32)
    else:
        tiles = unit_rows(rng, t * BLOCK_ROWS, D).reshape(t, BLOCK_ROWS, D)
        queries = unit_rows(rng, 3, D)
    ids = rng.permutation(t * BLOCK_ROWS).astype(np.int32).reshape(
        t, BLOCK_ROWS)
    ids[1, 700:] = -1
    ids[2, 5:] = -1
    ids[3] = np.sort(ids[3])[::-1]
    tiles[4, 512:] = tiles[4, :512]            # every score twice
    ids[5] = -1
    tiles[5] = 0
    tile_list = np.array([0, 1, 2, 3, 4, 5, 5, 4, 3, 2, 1, 0, 2, 5, 4],
                         np.int32)
    qidx = np.array([0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2], np.int32)
    return tiles, ids, tile_list, qidx, queries


def _jax_probe(tiles, ids, tile_list, qidx, queries, k):
    v, i = jax_ivf._pallas_probe_scan(
        jnp.asarray(tiles), jnp.asarray(ids[:, :, None]),
        jnp.asarray(tile_list), jnp.asarray(qidx), jnp.asarray(queries.T),
        k=k, total=tile_list.shape[0], interpret=True)
    return np.asarray(v)[:, 0], np.asarray(i)[:, 0]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_probe_scan_ref_matches_pallas_kernel(exact, k):
    tiles, ids, tile_list, qidx, queries = _probe_case(exact)
    want_v, want_i = _jax_probe(tiles, ids, tile_list, qidx, queries, k)
    before = port_ivf.probe_scan.launches
    got_v, got_i = port_ivf.probe_scan(
        *(torch.from_numpy(x) for x in (tiles, ids, tile_list, qidx,
                                        queries)), k=k)
    assert port_ivf.probe_scan.launches == before   # CPU: the plain version
    got_v, got_i = got_v.numpy(), got_i.numpy()
    assert got_v.shape == got_i.shape == (tile_list.shape[0], k)
    assert got_i.dtype == np.int32
    # pads (-inf, -1) in the same places: the padding tile's pairs, and
    # the 5-live-row tile's pairs beyond 5
    pad = ~np.isfinite(want_v)
    assert np.array_equal(~np.isfinite(got_v), pad)
    assert (got_i[pad] == -1).all() and (want_i[pad] == -1).all()
    assert pad[tile_list == 5].all()
    if k > 5:
        assert pad[tile_list == 2][:, 5:].all()
    if exact:
        np.testing.assert_array_equal(got_v, want_v)
        np.testing.assert_array_equal(got_i, want_i)
    else:
        np.testing.assert_allclose(got_v[~pad], want_v[~pad], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got_i, want_i)


# -- the build ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_matches_jax(seed):
    rng = np.random.default_rng(seed)
    emb = _clustered(rng, (100,) * 8)
    c_want, a_want = jax_ivf._kmeans(jnp.asarray(emb), jnp.int32(seed),
                                     n_clusters=8, iters=10)
    c_got, a_got = port_ivf._kmeans(
        torch.from_numpy(emb),
        torch.from_numpy(jax_kmeans_init(emb.shape[0], 8, seed)), iters=10)
    np.testing.assert_array_equal(a_got.numpy(), np.asarray(a_want))
    cos = np.sum(c_got.numpy() * np.asarray(c_want), axis=-1)
    assert cos.min() >= 1 - 1e-5


def test_rebalance_matches_jax():
    rng = np.random.default_rng(5)
    emb = unit_rows(rng, 2000, D)
    centroids = unit_rows(rng, 16, D)
    assign = rng.choice(16, size=2000, p=np.r_[[0.4], np.full(15, 0.04)])
    got = port_ivf._rebalance(emb, centroids, assign, cap=250)
    want = jax_ivf._rebalance(emb, centroids, assign, cap=250)
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got, minlength=16).max() == 250


@pytest.mark.parametrize("sizes,balance", [
    ((150,) * 8, 2.0),                                  # balanced
    ((900, 300, 60, 60, 60, 60, 30, 30), 2.0),           # rebalance evicts
    ((900, 300, 60, 60, 60, 60, 30, 30), 0.0),           # balancing off
    ((1500, 40, 40, 40, 40, 40, 40, 40), 2.0),           # a two-tile cluster
])
def test_build_matches_jax(jax_seeds, sizes, balance):
    rng = np.random.default_rng(sum(sizes))
    emb = _clustered(rng, sizes)
    want = jax_ivf.IVFIndex(nlist=8, nprobe=3, seed=0,
                            balance_factor=balance)
    want.build(emb)
    got = IVFIndex(nlist=8, nprobe=3, seed=0, balance_factor=balance,
                   device="cpu")
    got.build(emb)
    np.testing.assert_array_equal(got._row_ids, np.asarray(want._row_ids))
    np.testing.assert_array_equal(got._tile_start_np, want._tile_start_np)
    np.testing.assert_array_equal(got._tile_counts_np, want._tile_counts_np)
    assert (got._pad_tile, got._max_tiles, got._median_tiles) == \
        (want._pad_tile, want._max_tiles, want._median_tiles)
    np.testing.assert_array_equal(got._tiled.numpy(), np.asarray(want._tiled))
    cos = np.sum(got._centroids_np * want._centroids_np, axis=-1)
    assert cos.min() >= 1 - 1e-5
    split = got.last_build
    assert set(split) == {"upload", "kmeans", "rebalance", "pack", "evicted"}
    assert (split["evicted"] > 0) == (balance > 0 and max(sizes) > 2 * (
        sum(sizes) / 8))


def test_auto_nlist_matches_jax(jax_seeds):
    rng = np.random.default_rng(9)
    emb = unit_rows(rng, 3000, D)
    want = jax_ivf.IVFIndex(nprobe=4)
    want.build(emb)
    got = IVFIndex(nprobe=4, device="cpu")
    got.build(emb)
    assert got.nlist == want.nlist == 32
    np.testing.assert_array_equal(got._row_ids, np.asarray(want._row_ids))


# -- search -------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("k", [1, 5, 10, 64])
def test_search_matches_jax_pallas(interpret, b, k):
    rng = np.random.default_rng(100 * b + k)
    emb, jax_index, port = _built_pair(rng)
    q = emb[rng.integers(0, emb.shape[0], b)] + 0.05 * unit_rows(rng, b, D)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    want_v, want_i = jax_index.search(q, k=k)
    got_v, got_i = port.search(q, k=k)
    assert got_v.shape == got_i.shape == (b, k) and got_i.dtype == np.int64
    _assert_same_rows(got_v, got_i, want_v, want_i)


@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_search_matches_jax_xla_as_sets(nprobe):
    rng = np.random.default_rng(nprobe)
    emb, jax_index, port = _built_pair(rng, nprobe=nprobe)
    q = unit_rows(rng, 6, D)
    want_v, want_i = jax_index.search(q, k=10)
    got_v, got_i = port.search(q, k=10)
    for b in range(q.shape[0]):
        assert set(got_i[b][got_i[b] >= 0]) == set(want_i[b][want_i[b] >= 0])
        np.testing.assert_allclose(np.sort(got_v[b][got_i[b] >= 0]),
                                   np.sort(want_v[b][want_i[b] >= 0]),
                                   atol=1e-5)


def test_single_query_shape_and_nprobe_override(interpret):
    rng = np.random.default_rng(12)
    emb, jax_index, port = _built_pair(rng)
    v, i = port.search(emb[5], k=3)
    assert v.shape == (3,) and i.shape == (3,) and i[0] == 5
    for nprobe in (1, 2, 8):
        want = jax_index.search(emb[:4], k=10, nprobe=nprobe)[1]
        np.testing.assert_array_equal(port.search(emb[:4], k=10,
                                                  nprobe=nprobe)[1], want)


def test_full_probe_is_exact(jax_seeds):
    rng = np.random.default_rng(13)
    emb = unit_rows(rng, 1500, D)
    ivf = IVFIndex(nlist=16, nprobe=16, seed=0, device="cpu")
    ivf.build(emb)
    q = unit_rows(rng, 4, D)
    vals, idxs = ivf.search(q, k=10)
    ev, ei = cosine_topk(torch.from_numpy(emb), torch.from_numpy(q), 1500,
                         k=10)
    np.testing.assert_array_equal(idxs, ei.numpy())
    np.testing.assert_allclose(vals, ev.numpy(), atol=1e-5)
    jv, ji = jax_cosine_topk(jnp.asarray(emb), jnp.asarray(q), 1500, k=10)
    np.testing.assert_array_equal(idxs, np.asarray(ji))


def test_clustered_recall(jax_seeds):
    """The reference's recall bar (tests/test_ivf.py): recall@10 > 0.8
    with 4 of 16 clusters probed."""
    rng = np.random.default_rng(14)
    emb = _clustered(rng, (200,) * 16, d=512, spread=0.15)
    ivf = IVFIndex(nlist=16, nprobe=4, seed=0, device="cpu")
    ivf.build(emb)
    q = emb[::150][:20] + 0.02 * unit_rows(rng, 20, 512)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    _, exact = cosine_topk(torch.from_numpy(emb), torch.from_numpy(q),
                           emb.shape[0], k=10)
    vals, idxs = ivf.search(q, k=10)
    hits = sum(len(set(exact[b].tolist()) & set(idxs[b].tolist()))
               for b in range(20))
    assert hits / 200 > 0.8
    live = idxs >= 0
    np.testing.assert_allclose(vals[live], np.einsum(
        "bkd,bd->bk", emb[idxs.clip(0)], q)[live], atol=1e-5)


def test_fresh_buffer_and_rebuild_match_jax(jax_seeds, interpret):
    rng = np.random.default_rng(15)
    emb, jax_index, port = _built_pair(rng)
    fresh = unit_rows(rng, 50, D)
    for index in (jax_index, port):
        index.add(fresh)
    q = np.concatenate([fresh[[7, 30]], emb[[3]]])
    want_v, want_i = jax_index.search(q, k=4)
    got_v, got_i = port.search(q, k=4)
    _assert_same_rows(got_v, got_i, want_v, want_i)
    assert got_i[0, 0] == 1200 + 7 and got_i[1, 0] == 1200 + 30
    assert not port.needs_rebuild and not jax_index.needs_rebuild
    more = unit_rows(rng, 260, D)
    for index in (jax_index, port):
        index.add(more)
    assert port.stats() == jax_index.stats()
    assert port.needs_rebuild and jax_index.needs_rebuild
    np.testing.assert_array_equal(port._reconstruct_corpus(),
                                  jax_index._reconstruct_corpus())
    for index in (jax_index, port):
        index.rebuild()
    assert port._fresh is None and port.stats() == jax_index.stats()
    np.testing.assert_array_equal(port._row_ids,
                                  np.asarray(jax_index._row_ids))
    # the formerly fresh rows keep their global ids
    assert port.search(fresh[7], k=1)[1][0] == 1200 + 7


def test_add_copies_its_input():
    rng = np.random.default_rng(16)
    emb, _, port = _built_pair(rng)
    fresh = unit_rows(rng, 8, D)
    port.add(fresh)
    probe = fresh[3].copy()
    fresh[:] = 0.0
    vals, idxs = port.search(probe, k=1)
    assert idxs[0] == 1200 + 3
    np.testing.assert_allclose(vals[0], 1.0, rtol=1e-5)


def test_stats_match_jax(jax_seeds):
    rng = np.random.default_rng(17)
    emb = unit_rows(rng, 1200, D)
    want = jax_ivf.IVFIndex(nlist=8, nprobe=3, seed=0)
    got = IVFIndex(nlist=8, nprobe=3, seed=0, device="cpu")
    assert got.stats() == want.stats() == {"built": False}
    for index in (want, got):
        index.build(emb)
    assert got.stats() == want.stats()
    for index in (want, got):
        index.add(unit_rows(rng, 50, D))
    assert got.stats() == want.stats() and got.stats()["fresh_rows"] == 50


def test_errors():
    with pytest.raises(RuntimeError, match="build"):
        IVFIndex(device="cpu").search(np.zeros(D, np.float32))
    with pytest.raises(RuntimeError, match="build"):
        IVFIndex(device="cpu").add(np.zeros((2, D), np.float32))
    _, _, port = _built_pair(np.random.default_rng(18))
    with pytest.raises(ValueError):
        port.search(np.zeros(D, np.float32), k=65)
    with pytest.raises(RuntimeError, match="build"):
        IVFIndex(mesh=corpus_mesh(2, devices=["cpu"] * 2)).search(
            np.zeros(D, np.float32))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert IVFIndex().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            IVFIndex()
