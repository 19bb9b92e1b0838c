"""Port index (video_quierer_tpu_torch/index/device_index.py, bf16 mirror,
CPU device) vs the JAX package's ``DeviceVideoIndex`` on the same rows:
the live-prefix permutation, the pickle v1.0 cache in both directions,
search results (same row ids in the same order, scores within 1e-5),
and the device re-rank against the host re-rank, ties included.
"""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_quierer_tpu.index.device_index import \
    DeviceVideoIndex as JaxIndex
from video_quierer_tpu_torch.index.device_index import (
    DeviceVideoIndex,
    _device_exact_rerank,
)

D = 64


def _rows(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _fill(idx, corpus, sizes, names=("a.mp4", "b.mp4")):
    lo = 0
    for i, size in enumerate(sizes):
        idx.add_batch(corpus[lo:lo + size], names[i % len(names)],
                      [0.5 * t for t in range(size)])
        lo += size


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        key = [(r["video_name"], r["frame_id"], r["timestamp"]) for r in g]
        assert key == [(r["video_name"], r["frame_id"], r["timestamp"])
                       for r in w]
        np.testing.assert_allclose([r["score"] for r in g],
                                   [r["score"] for r in w], atol=1e-5)


@pytest.fixture
def pair(rng):
    corpus = _rows(rng, 9000)
    jax_idx = JaxIndex(dim=D, device_dtype="bfloat16")
    port = DeviceVideoIndex(dim=D, device_dtype="bfloat16", device="cpu")
    for idx in (jax_idx, port):
        _fill(idx, corpus, (5000, 4000))
    return corpus, jax_idx, port


def test_perm_identical_for_same_appends(rng):
    corpus = _rows(rng, 12000)
    jax_idx = JaxIndex(dim=D, device_dtype="bfloat16")
    port = DeviceVideoIndex(dim=D, device_dtype="bfloat16", device="cpu")
    lo = 0
    for size in (300, 7, 1000, 4096, 5000, 1597):   # grows past 8192
        for idx in (jax_idx, port):
            idx.add_batch(corpus[lo:lo + size], "v.mp4",
                          [float(t) for t in range(size)])
        lo += size
        jax_idx._sync_device()
        port._sync_device()
        np.testing.assert_array_equal(port._perm, jax_idx._perm)
        np.testing.assert_array_equal(port._perm_dev.numpy(), port._perm)
        want = corpus[port._perm[:lo]]
        got = port._device_emb[:lo].float().numpy()
        np.testing.assert_array_equal(
            got, torch.from_numpy(want).bfloat16().float().numpy())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pickle_cache_loads_across_packages(tmp_path, pair, writer):
    _, jax_idx, port = pair
    for idx in (jax_idx, port):
        idx.video_hashes["a.mp4"] = "0123"
    path = tmp_path / "video_search_cache.pkl"
    src, dst = ((port, JaxIndex(dim=D, device_dtype="bfloat16"))
                if writer == "port" else
                (jax_idx, DeviceVideoIndex(dim=D, device_dtype="bfloat16",
                                       device="cpu")))
    src.save_to_disk(path)
    assert path.with_name(path.name + ".sha256").exists()
    assert dst.load_from_disk(path)
    assert len(dst) == len(src) == 9000
    assert dst.video_hashes == {"a.mp4": "0123"}
    np.testing.assert_array_equal(dst._emb[:9000], src._emb[:9000])
    a, b = dst.to_cache_dict(), src.to_cache_dict()
    assert a["metadata"] == b["metadata"] and a["version"] == "1.0"
    assert pickle.loads(path.read_bytes())["version"] == "1.0"


def test_search_batch_matches_jax(pair, rng):
    corpus, jax_idx, port = pair
    q = corpus[[3, 4500, 8999]] + 0.05 * rng.standard_normal(
        (3, D)).astype(np.float32)
    _same_rows(port.search_batch(q, k=10), jax_idx.search_batch(q, k=10))


def test_search_batch_fused_async_matches_jax(pair, rng):
    """The fused path with a toy encoder (mean of a fixed token table)
    written once per framework; same candidates, same device re-rank."""
    _, jax_idx, port = pair
    table = _rows(rng, 50)
    ids = rng.integers(0, 50, size=(8, 5)).astype(np.int32)

    def jax_encode(params, ids_dev):
        return params[ids_dev].mean(axis=1)

    def torch_encode(params, ids_dev):
        return params[ids_dev].mean(dim=1)

    want = jax_idx.search_batch_fused_async(
        jax_encode, jnp.asarray(table), ids, k=10)()
    got = port.search_batch_fused_async(
        torch_encode, torch.from_numpy(table), ids, k=10)()
    assert port._device_rerank_active()
    _same_rows(got, want)


def test_device_rerank_matches_host_with_ties(rng):
    # values k/64: every dot product is exact, so duplicates tie exactly
    base = (rng.integers(-8, 9, (40, D)) / 64).astype(np.float32)
    corpus = np.concatenate([base, base[:10], base[5:25]])
    idx = DeviceVideoIndex(dim=D, device_dtype="bfloat16", device="cpu")
    idx.add_batch(corpus, "a.mp4", [float(t) for t in range(len(corpus))])
    q = (rng.integers(-8, 9, (4, D)) / 64).astype(np.float32)
    cand = np.stack([rng.permutation(len(corpus))[:48] for _ in range(4)])
    cand[:, -3:] = [2**31 - 1, 5, len(corpus) + 3]   # pad, dup, dead
    vals, rows = _device_exact_rerank(
        torch.from_numpy(idx._emb), torch.from_numpy(q),
        torch.from_numpy(cand.astype(np.int32)), idx.count, 12)
    got = idx._rows_from(vals.numpy(), rows.numpy())
    want = idx._rerank_f32(q, cand, 12)
    for g, w in zip(got, want):
        assert [r["frame_id"] for r in g] == [r["frame_id"] for r in w]
        assert [r["score"] for r in g] == [r["score"] for r in w]
    scores = np.array([r["score"] for r in want[0]])
    assert (np.diff(scores) <= 0).all()


def test_remove_video_matches_jax(pair, rng):
    corpus, jax_idx, port = pair
    q = corpus[[10, 6000]]
    for idx in (jax_idx, port):
        idx.search_batch(q, k=5)            # place the mirrors
        assert idx.remove_video("a.mp4") == 5000
        assert idx.video_names() == ["b.mp4"]
    _same_rows(port.search_batch(q, k=5), jax_idx.search_batch(q, k=5))
