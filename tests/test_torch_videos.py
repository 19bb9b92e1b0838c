"""The port's video-level search and the index accessors against the JAX
package's ``DeviceVideoIndex``, on the same seeded rows (D = 64):

- ``search_videos`` on the device path (``video_rank_device``: the f32
  tier's mirror, and the bf16 tier's f32 re-rank store) and on the host
  path (int8 with the device re-rank off, a bf16 re-rank store, a 2-shard
  corpus mesh), in each of these states: fresh, after ``remove_video``,
  after ``clear``, after ``load_cache_dict``, after a streamed ingest
  (``add_batch_device``) that follows a ranking, with k above the number
  of videos, and empty. The same videos in the same order with the same
  ``frame_count`` and ``best_timestamp``, scores within 1e-5; two videos
  with the same rows tie, and the lower video id ranks first; a video's
  duplicate best rows resolve to its lowest row;
- which path a tier takes (the device ranking's call counter);
- the load path's per-video f64 sums: ``np.add.at``'s and JAX's, bit for
  bit;
- the accessors (``video_frame_counts``, ``nearest_frame``,
  ``frame_embedding``, ``frame_info``, ``add_frame``, ``search``) and
  ``save_native``/``load_native`` in both directions between the
  packages.
"""

import numpy as np
import pytest
import torch

import jax

from video_quierer_tpu.index.device_index import \
    DeviceVideoIndex as JaxIndex
from video_quierer_tpu.parallel import mesh as jax_mesh
from video_quierer_tpu_torch.index import device_index as port_index
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.parallel import mesh as port_mesh

D = 64
N_VIDEOS = 9
FRAMES = 40
SCORE_ATOL = 1e-5
# (tier, index keyword arguments, mesh shards, device path)
PATHS = {
    "float32": ("float32", {}, 0, True),
    "bf16_f32_store": ("bfloat16", {}, 0, True),
    "int8_rerank_off": ("int8", {"device_rerank": "off"}, 0, False),
    "bf16_bf16_store": ("bfloat16", {"rerank_store_dtype": "bfloat16"}, 0,
                        False),
    "mesh_bf16": ("bfloat16", {}, 2, False),
}


def _video_rows(rng, v):
    """A video: a unit centre plus noise, with video 3 a copy of video 2
    (a tie of whole videos) and frame 7 of each a copy of frame 5 (a tie
    of best frames when the query is that frame)."""
    centre = rng.standard_normal(D).astype(np.float32)
    rows = centre + 0.6 * rng.standard_normal((FRAMES, D)).astype(np.float32)
    rows[7] = rows[5]
    return rows / np.linalg.norm(rows, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    videos = [_video_rows(rng, v) for v in range(N_VIDEOS)]
    videos[3] = videos[2].copy()
    return videos


def _stamps(v, n=FRAMES):
    return [0.5 * t + 0.01 * v for t in range(n)]


def _pair(path):
    tier, kw, shards, _ = PATHS[path]
    if shards:
        assert jax.device_count() >= shards
        return (JaxIndex(dim=D, device_dtype=tier,
                         mesh=jax_mesh.corpus_mesh(shards), **kw),
                DeviceVideoIndex(dim=D, device_dtype=tier,
                                 mesh=port_mesh.corpus_mesh(
                                     shards, devices=["cpu"] * shards),
                                 **kw))
    return (JaxIndex(dim=D, device_dtype=tier, **kw),
            DeviceVideoIndex(dim=D, device_dtype=tier, device="cpu", **kw))


def _fill(pair, corpus, videos=range(N_VIDEOS)):
    for v in videos:
        for idx in pair:
            idx.add_batch(corpus[v], f"video_{v}.mp4", _stamps(v))


def _queries(corpus):
    """Near video 1's centre, video 2's (tied with 3), a frame of video 5
    that has a duplicate (frame 5 == frame 7), and random."""
    rng = np.random.default_rng(3)
    return [corpus[1].mean(0), corpus[2].mean(0) + 0.01,
            corpus[5][5], rng.standard_normal(D).astype(np.float32)]


def _same(got, want):
    assert [(r["video_name"], r["frame_count"], r["best_timestamp"])
            for r in got] == [(r["video_name"], r["frame_count"],
                               r["best_timestamp"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=0,
                               atol=SCORE_ATOL)
    for r in got:
        assert set(r) == {"video_name", "score", "frame_count",
                          "best_timestamp"}


def _check(pair, corpus, k=5):
    jax_idx, port = pair
    for q in _queries(corpus):
        _same(port.search_videos(q, k), jax_idx.search_videos(q, k))


@pytest.mark.parametrize("path", list(PATHS))
def test_search_videos_states(path, corpus):
    """Every state of the module docstring on one path; the device
    ranking runs exactly on the device paths."""
    pair = _pair(path)
    jax_idx, port = pair
    before = port_index.video_rank_device.launches
    assert port.search_videos(corpus[0][0], 5) == []           # empty
    _fill(pair, corpus)
    _check(pair, corpus)
    _check(pair, corpus, k=N_VIDEOS + 7)                      # k > videos
    # the tie of videos 2 and 3: the lower id first, on both paths
    rows = port.search_videos(corpus[2].mean(0), 2)
    assert [r["video_name"] for r in rows] == ["video_2.mp4", "video_3.mp4"]
    assert rows[0]["score"] == rows[1]["score"]
    # the duplicate best frame: the lower row's timestamp
    assert port.search_videos(corpus[5][5], 1)[0]["best_timestamp"] == \
        _stamps(5)[5]
    for idx in pair:
        assert idx.remove_video("video_1.mp4") == FRAMES
    _check(pair, corpus, k=N_VIDEOS)
    payload = jax_idx.to_cache_dict()
    for idx in pair:
        idx.load_cache_dict(payload)
    _check(pair, corpus)
    # a streamed ingest after a ranking: the device state follows
    new = corpus[1] * np.float32(-1.0)
    jax_idx.add_batch(new, "video_new.mp4", _stamps(10))
    port.add_batch_device(torch.from_numpy(new), "video_new.mp4",
                          _stamps(10))
    _check(pair, corpus)
    q = -corpus[1].mean(0)
    assert port.search_videos(q, 1)[0]["video_name"] == "video_new.mp4"
    _same(port.search_videos(q, 3), jax_idx.search_videos(q, 3))
    for idx in pair:
        idx.clear()
    assert port.search_videos(q, 3) == jax_idx.search_videos(q, 3) == []
    _fill(pair, corpus, videos=[4, 0])
    _check(pair, corpus, k=4)
    ran = port_index.video_rank_device.launches - before
    device = PATHS[path][3]
    # the rankings of a non-empty index: 4 in each of the six _check
    # calls, then 4 single ones
    assert ran == (6 * 4 + 4 if device else 0)


def test_device_ranking_follows_every_append(corpus):
    """``_video_rev`` moves at every append path, so the device copy of the
    means and the id column is re-uploaded before the next ranking."""
    jax_idx, port = _pair("float32")
    _fill((jax_idx, port), corpus, videos=range(3))
    port.search_videos(corpus[0][0], 3)
    rev = port._dev_video_rev
    port.add_frame(corpus[8][0], "video_8.mp4", 1.5)
    jax_idx.add_frame(corpus[8][0], "video_8.mp4", 1.5)
    _same(port.search_videos(corpus[8][0], 4),
          jax_idx.search_videos(corpus[8][0], 4))
    assert port._dev_video_rev > rev
    assert port._dev_vid_ids.shape[0] == port._emb.shape[0]
    assert int(port._dev_vid_ids[len(port)]) == -1
    assert port._dev_means.shape[0] % 128 == 0


def test_accessors_match_jax(corpus):
    pair = _pair("bf16_f32_store")
    jax_idx, port = pair
    _fill(pair, corpus, videos=range(4))
    for idx in pair:
        idx.add_frame(corpus[6][0], "video_2.mp4", 99.0)
        idx.remove_video("video_1.mp4")
    assert port.video_frame_counts() == jax_idx.video_frame_counts() == {
        "video_0.mp4": FRAMES, "video_2.mp4": FRAMES + 1,
        "video_3.mp4": FRAMES}
    for name, t in (("video_2.mp4", 3.3), ("video_2.mp4", 1e9),
                    ("video_0.mp4", -5.0), ("video_1.mp4", 0.0),
                    ("nope.mp4", 0.0), ("video_3.mp4", float("nan"))):
        assert port.nearest_frame(name, t) == jax_idx.nearest_frame(name, t)
    for row in (0, 55, len(port) - 1):
        np.testing.assert_array_equal(port.frame_embedding(row),
                                      jax_idx.frame_embedding(row))
        assert port.frame_info(row) == jax_idx.frame_info(row)
    for bad in (-1, len(port)):
        with pytest.raises(IndexError):
            port.frame_embedding(bad)
        with pytest.raises(IndexError):
            port.frame_info(bad)
    emb = port.frame_embedding(3)
    emb[:] = 0
    assert port._emb[3].any()              # a copy
    q = corpus[2][4]
    got, want = port.search(q, k=7), jax_idx.search(q, k=7)
    assert [(r["video_name"], r["frame_id"]) for r in got] == \
        [(r["video_name"], r["frame_id"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=SCORE_ATOL)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_native_files_cross(writer, corpus, tmp_path):
    """An ``.npz`` written by either package loads in the other: the same
    columns, names and hashes, and the same video ranking."""
    pair = _pair("float32")
    _fill(pair, corpus, videos=[5, 2, 7])
    for idx in pair:
        idx.remove_video("video_2.mp4")
        idx.video_hashes.update({"video_5.mp4": "h5", "video_7.mp4": "h7"})
    src, dst = pair if writer == "jax" else pair[::-1]
    path = tmp_path / "index.npz"
    src.save_native(path)
    dst.add_batch(corpus[0], "stale.mp4", _stamps(0))    # replaced by load
    dst.load_native(path)
    n = len(src)
    assert len(dst) == n == 2 * FRAMES
    for col in ("_emb", "_video_ids", "_timestamps", "_frame_ids"):
        np.testing.assert_array_equal(getattr(dst, col)[:n],
                                      getattr(src, col)[:n])
    assert dst._video_names == src._video_names
    assert dst.video_hashes == src.video_hashes
    assert dst.video_frame_counts() == src.video_frame_counts()
    for q in _queries(corpus):
        _same(pair[1].search_videos(q, 4), pair[0].search_videos(q, 4))


@pytest.mark.parametrize("layout", ["runs", "interleaved", "one_row_runs"])
def test_load_sums_are_the_references_bit_for_bit(layout):
    """The load path's per-video f64 sums equal ``np.add.at``'s and the JAX
    index's bit for bit (signed zeros and magnitudes over 16 decades
    included), so the means, and the rankings, are JAX's on every path."""
    rng = np.random.default_rng(21)
    n = 3000
    ids = {"runs": np.repeat(np.arange(30), 100),
           "interleaved": rng.integers(0, 9, n),
           "one_row_runs": np.arange(n) % 2}[layout]
    rows = (rng.standard_normal((n, D))
            * 10.0 ** rng.integers(-8, 8, (n, 1))).astype(np.float32)
    rows[rng.random((n, D)) < 0.05] = -0.0
    want = np.zeros((int(ids.max()) + 1, D))
    np.add.at(want, ids, rows.astype(np.float64))
    got = port_index._sequential_sums(rows, ids.astype(np.int32), len(want))
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    payload = {"embeddings": list(rows), "video_hashes": {},
               "metadata": [{"video_name": f"v{i}.mp4", "timestamp": 0.1 * t,
                             "frame_id": t} for t, i in enumerate(ids)]}
    jax_idx, port = _pair("float32")
    for idx in (jax_idx, port):
        idx.load_cache_dict(payload)
    v = len(port._video_names)
    assert np.array_equal(port._video_sums[:v].view(np.int64),
                          jax_idx._video_sums[:v].view(np.int64))
    assert np.array_equal(port._video_counts[:v], jax_idx._video_counts[:v])
