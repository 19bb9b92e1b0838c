"""The port's ingest path vs the JAX package's, on the CPU.

- frame extraction (``ingest/frames.py``) on synthetic mp4s: bit-identical
  frames and equal timestamps in all four sampling modes; the interval
  math and the identity hash equal;
- the decode pipeline (``ingest/pipeline.py``): the same cross-video
  batches, in the same order, with 2 decode workers and a prefetch below
  the video count, under the thread pool and the spawn process pool;
- the engine: a port engine and a JAX engine each ingest the same two
  videos through the same tiny f32 tower (``TINY_224``: 224 px frames in
  56 px patches, S = 17): the same names, timestamps, frame ids and
  arrangement (perm); embeddings within the towers' f32 tolerance (rtol /
  atol 2e-4, per-row cosine >= 1 - 1e-5); the pickle cache of either
  loads in the other; a truncated cache makes both engines reprocess
  their videos and write a cache that loads (and ``save_to_disk`` /
  ``load_from_disk`` return what the JAX package's return);
- device-streamed appends (``DeviceVideoIndex.stream_rows_device``)
  against a twin index fed the same batches through ``add_batch`` +
  ``sync_mirror()`` (the host path), bit for bit, in all four tiers: a
  build from zero rows, an append onto a loaded corpus, and an append
  that crosses the capacity chunk. The streamed index never takes the
  host path (no sync, no re-placement, also not across the chunk). For the build from zero rows the twin's mirror is placed at
  zero rows first (``_sync_device``), as the streamed build's is, so both
  keep the incremental Fisher–Yates arrangement from the first row.
"""

import itertools
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.helpers import make_synthetic_video
from tests.test_torch_stageprof import spans_on  # noqa: F401  (a fixture)
from tests.torch_parity import TINY_224, port_state_dict, row_cosine
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.index.device_index import \
    DeviceVideoIndex as JaxIndex
from video_quierer_tpu.ingest import frames as jax_frames
from video_quierer_tpu.ingest import pipeline as jax_pipeline
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxEmbedder
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index.device_index import (
    _CHUNK,
    DeviceVideoIndex,
)
from video_quierer_tpu_torch.ingest import frames as torch_frames
from video_quierer_tpu_torch.ingest import pipeline as torch_pipeline
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder

F32_TOL = 2e-4
MIN_COS = 1 - 1e-5
DTYPES = ("float32", "bfloat16", "int8", "int4")


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Five short synthetic mp4s of different lengths."""
    d = tmp_path_factory.mktemp("videos")
    return [make_synthetic_video(d / f"clip_{i}.mp4", n_frames=30 + 17 * i,
                                 seed=i) for i in range(5)]


def test_sampling_interval_matches_jax():
    for total in (0, 1, 7, 90, 301, 10_000):
        for max_frames in (1, 3, 4, 300):
            for mode in (*torch_frames.SAMPLING_MODES, "other"):
                assert torch_frames.sampling_interval(total, max_frames,
                                                      mode) == \
                    jax_frames.sampling_interval(total, max_frames, mode)


def test_identity_hash_and_probe_match_jax(videos):
    for v in videos[:2]:
        assert torch_frames.video_identity_hash(v) == \
            jax_frames.video_identity_hash(v)
        got, want = torch_frames.probe_video(v), jax_frames.probe_video(v)
        assert (got.fps, got.total_frames, got.duration) == \
            (want.fps, want.total_frames, want.duration)
    assert torch_frames.probe_video(videos[0].with_suffix(".avi")) is None


@pytest.mark.parametrize("mode", torch_frames.SAMPLING_MODES)
def test_extract_frames_matches_jax(videos, mode):
    video = videos[4]                              # 98 frames
    got, got_ts = torch_frames.extract_frames(video, max_frames=20,
                                              sampling_mode=mode)
    want, want_ts = jax_frames.extract_frames(video, max_frames=20,
                                              sampling_mode=mode,
                                              use_native=False)
    assert got.shape == want.shape and got.shape[1:] == (224, 224, 3)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert got_ts == want_ts


def _batches(mod, videos, batch_size=16, **kw):
    return [(b.frames, b.video_indices, b.timestamps,
             [(v, f.shape[0], list(t)) for v, f, t in mod.group_by_video(b)])
            for b in _stream(mod, videos, batch_size, **kw)]


def _stream(mod, videos, batch_size, **kw):
    return mod.batched_frames(videos, max_frames=9, sampling_mode="high",
                              batch_size=batch_size, num_workers=2,
                              prefetch=2, **kw)


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 1
    for (gf, gv, gt, gg), (wf, wv, wt, wg) in zip(got, want):
        assert np.array_equal(gf, wf)
        assert (gv, gt, gg) == (wv, wt, wg)


def test_batched_frames_order_matches_jax(videos):
    got = _batches(torch_pipeline, videos)
    _assert_same_batches(got, _batches(jax_pipeline, videos))
    # deterministic video order: all of video i before video i + 1
    order = [v for _, vidx, _, _ in got for v in vidx]
    assert order == sorted(order) and set(order) == set(range(5))


def test_batched_frames_process_pool_matches_threads(videos):
    _assert_same_batches(_batches(torch_pipeline, videos, num_procs=2),
                         _batches(torch_pipeline, videos))


def test_failed_extraction_skips_the_video(videos):
    def extract(path):
        if path.name == "clip_1.mp4":
            raise RuntimeError("decode failed")
        return torch_frames.extract_frames(path, max_frames=3)
    batches = list(torch_pipeline.batched_frames(videos[:3], batch_size=4,
                                                 extract_fn=extract))
    assert sorted({v for b in batches for v in b.video_indices}) == [0, 2]


def _ptr(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def test_kept_view_holds_its_slot(videos):
    """A view a consumer keeps of one batch (``b.frames[2:5]``) reads what
    it read while the consumer takes five more batches: the ring fills
    that batch's slot again only once nothing views it."""
    want = _batches(jax_pipeline, videos, batch_size=4)
    it = _stream(torch_pipeline, videos, 4)
    kept = next(it).frames[2:5]
    slot = _ptr(kept) - 2 * kept.strides[0]
    for i in range(1, 6):
        b = next(it)
        assert np.array_equal(b.frames, want[i][0])
        assert _ptr(b.frames) != slot
        del b
    assert np.array_equal(kept, want[0][0][2:5])
    it.close()


def test_dropped_batches_reuse_the_ring(videos, spans_on):  # noqa: F811
    """A consumer that drops each batch gets the ring's slots again: the
    frames' data pointers repeat, and ``frames.fresh`` counts only the
    ring's first fill."""
    want = _batches(jax_pipeline, videos, batch_size=4)
    ptrs = []
    for i, b in enumerate(_stream(torch_pipeline, videos, 4)):
        assert np.array_equal(b.frames, want[i][0])
        assert (b.video_indices, b.timestamps) == (want[i][1], want[i][2])
        ptrs.append(_ptr(b.frames))
    calls = {k: v[0] for k, v in spans_on.snapshot().items()}
    assert len(ptrs) == len(want) == calls["frames.stack"]
    assert len(set(ptrs)) == calls["frames.fresh"] \
        <= torch_pipeline.RING_SLOTS < len(ptrs)


def _numbered(path):
    """Three frames filled with the video's number, as ``v<n>.mp4``'s."""
    v = int(Path(path).stem[1:])
    return np.full((3, 224, 224, 3), v % 256, np.uint8), [0.0, 0.5, 1.0]


def test_close_stops_the_assembler():
    """Closing the generator in the middle of a long video list stops its
    assembler thread and its decode pool, and no extraction starts after."""
    calls = []

    def extract(path):
        calls.append(path)
        return _numbered(path)

    paths = [f"v{i}.mp4" for i in range(100_000)]
    jax_it = jax_pipeline.batched_frames(paths, batch_size=4, num_workers=2,
                                         prefetch=4, extract_fn=_numbered)
    want = list(itertools.islice(jax_it, 3))
    jax_it.close()
    before = set(threading.enumerate())
    it = torch_pipeline.batched_frames(paths, batch_size=4, num_workers=2,
                                       prefetch=4, extract_fn=extract)
    for w in want:
        b = next(it)
        assert np.array_equal(b.frames, w.frames)
        assert (b.video_indices, b.timestamps) == \
            (w.video_indices, w.timestamps)
    it.close()
    deadline = time.monotonic() + 5
    while set(threading.enumerate()) - before \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - before
    n = len(calls)
    time.sleep(0.2)
    assert len(calls) == n < 30


def test_assembler_error_reaches_the_consumer():
    """Frames of a second shape: a batch made of them alone is built by a
    fresh ``np.stack``; a batch mixing both shapes raises ``np.stack``'s
    error at the consumer's ``next()``, after the batches before it, as
    the JAX pipeline does."""
    shapes = [(8, 224), (8, 224), (8, 224), (4, 32), (2, 224), (2, 32)]

    def extract(path):
        v = int(Path(path).stem[1:])
        n, s = shapes[v]
        return np.full((n, s, s, 3), v, np.uint8), [0.5 * j for j in range(n)]

    def run(mod):
        got = []
        with pytest.raises(ValueError) as err:
            for b in mod.batched_frames([f"v{i}.mp4" for i in range(6)],
                                        batch_size=4, num_workers=2,
                                        prefetch=2, extract_fn=extract):
                got.append((b.frames, b.video_indices, b.timestamps))
        return got, str(err.value)

    got, got_err = run(torch_pipeline)
    want, want_err = run(jax_pipeline)
    assert got_err == want_err and "same shape" in got_err
    assert len(got) == len(want) == 7 and got[6][0].shape[1] == 32
    for (gf, gv, gt), (wf, wv, wt) in zip(got, want):
        assert np.array_equal(gf, wf) and (gv, gt) == (wv, wt)

# -- the engine, against the JAX engine -------------------------------------

def _port_engine(d, dtype="bfloat16", embedder=None, **ingest):
    cfg = torch_config.EngineConfig(videos_dir=str(d))
    cfg.index.embed_dim = 64
    cfg.index.device_dtype = dtype
    cfg.api.max_frames = 12
    cfg.ingest.batch_size = 16
    for k, v in ingest.items():
        setattr(cfg.ingest, k, v)
    return VideoSearchEngine(d, config=cfg, embedder=embedder, device="cpu")


@pytest.fixture(scope="module")
def jax_embedder():
    return JaxEmbedder(TINY_224, dtype=jnp.float32, seed=3)


@pytest.fixture(scope="module")
def port_embedder(jax_embedder):
    return CLIPEmbedder(TINY_224, dtype=torch.float32, device="cpu",
                        state_dict=port_state_dict(jax_embedder.params,
                                                   TINY_224))


def _copy_videos(videos, d, which=(0, 3)):
    d.mkdir()
    for i in which:
        shutil.copy2(videos[i], d / videos[i].name)
    return d


def test_engine_ingest_matches_jax(videos, tmp_path, jax_embedder,
                                   port_embedder):
    jcfg = jax_config.EngineConfig(
        videos_dir=str(tmp_path / "jax"),
        api=jax_config.ApiConfig(max_frames=12))
    jcfg.index.embed_dim = 64
    jcfg.ingest.batch_size = 16
    jeng = JaxEngine(_copy_videos(videos, tmp_path / "jax"), config=jcfg,
                     embedder=jax_embedder)
    peng = _port_engine(_copy_videos(videos, tmp_path / "port"),
                        embedder=port_embedder)
    jeng.startup()
    peng.startup()
    want, got = jeng.index.to_cache_dict(), peng.index.to_cache_dict()
    assert len(got["metadata"]) == 24 and got["metadata"] == \
        want["metadata"]
    assert got["video_hashes"].keys() == want["video_hashes"].keys()
    w, g = np.stack(want["embeddings"]), np.stack(got["embeddings"])
    assert row_cosine(g, w).min() >= MIN_COS
    np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
    # the streamed arrangement: the same incremental Fisher–Yates draws
    assert np.array_equal(peng.index._perm, jeng.index._perm)
    assert np.array_equal(peng.index._perm_dev.numpy(), peng.index._perm)
    assert peng.metrics.counter("embed_fallbacks") == 0
    # each package loads the other's cache
    jidx = JaxIndex(dim=64)
    assert jidx.load_from_disk(peng.cache_path)
    assert jidx.to_cache_dict()["metadata"] == got["metadata"]
    assert np.array_equal(np.stack(jidx.to_cache_dict()["embeddings"]), g)
    pidx = DeviceVideoIndex(dim=64, device="cpu")
    assert pidx.load_from_disk(jeng.cache_path)
    assert pidx.to_cache_dict()["metadata"] == want["metadata"]
    assert np.array_equal(np.stack(pidx.to_cache_dict()["embeddings"]), w)


def _truncate(path):
    path.write_bytes(path.read_bytes()[:len(path.read_bytes()) // 2])


def test_save_and_load_return_what_jax_returns(tmp_path):
    """``save_to_disk`` gives True (False on a failed write) and
    ``load_from_disk`` gives False on a truncated or malformed cache and
    leaves the index as it was, as the JAX package's."""
    rows = np.eye(4, 64, dtype=np.float32)
    pidx, jidx = DeviceVideoIndex(dim=64, device="cpu"), JaxIndex(dim=64)
    for idx in (pidx, jidx):
        idx.add_batch(rows, "a.mp4", [0.0, 0.5, 1.0, 1.5])
    for idx, name in ((pidx, "port.pkl"), (jidx, "jax.pkl")):
        assert idx.save_to_disk(tmp_path / name) is True
        assert idx.save_to_disk(tmp_path) is False          # a directory
        path = tmp_path / name
        _truncate(path)
        assert idx.load_from_disk(path, verify=False) is False
        path.write_bytes(b"not a pickle")
        assert idx.load_from_disk(path, verify=False) is False
        assert len(idx) == 4


def test_truncated_cache_reprocesses_in_both_engines(videos, tmp_path,
                                                     jax_embedder,
                                                     port_embedder):
    """A truncated cache is a miss in both engines: startup ingests the
    videos again, as the JAX engine does, and writes a cache that loads."""
    jcfg = jax_config.EngineConfig(
        videos_dir=str(tmp_path / "jax"),
        api=jax_config.ApiConfig(max_frames=12))
    jcfg.index.embed_dim = 64
    jcfg.ingest.batch_size = 16
    jeng = JaxEngine(_copy_videos(videos, tmp_path / "jax"), config=jcfg,
                     embedder=jax_embedder)
    peng = _port_engine(_copy_videos(videos, tmp_path / "port"),
                        embedder=port_embedder)
    for eng in (jeng, peng):
        eng.startup()
        assert len(eng.index) == 24
        _truncate(eng.cache_path)
        Path(str(eng.cache_path) + ".sha256").unlink()
    jeng = JaxEngine(tmp_path / "jax", config=jcfg, embedder=jax_embedder)
    peng = _port_engine(tmp_path / "port", embedder=port_embedder)
    jeng.startup()
    peng.startup()
    want, got = jeng.index.to_cache_dict(), peng.index.to_cache_dict()
    assert len(got["metadata"]) == 24 and got["metadata"] == \
        want["metadata"]
    np.testing.assert_allclose(np.stack(got["embeddings"]),
                               np.stack(want["embeddings"]), rtol=F32_TOL,
                               atol=F32_TOL)
    for path in (jeng.cache_path, peng.cache_path):
        pidx, jidx = DeviceVideoIndex(dim=64, device="cpu"), JaxIndex(dim=64)
        assert pidx.load_from_disk(path) and jidx.load_from_disk(path)
        assert pidx.to_cache_dict()["metadata"] == want["metadata"]
        assert jidx.to_cache_dict()["metadata"] == want["metadata"]


def test_engine_reingest_search_and_remove(videos, tmp_path, port_embedder):
    eng = _port_engine(_copy_videos(videos, tmp_path / "v", (0, 1, 2)),
                       embedder=port_embedder)
    eng.startup()
    assert len(eng.index) == 36 and len(eng.index.video_hashes) == 3
    # a restart with an unchanged dir ingests nothing
    again = _port_engine(tmp_path / "v", embedder=port_embedder)
    again.startup()
    assert len(again.index) == 36
    feats = eng.index._emb[:36]
    rows = eng.index.search_batch(feats[[0, 20]], k=1)
    assert [r[0]["frame_id"] for r in rows] == [0, 20]
    # re-ingesting a video replaces its rows
    assert eng.process_video(tmp_path / "v" / "clip_1.mp4") == 12
    assert len(eng.index) == 36
    names = [m["video_name"] for m in eng.index.to_cache_dict()["metadata"]]
    assert names[-12:] == ["clip_1.mp4"] * 12
    assert eng.remove_video("clip_1.mp4") == 12
    assert len(eng.index) == 24 and "clip_1.mp4" not in \
        eng.index.video_hashes
    assert eng.metrics.counter("frames_embedded") == 48


def test_ingest_without_streaming_syncs_at_search(videos, tmp_path,
                                                  port_embedder):
    eng = _port_engine(_copy_videos(videos, tmp_path / "v", (0,)),
                       embedder=port_embedder, stream_mirror=False)
    eng.startup()
    assert len(eng.index) == 12
    rows = eng.index.search_batch(eng.index._emb[[5]], k=1)
    assert rows[0][0]["frame_id"] == 5


class _BrokenFrames:
    def embed_frames_device(self, frames):
        raise RuntimeError("tower failed")


def test_failed_embed_raises(videos, tmp_path):
    eng = _port_engine(_copy_videos(videos, tmp_path / "v", (0,)),
                       embedder=_BrokenFrames())
    with pytest.raises(RuntimeError, match="tower failed"):
        eng.startup()
    assert not eng.ready and eng.metrics.counter("embed_fallbacks") == 0


# -- device-streamed appends vs the host path --------------------------------

def _unit(rng, n, d=64):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_same_mirrors(a, b):
    for name in ("_device_emb", "_device_scales", "_perm_dev",
                 "_device_f32"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name
            assert not x.is_inference(), name
    assert (a._device_rows, a._f32_rows) == (b._device_rows, b._f32_rows)


def _indices(dtype, case, rng):
    idx = [DeviceVideoIndex(dim=64, device_dtype=dtype, device="cpu",
                            device_rerank="on") for _ in range(2)]
    if case == "fresh":
        idx[1]._sync_device()
        if idx[1]._device_rerank_active():
            with idx[1]._sync_lock:
                idx[1]._sync_device_f32()
    else:
        base = _unit(rng, _CHUNK - 300 if case == "grow" else 5000)
        for x in idx:
            x.add_batch(base, "base.mp4", [0.0] * len(base))
            x.sync_mirror()
    return idx


def _feed(streamed, twin, rng, batches, inference):
    for b in range(batches):
        feats = torch.from_numpy(_unit(rng, 256))
        lo = len(streamed)
        for x in (streamed, twin):
            x.add_batch(feats[:100].numpy(), f"v{b}a.mp4", [0.5] * 100)
            x.add_batch(feats[100:].numpy(), f"v{b}b.mp4", [1.5] * 156)
        if inference:
            with torch.inference_mode():
                streamed.stream_rows_device(feats.clone(), offset=0, n=256,
                                            lo=lo)
        else:
            streamed.stream_rows_device(feats, offset=0, n=256, lo=lo)
        twin.sync_mirror()
        _assert_same_mirrors(streamed, twin)


@pytest.mark.parametrize("case", ["fresh", "loaded", "grow"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_streamed_mirrors_match_host_path(dtype, case, monkeypatch):
    rng = np.random.default_rng(DTYPES.index(dtype))
    streamed, twin = _indices(dtype, case, rng)
    host_paths = []
    for name in ("_sync_device_locked", "_full_place"):
        real = getattr(DeviceVideoIndex, name)

        def spy(self, *a, _real=real, _name=name):
            if self is streamed:
                host_paths.append(_name)
            return _real(self, *a)

        monkeypatch.setattr(DeviceVideoIndex, name, spy)
    _feed(streamed, twin, rng, 4, inference=False)
    assert host_paths == []
    assert (streamed._device_cap > _CHUNK) == (case == "grow")
    if dtype != "float32":                         # the live-prefix tiers
        assert np.array_equal(streamed._perm_dev.numpy(), streamed._perm)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_streamed_appends_inside_and_outside_inference_mode(dtype):
    """Streams from inference tensors, inside inference mode, onto a
    mirror made outside it; then a build from zero rows made inside it,
    updated in place by the host path outside it."""
    rng = np.random.default_rng(7)
    streamed, twin = _indices(dtype, "loaded", rng)
    _feed(streamed, twin, rng, 2, inference=True)
    streamed, twin = _indices(dtype, "fresh", rng)
    _feed(streamed, twin, rng, 1, inference=True)
    for x in (streamed, twin):
        x.add_batch(_unit(np.random.default_rng(8), 30), "late.mp4",
                    [0.0] * 30)
        x.sync_mirror()
    _assert_same_mirrors(streamed, twin)
    rows = streamed.search_batch(streamed._emb[[3, 270]], k=1)
    assert [r[0]["frame_id"] for r in rows] == [3, 270]


def test_add_batch_device_appends_one_video():
    rng = np.random.default_rng(9)
    streamed, twin = _indices("int4", "fresh", rng)
    feats = torch.from_numpy(_unit(rng, 32))
    streamed.add_batch_device(feats, "a.mp4", [0.0] * 20, offset=5)
    twin.add_batch(feats[5:25].numpy(), "a.mp4", [0.0] * 20)
    twin.sync_mirror()
    _assert_same_mirrors(streamed, twin)
    assert np.array_equal(streamed._emb[:20], feats[5:25].numpy())


INGEST_SPANS = ("ingest.next", "embed.fetch", "ingest.append")


def test_ingest_logs_each_batch_under_its_number(videos, tmp_path,  # noqa: F811
                                                 port_embedder, spans_on):
    """Each batch logs one ``ingest.next``, one ``embed.fetch`` and one
    ``ingest.append`` under the engine's batch number, which runs on across
    ingests, on the loop's thread; the ``ingest.next`` that finds the
    stream's end carries the number the next batch will take. Each batch's
    ``frames.stack`` (a ``frames.fresh`` inside it while the ring fills) is
    logged on the frame assembler's thread, with no number, and ends
    before the loop's wait for that batch does."""
    eng = _port_engine(_copy_videos(videos, tmp_path / "v", (0, 3)),
                       embedder=port_embedder)
    eng.startup()                               # 24 frames: 16 + 8
    assert eng.process_video(tmp_path / "v" / "clip_3.mp4") == 12
    assert eng.metrics.counter("ingest_batches") == 3
    assert eng.metrics.counter("frames_embedded") == 36
    by_unit, stacks, fresh = {}, [], []
    for e in spans_on.events()[0]:
        if e.name in INGEST_SPANS:
            by_unit.setdefault(e.unit, []).append(e)
        elif e.name == "frames.stack":
            stacks.append(e)
        elif e.name == "frames.fresh":
            fresh.append(e)
    assert sorted(by_unit) == [0, 1, 2, 3]
    assert [e.name for e in by_unit[3]] == ["ingest.next"]
    loop = {e.thread for evs in by_unit.values() for e in evs}
    assert len(loop) == 1
    stacks.sort(key=lambda e: e.t1_ns)
    assert len(stacks) == 3
    for n in range(3):
        names = sorted(e.name for e in by_unit[n])
        ends = 1 if n == 2 else 0           # the first ingest's end
        assert names == sorted(INGEST_SPANS + ("ingest.next",) * ends), n
        named = {e.name: e for e in by_unit[n] if e.name != "ingest.next"}
        nxt = max((e for e in by_unit[n] if e.name == "ingest.next"
                   and e.t1_ns <= named["embed.fetch"].t0_ns),
                  key=lambda e: e.t1_ns)
        assert nxt.parent is None
        assert nxt.t1_ns <= named["embed.fetch"].t0_ns \
            <= named["embed.fetch"].t1_ns <= named["ingest.append"].t0_ns
        stack = stacks[n]
        assert stack.t1_ns <= nxt.t1_ns
        assert stack.thread not in loop
        assert stack.parent is None and stack.unit is None
    # the first ingest fills two slots of its ring, the second one
    assert len(fresh) == 3
    for e in fresh:
        assert e.parent == "frames.stack" and any(
            s.thread == e.thread and s.t0_ns <= e.t0_ns <= e.t1_ns <= s.t1_ns
            for s in stacks)
