"""The port's samplers (``ingest/samplers.py``) against the JAX package's,
on synthetic mp4s (``tests/helpers.py:make_synthetic_video``, at most 60
frames, a scene change every 15 or 20): every strategy's frames bit for
bit and its timestamps equal (the uniform, adaptive and hybrid samplers,
``extract_frames_strategy`` under "interval", "uniform", "adaptive",
"hybrid" and "auto", with and without the quality gate),
``passes_quality_filter`` over seeded gray frames, ``choose_strategy``
and ``build_sampler``; then the port engine against the JAX engine under
each ``ingest.sampling_strategy`` and the quality gate (the tiny 224 px
tower of ``test_torch_ingest``): the same names, timestamps and frame
ids, rows within the towers' f32 tolerance, also through the spawn
process pool (``strategy_extract`` pickled).
"""

import numpy as np
import pytest

from tests.helpers import make_synthetic_video
from tests.test_torch_ingest import (
    F32_TOL,
    jax_embedder,  # noqa: F401  (a fixture)
    port_embedder,  # noqa: F401  (a fixture)
)
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.ingest import samplers as jax_samplers
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.ingest import pipeline as torch_pipeline
from video_quierer_tpu_torch.ingest import samplers as torch_samplers

STRATEGIES = ("interval", "uniform", "adaptive", "hybrid", "auto")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("sampled")
    return [make_synthetic_video(d / "a_clip.mp4", n_frames=60,
                                 scene_every=15, size=(96, 72), seed=1),
            make_synthetic_video(d / "b_clip.mp4", n_frames=45,
                                 scene_every=20, size=(64, 48), seed=2)]


def _same(got, want):
    (gf, gt), (wf, wt) = got, want
    assert gf.shape == wf.shape and gf.dtype == wf.dtype == np.uint8
    assert np.array_equal(gf, wf)
    assert gt == wt


def _run(sampler, path):
    pairs = list(sampler.sample(path))
    frames = (np.stack([f for f, _ in pairs]) if pairs
              else np.zeros((0, 224, 224, 3), np.uint8))
    return frames, [t for _, t in pairs]


SAMPLERS = {
    "uniform": lambda m, q: m.UniformSampler(count=12, quality_filter=q),
    "uniform_more_than_frames": lambda m, q: m.UniformSampler(count=500),
    "adaptive": lambda m, q: m.AdaptiveSampler(max_frames=40,
                                               quality_filter=q),
    "adaptive_low_thresholds": lambda m, q: m.AdaptiveSampler(
        mse_threshold=1.0, chi2_threshold=0.01, min_interval_s=0.1,
        decode_stride=1),
    "hybrid": lambda m, q: m.HybridSampler(uniform_count=8),
    "hybrid_gated": lambda m, q: m.HybridSampler(
        uniform_count=8, dedup_window_s=0.5, quality_filter=q),
}


@pytest.mark.parametrize("quality", [False, True])
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_samplers_match_jax(clips, name, quality):
    for path in clips:
        got = _run(SAMPLERS[name](torch_samplers, quality), path)
        want = _run(SAMPLERS[name](jax_samplers, quality), path)
        _same(got, want)
        if name.startswith("uniform") and not quality:
            assert got[0].shape[0] > 0


@pytest.mark.parametrize("quality", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_extract_frames_strategy_matches_jax(clips, strategy, quality):
    for path in clips:
        kw = dict(strategy=strategy, max_frames=10, sampling_mode="high",
                  quality_filter=quality)
        _same(torch_samplers.extract_frames_strategy(path, **kw),
              jax_samplers.extract_frames_strategy(path, **kw))


def test_unreadable_video_yields_no_frames(tmp_path):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    for strategy in ("uniform", "adaptive", "hybrid"):
        frames, stamps = torch_samplers.extract_frames_strategy(
            bad, strategy, max_frames=5)
        assert frames.shape == (0, 224, 224, 3) and stamps == []


def test_passes_quality_filter_matches_jax():
    rng = np.random.default_rng(7)
    cases = [np.full((48, 64), v, np.uint8) for v in (5, 19, 20, 128, 235,
                                                      236, 250)]
    cases += [rng.integers(lo, hi, (48, 64), dtype=np.uint8)
              for lo, hi in ((0, 256), (100, 140), (118, 122), (0, 40),
                             (200, 256))]
    smooth = np.tile(np.linspace(0, 255, 64, dtype=np.uint8), (48, 1))
    cases.append(smooth)
    for gray in cases:
        for kw in ({}, {"blur_threshold": 5.0},
                   {"min_brightness": 0.0, "max_brightness": 255.0}):
            assert torch_samplers.passes_quality_filter(gray, **kw) == \
                jax_samplers.passes_quality_filter(gray, **kw)


def test_choose_and_build_match_jax():
    for duration in (0.0, 299.9, 300.0, 1800.0, 3600.0, 3600.1, 7200.0):
        assert type(torch_samplers.choose_strategy(duration)).__name__ == \
            type(jax_samplers.choose_strategy(duration)).__name__
    for strategy in ("uniform", "adaptive", "hybrid"):
        got = torch_samplers.build_sampler(strategy, 30, quality_filter=True)
        want = jax_samplers.build_sampler(strategy, 30, quality_filter=True)
        assert type(got).__name__ == type(want).__name__
        if strategy == "hybrid":
            assert (got.uniform.count, got.adaptive.max_frames) == \
                (want.uniform.count, want.adaptive.max_frames)
    with pytest.raises(ValueError, match="unknown sampling strategy"):
        torch_samplers.build_sampler("weekly", 10)


def _engines(tmp_path, clips, jax_emb, port_emb, procs=0, **ingest):
    out = []
    for name, mod, cls, emb in (("jax", jax_config, JaxEngine, jax_emb),
                                ("port", torch_config, VideoSearchEngine,
                                 port_emb)):
        d = tmp_path / name
        d.mkdir()
        for clip in clips:
            (d / clip.name).write_bytes(clip.read_bytes())
        cfg = mod.EngineConfig(videos_dir=str(d),
                               api=mod.ApiConfig(max_frames=12))
        cfg.index.embed_dim = 64
        cfg.ingest.batch_size = 16
        cfg.ingest.num_decode_procs = procs
        for k, v in ingest.items():
            setattr(cfg.ingest, k, v)
        cfg.validate()
        kw = {"device": "cpu"} if cls is VideoSearchEngine else {}
        engine = cls(d, config=cfg, embedder=emb, **kw)
        engine.startup()
        out.append(engine)
    return out


def _same_rows(jax_engine, port):
    j, p = jax_engine.index, port.index
    n = len(j)
    assert len(p) == n > 0
    assert [p._video_names[v] for v in p._video_ids[:n]] == \
        [j._video_names[v] for v in j._video_ids[:n]]
    np.testing.assert_array_equal(p._timestamps[:n], j._timestamps[:n])
    np.testing.assert_array_equal(p._frame_ids[:n], j._frame_ids[:n])
    np.testing.assert_allclose(p._emb[:n], j._emb[:n], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("strategy", STRATEGIES[1:])
def test_engine_rows_under_each_strategy_match_jax(
        tmp_path, clips, jax_embedder, port_embedder, strategy):  # noqa: F811
    jax_engine, port = _engines(tmp_path, clips, jax_embedder,
                                port_embedder, sampling_strategy=strategy)
    _same_rows(jax_engine, port)
    port.close()


@pytest.mark.parametrize("field,value", [("sampling_strategy", "adaptive"),
                                         ("quality_filter", True)])
def test_startup_ingests_videos_that_need_the_samplers(
        tmp_path, clips, jax_embedder, port_embedder,  # noqa: F811
        field, value):
    """Videos that need ingest through the adaptive sampler or the
    quality gate (the port refused both before ``ingest/samplers.py``):
    startup ingests them with the JAX engine's rows."""
    jax_engine, port = _engines(tmp_path, clips, jax_embedder,
                                port_embedder, **{field: value})
    assert port.ready
    if len(jax_engine.index):
        _same_rows(jax_engine, port)
    else:
        assert len(port.index) == 0
    port.close()


def test_engine_strategy_through_the_process_pool(
        tmp_path, clips, jax_embedder, port_embedder):  # noqa: F811
    """``ingest.num_decode_procs > 0`` ships ``strategy_extract`` to spawned
    workers: the same rows as the JAX engine's."""
    jax_engine, port = _engines(tmp_path, clips, jax_embedder,
                                port_embedder, procs=2,
                                sampling_strategy="hybrid")
    _same_rows(jax_engine, port)
    port.close()


def test_strategy_extract_is_picklable(clips):
    import functools
    import pickle
    fn = functools.partial(torch_pipeline.strategy_extract,
                           strategy="uniform", max_frames=4,
                           sampling_mode="high", target_size=224,
                           quality_filter=False)
    frames, stamps = pickle.loads(pickle.dumps(fn))(clips[0])
    assert frames.shape == (4, 224, 224, 3) and len(stamps) == 4
