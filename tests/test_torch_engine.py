"""Port engine surfaces vs the JAX package's: the config (same nine
``config.json`` keys and defaults, same engine defaults and ``VQT_*``
mapping, same validation), startup's refusal to run on a missing card,
and the coalescer's
failure contract (errors reach every waiter; nothing falls back). The
ingest path itself is held against the JAX engine in
``tests/test_torch_ingest.py``."""

import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.metrics import HISTOGRAM_CAP, SystemMetrics
from video_quierer_tpu_torch.engine.system import VideoSearchEngine

ROOT = Path(__file__).resolve().parents[1]


def test_api_config_keys_and_defaults_match():
    want = jax_config.ApiConfig().model_dump()
    got = torch_config.ApiConfig().to_dict()
    assert list(got) == list(want) and len(got) == 9
    assert got == want


def test_engine_config_defaults_match():
    want = jax_config.EngineConfig()
    got = torch_config.EngineConfig()
    for section in ("ingest", "index", "cache", "model"):
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(want, section)), section
    for field in ("videos_dir", "coalesce_width", "thumbnail_base_url",
                  "invalidate_on_config_change"):
        assert getattr(got, field) == getattr(want, field)


def test_env_overrides_match(monkeypatch):
    assert torch_config._ENV_OVERRIDES.keys() == \
        jax_config._ENV_OVERRIDES.keys()
    env = {"VQT_COALESCE_WIDTH": "128", "VQT_DTYPE": "float32",
           "VQT_DEVICE_RERANK": "off", "VQT_STREAM_MIRROR": "0",
           "VQT_IVF_NPROBE": "junk"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = torch_config.apply_env_overrides(torch_config.EngineConfig())
    want = jax_config.apply_env_overrides(jax_config.EngineConfig())
    assert got.coalesce_width == want.coalesce_width == 128
    assert got.model.dtype == want.model.dtype == "float32"
    assert got.index.device_rerank == want.index.device_rerank == "off"
    assert got.ingest.stream_mirror is want.ingest.stream_mirror is False
    assert got.index.ivf_nprobe == want.index.ivf_nprobe == 8


@pytest.mark.parametrize("section,field,value", [
    ("api", "sampling_mode", "weekly"), ("api", "max_frames", 0),
    ("index", "device_rerank", "maybe"), ("model", "parallel", "tp"),
    ("ingest", "sampling_strategy", "random"), (None, "coalesce_width", 0),
])
def test_validation_matches(section, field, value):
    for mod in (jax_config, torch_config):
        cfg = mod.EngineConfig()
        target = cfg if section is None else getattr(cfg, section)
        object.__setattr__(target, field, value)
        with pytest.raises(ValueError):
            cfg.validate()


def test_load_api_config_file(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"max_frames": 120, "enhanced_mode": False,
                                "unknown": 1}))
    got = torch_config.load_api_config(path)
    want = jax_config.load_api_config(path)
    assert got.to_dict() == want.model_dump()
    path.write_text("{not json")
    assert torch_config.load_api_config(path) == torch_config.ApiConfig()


def _engine(tmp_path, embedder=None):
    cfg = torch_config.EngineConfig(videos_dir=str(tmp_path))
    cfg.index.embed_dim = 64
    return VideoSearchEngine(tmp_path, config=cfg, embedder=embedder,
                             device="cpu")


def test_startup_skips_an_unreadable_video(tmp_path):
    """A video that does not decode yields no frames, as in the
    reference; its hash is recorded so the next startup skips it."""
    (tmp_path / "clip.mp4").write_bytes(b"not really a video")
    engine = _engine(tmp_path)
    engine.startup()
    assert engine.ready and len(engine.index) == 0
    assert "clip.mp4" in engine.index.video_hashes


def test_startup_without_cache_or_videos_writes_empty_cache(tmp_path):
    engine = _engine(tmp_path)
    engine.startup()
    assert engine.ready and len(engine.index) == 0
    assert (tmp_path / "video_search_cache.pkl").exists()
    stats = engine.stats()
    assert stats["index"]["accuracy_mode"] == "exact-f32-rerank"
    assert stats["metrics"]["counters"]["fused_search_fallbacks"] == 0


@pytest.mark.parametrize("dtype,mode", [("float32", "exact-f32-scan"),
                                        ("bfloat16", "exact-f32-rerank"),
                                        ("int8", "exact-f32-rerank"),
                                        ("int4", "exact-f32-rerank")])
def test_engine_serves_each_device_dtype(tmp_path, monkeypatch, dtype,
                                         mode):
    """``VQT_INDEX_DTYPE`` picks the mirror, as in the reference; the
    accuracy mode follows it."""
    monkeypatch.setenv("VQT_INDEX_DTYPE", dtype)
    cfg = torch_config.apply_env_overrides(
        torch_config.EngineConfig(videos_dir=str(tmp_path)))
    want = jax_config.apply_env_overrides(jax_config.EngineConfig())
    assert cfg.index.device_dtype == want.index.device_dtype == dtype
    cfg.index.embed_dim = 64
    engine = VideoSearchEngine(tmp_path, config=cfg, device="cpu")
    assert engine.index.device_dtype == dtype
    rows = torch.randn(300, 64).numpy()
    engine.index.add_batch(rows, "a.mp4", [float(i) for i in range(300)])
    engine.startup()
    assert engine.stats()["index"]["accuracy_mode"] == mode
    got = engine.index.search_batch(rows[[7, 200]], k=3)
    assert [r[0]["frame_id"] for r in got] == [7, 200]


class _BrokenEmbedder:
    """Tokenizes, then fails in the text tower."""

    def __init__(self):
        from video_quierer_tpu_torch.models.clip.tokenizer import \
            HashTokenizer
        self.tokenizer = HashTokenizer()
        self.params = None
        self.prepare_text_ids = staticmethod(lambda ids: ids)

    def text_encode_fn(self, params, ids):
        raise RuntimeError("tower failed")


def test_coalescer_propagates_failures_to_every_waiter(tmp_path):
    engine = _engine(tmp_path, embedder=_BrokenEmbedder())
    engine.index.add_batch(torch.randn(10, 64).numpy(), "a.mp4",
                           [float(i) for i in range(10)])
    try:
        with ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(engine.search_coalesced_ex, f"q{i}", 5,
                                False) for i in range(8)]
            for f in futs:
                with pytest.raises(RuntimeError, match="tower failed"):
                    f.result(timeout=60)
        # the read locks were released: a writer can still get in
        with engine.lock:
            pass
        assert engine.metrics.counter("fused_search_fallbacks") == 0
    finally:
        engine.close()


def test_histogram_count_and_sum_run_past_the_window():
    """A histogram's count and sum (and Prometheus' ``_count`` and
    ``_sum``) run over every sample; its quantiles over the last
    ``HISTOGRAM_CAP``."""
    m = SystemMetrics()
    n = HISTOGRAM_CAP + 500
    for v in range(n):
        m.observe("op_ms", float(v))
    s = m.histogram_stats("op_ms")
    assert s["count"] == n and s["sum"] == float(sum(range(n)))
    assert s["min"] == 500 and s["max"] == n - 1
    assert s["mean"] == pytest.approx(500 + (HISTOGRAM_CAP - 1) / 2)
    text = m.export_prometheus().splitlines()
    assert f"video_search_op_ms_count {n}" in text
    assert f"video_search_op_ms_sum {float(sum(range(n)))}" in text
    assert f'video_search_op_ms{{quantile="50"}} {s["p50"]}' in text


def test_server_refuses_to_start_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the server would start")
    out = subprocess.run(
        [sys.executable, "-m", "video_quierer_tpu_torch.api",
         "--videos-dir", str(tmp_path), "--port", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr


def _warm_engine(tmp_path, dtype="bfloat16", embedder=True):
    from tests.torch_parity import TINY_FULL_VOCAB
    from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
    cfg = torch_config.EngineConfig(videos_dir=str(tmp_path))
    cfg.index.embed_dim = 64
    cfg.index.device_dtype = dtype
    emb = (CLIPEmbedder(TINY_FULL_VOCAB, dtype=torch.float32, device="cpu")
           if embedder else None)
    engine = VideoSearchEngine(tmp_path, config=cfg, embedder=emb,
                               device="cpu")
    engine.index.add_batch(torch.randn(300, 64).numpy(), "a.mp4",
                           [float(i) for i in range(300)])
    return engine


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_startup_warms_the_fused_search_path(tmp_path, monkeypatch, dtype):
    """startup() runs the fused text-search path once for each shape the
    first requests meet — singles at k = 1, 10 (default_results) and a
    ~30-token single, the text buckets up to the coalescer's width at k =
    10 — so that one-time costs on the card fall in startup; no metric,
    cache or index state sees the warm-up."""
    engine = _warm_engine(tmp_path, dtype)
    calls = []
    dispatch = engine._dispatch_batch_fused

    def spy(queries, k):
        calls.append((len(queries), k))
        return dispatch(queries, k)

    monkeypatch.setattr(engine, "_dispatch_batch_fused", spy)
    hashes = dict(engine.index.video_hashes)
    engine.startup()
    assert engine.ready and len(engine.index) == 300
    assert calls == [(1, 1), (1, 1), (1, 10), (1, 10), (8, 10), (32, 10),
                     (64, 10)]
    assert engine.metrics.counter("searches") == 0
    assert engine.index.video_hashes == hashes
    assert len(engine.query_cache._cache) == 0
    got = engine.search_batch(["a query"], k=3)
    assert len(got) == 1 and len(got[0]) == 3


def test_startup_on_the_cpu_does_not_build_an_embedder_to_warm(tmp_path,
                                                               monkeypatch):
    engine = _warm_engine(tmp_path, embedder=False)
    monkeypatch.setattr(engine, "_dispatch_batch_fused", None)
    engine.startup()
    assert engine.ready and engine._embedder is None


def test_a_failing_warm_up_does_not_fail_startup(tmp_path, caplog):
    engine = _engine(tmp_path, embedder=_BrokenEmbedder())
    engine.index.add_batch(torch.randn(10, 64).numpy(), "a.mp4",
                           [float(i) for i in range(10)])
    engine.startup()
    assert engine.ready
    assert "search warm-up failed (RuntimeError: tower failed)" in caplog.text
    with pytest.raises(RuntimeError, match="tower failed"):
        engine.search_batch(["q"], k=3)
