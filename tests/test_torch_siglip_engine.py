"""The SigLIP slice end to end: the port's engine with ``model.family =
"siglip"`` vs the JAX engine, each with a SigLIP embedder at the tiny
config injected (width 128, 2 heads of 64, 2 layers; 224 px frames in 56
px patches, so image queries take the engine's 224 px resize; context
16), on the same weights (moved with the port's ``params_from_jax``) and
the same 2 x 2048-row corpus loaded through the pickle v1.0 cache:
single searches (the module tower), ``search_batch`` and a coalesced
batch of 32 (the fused text encode in both) and an image query give the
same rows (same frames in the same order, scores within 1e-5). On the
JAX side ``siglip_base_patch16`` is swapped for the tiny config in the
test only. Also: the family widens ``index.embed_dim`` 512 → 768 as the
JAX engine does, builds the SigLIP embedder on the engine's device, and
still refuses checkpoints and pipeline parallelism."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_siglip import tiny_configs
from tests.torch_parity import numpy_tree
from video_quierer_tpu.engine.config import EngineConfig as JaxConfig
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.models.siglip import embedder as jax_emb_mod
from video_quierer_tpu_torch.engine.config import EngineConfig
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.models.siglip import embedder as emb_mod
from video_quierer_tpu_torch.models.siglip.bridge import params_from_jax

D = 128
WORDS = ("dog cat beach city night snow car river crowd bird forest road "
         "sunset kitchen stage goal").split()


def _config(cfg_cls, videos_dir):
    cfg = cfg_cls(videos_dir=str(videos_dir))
    cfg.model.family = "siglip"
    cfg.model.dtype = "float32"
    cfg.index.embed_dim = D
    return cfg


def _queries(rng, n):
    return [" ".join(rng.choice(WORDS, size=4)) + f" {i}" for i in range(n)]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    videos = tmp_path_factory.mktemp("siglip_videos")
    rng = np.random.default_rng(5)
    idx = DeviceVideoIndex(dim=D, device_dtype="bfloat16", device="cpu")
    for name in ("a.mp4", "b.mp4"):
        rows = rng.standard_normal((2048, D)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
        idx.add_batch(rows, name, [0.5 * t for t in range(2048)])
    idx.save_to_disk(videos / "video_search_cache.pkl")
    jcfg, tcfg = tiny_configs(image=224, patch=56)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_emb_mod, "siglip_base_patch16", lambda: jcfg)
        mp.delenv("VQT_SIGLIP_SPIECE", raising=False)
        mp.setenv("VQT_PALLAS_INTERPRET", "1")
        jax_emb = jax_emb_mod.SigLIPEmbedder(dtype=jnp.float32, seed=2)
        port_emb = emb_mod.SigLIPEmbedder(
            tcfg, dtype=torch.float32, device="cpu",
            state_dict=params_from_jax(numpy_tree(jax_emb.params), tcfg))
        jax_engine = JaxEngine(videos, config=_config(JaxConfig, videos),
                               embedder=jax_emb)
        port = VideoSearchEngine(videos, config=_config(EngineConfig, videos),
                                 embedder=port_emb, device="cpu")
        for e in (jax_engine, port):
            e.startup()
            assert len(e.index) == 4096
        yield jax_engine, port
    port.close()


def _same(got, want):
    assert [(r["video_name"], r["frame_id"]) for r in got] == \
        [(r["video_name"], r["frame_id"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], atol=1e-5)


def test_single_searches_match_jax(engines):
    jax_engine, port = engines
    for q in _queries(np.random.default_rng(1), 3) + ["a", "x " * 40]:
        got, cached = port.search_ex(q, k=10, use_cache=False)
        want, _ = jax_engine.search_ex(q, k=10, use_cache=False)
        assert not cached and len(got) == 10
        _same(got, want)


def test_batch_and_coalesced_match_jax(engines, monkeypatch):
    """32 queries x 16 tokens clear MIN_TOKENS: the fused text encode
    (spied) in the port, JAX's fused encode on the other side."""
    jax_engine, port = engines
    calls = []
    real = emb_mod.fused_siglip_text_encode
    monkeypatch.setattr(emb_mod, "fused_siglip_text_encode",
                        lambda *a, **kw: calls.append(a[1].shape)
                        or real(*a, **kw))
    queries = _queries(np.random.default_rng(2), 32)
    want = jax_engine.search_batch(queries, k=10)
    got = port.search_batch(queries, k=10)
    with ThreadPoolExecutor(32) as pool:
        coalesced = list(pool.map(
            lambda q: port.search_coalesced_ex(q, 10, False)[0], queries))
    assert calls and calls[0] == (32, 16)
    for g, c, w in zip(got, coalesced, want):
        _same(g, w)
        _same(c, w)
    assert port.metrics.counter("embed_fallbacks") == 0
    assert port.metrics.counter("fused_search_fallbacks") == 0


def test_image_query_matches_jax(engines):
    jax_engine, port = engines
    img = np.random.default_rng(3).integers(0, 256, (300, 260, 3),
                                            dtype=np.uint8)
    got, _ = port.search_by_image_ex(img, k=10)
    want, _ = jax_engine.search_by_image_ex(img, k=10)
    _same(got, want)


def test_family_widens_the_index_to_768(tmp_path):
    for cls, eng in ((EngineConfig, VideoSearchEngine),
                     (JaxConfig, JaxEngine)):
        cfg = cls(videos_dir=str(tmp_path))
        cfg.model.family = "siglip"
        kw = {"device": "cpu"} if eng is VideoSearchEngine else {}
        assert eng(tmp_path, config=cfg, **kw).config.index.embed_dim == 768


def test_family_builds_the_siglip_embedder(tmp_path, monkeypatch):
    built = []
    monkeypatch.setattr(emb_mod, "SigLIPEmbedder",
                        lambda **kw: built.append(kw) or "siglip")
    cfg = EngineConfig(videos_dir=str(tmp_path))
    cfg.model.family = "siglip"
    engine = VideoSearchEngine(tmp_path, config=cfg, device="cpu")
    assert engine._get_embedder() == "siglip"
    assert built == [{"checkpoint_dir": None, "orbax_checkpoint": None,
                      "dtype": torch.bfloat16,
                      "device": torch.device("cpu")}]


@pytest.mark.parametrize("field,value,error,match", [
    ("checkpoint_dir", "/ckpt", FileNotFoundError, "no model.safetensors"),
    ("orbax_checkpoint", "/ckpt", ValueError, "not a checkpoint of the port"),
    ("parallel", "pp", ValueError, "clip family")])
def test_family_still_refuses_checkpoints_and_pp(tmp_path, field, value,
                                                 error, match):
    """Pipeline parallelism is refused for SigLIP (the config's rule; CLIP
    serves it: ``tests/test_torch_pipeline.py``); the trainer's checkpoint
    is passed through to the embedder, which reads it (a directory that
    is not one of the port's raises ``ValueError``; served checkpoints:
    ``tests/test_torch_train_checkpoint.py``); an HF checkpoint dir is
    read, so one without weights raises (CLIP; a SigLIP dir without
    ``model.safetensors`` serves seeded, the reference's rule, held in
    ``tests/test_torch_checkpoint.py``)."""
    families = {"checkpoint_dir": ("clip",), "parallel": ("siglip",)}.get(
        field, ("clip", "siglip"))
    for family in families:
        cfg = EngineConfig(videos_dir=str(tmp_path))
        cfg.model.family = family
        setattr(cfg.model, field, value)
        engine = VideoSearchEngine(tmp_path, config=cfg, device="cpu")
        with pytest.raises(error, match=match):
            engine._get_embedder()
