"""The port's pipelined image tower (video_quierer_tpu_torch/parallel/
pipeline.py, ``model.parallel = "pp"``) against the JAX package's GPipe
over a ``pipe`` mesh of the 8 virtual CPU devices, on the CPU.

- ``pipelined_encode_image`` over S = 1, 2, 4 stages (the port's on
  ``["cpu"] * S``, JAX's on S CPU devices) and M = 1, 2, 4 microbatches:
  f32 rows at cosine >= 1 - 1e-5, within atol 1e-5;
- ``pipeline_blocks``' output and gradients (parameters and input)
  against the sequential blocks' within atol 1e-5; the port runs ``M ·
  L`` block calls a batch (JAX ``(M + S - 1) · L``);
- the errors: ``B % M`` and ``L % S`` raise ``ValueError`` in both
  packages; a Switch-MoE tower under ``pp`` fails in both (the port at
  construction, with a ``ValueError`` that says why);
- the engine with ``model.parallel = "pp"``: the same rows as the JAX
  ``pp`` engine (names, timestamps, frame ids), its search rows the same
  frames in the same order with scores within rtol 1e-5 and atol 1e-6
  (scores near 0.01 differ by ~1e-7: the towers' f32 rounding, as the
  rows' cosine 1 - 1e-6 shows).

The JAX side's attention runs through its plain einsum reference (as its
own pipeline tests run on the CPU).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.helpers import make_synthetic_video
from tests.torch_parity import (
    TINY_MOE_224,
    TINY_PP_224,
    one_torch_thread,
    port_state_dict,
    row_cosine,
)
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxEmbedder
from video_quierer_tpu.models.clip.model import EncoderBlock as JaxBlock
from video_quierer_tpu.parallel import pipeline as jax_pipeline
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.models.clip import config as torch_cfg
from video_quierer_tpu_torch.models.clip import embedder as emb_mod
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
from video_quierer_tpu_torch.models.clip.model import CLIP, EncoderBlock
from video_quierer_tpu_torch.parallel import mesh as mesh_mod
from video_quierer_tpu_torch.parallel import pipeline

MIN_COS = 1 - 1e-5
B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def tower():
    """(JAX ``pp`` embedder on TINY_PP_224, the port's CLIP on its
    weights)."""
    jemb = JaxEmbedder(TINY_PP_224, dtype=jnp.float32, seed=6,
                       parallel="pp")
    model = CLIP(torch_cfg.get_config(TINY_PP_224))
    model.load_state_dict(port_state_dict(jemb.params, TINY_PP_224))
    return jemb, model.eval()


def _pixels(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 224, 224, 3)).astype(np.float32)


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_pipelined_encode_image_matches_jax(tower, s, m):
    jemb, model = tower
    pixels = _pixels()
    mesh = Mesh(np.array(jax.devices()[:s]), (jax_pipeline.PIPE_AXIS,))
    want = np.asarray(jax.jit(lambda p, x: jax_pipeline.pipelined_encode_image(
        jemb.model, p, x, mesh=mesh, n_microbatches=m))(
        jemb.params, jnp.asarray(pixels)))
    stages = pipeline.shard_layers(model.vision.layers, ["cpu"] * s)
    assert [len(st.layers) for st in stages] == [4 // s] * s
    with torch.inference_mode():
        got = pipeline.pipelined_encode_image(
            model, torch.from_numpy(pixels), stages=stages,
            n_microbatches=m).numpy()
    assert got.dtype == np.float32 and got.shape == (B, 64)
    assert row_cosine(got, want).min() >= MIN_COS
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the sequential module tower: the same rows up to the LayerNorms'
    # variance form
    with torch.inference_mode():
        seq = model.encode_image(torch.from_numpy(pixels)).numpy()
    assert row_cosine(got, seq).min() >= MIN_COS


def _blocks(n_layers=4, d=128, seed=0):
    c = torch_cfg.get_config(TINY_PP_224).vision
    gen = torch.Generator().manual_seed(seed)
    blocks = []
    for _ in range(n_layers):
        blk = EncoderBlock(c, causal=False)
        for p in blk.parameters():
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        blocks.append(blk)
    return blocks


@pytest.mark.parametrize("s,m", [(1, 1), (2, 4), (4, 2), (4, 4)])
def test_pipeline_blocks_gradients_match_sequential(s, m):
    blocks = _blocks()
    x = torch.randn(B, 17, 128, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    calls = []

    def apply(p, a):
        calls.append(1)
        return torch.func.functional_call(blocks[0], p, (a,))

    stacked = pipeline.stack_layer_params(blocks)
    assert stacked["attn.q_proj.weight"].shape == (4, 128, 128)
    layers = pipeline.unstack_layer_params(stacked, 4)
    assert all(torch.equal(layers[i]["mlp.fc1.bias"], blocks[i].mlp.fc1.bias)
               for i in range(4))
    stages = pipeline.shard_layers(layers, ["cpu"] * s)
    out = pipeline.pipeline_blocks(apply, stages, x, m)
    assert len(calls) == m * 4          # JAX: (m + s - 1) * 4
    seq = x
    for blk in blocks:
        seq = blk(seq)
    torch.testing.assert_close(out, seq, atol=1e-5, rtol=0)
    params = [p for blk in blocks for p in blk.parameters()] + [x]
    g_pipe = torch.autograd.grad(out.square().sum(), params)
    g_seq = torch.autograd.grad(seq.square().sum(), params)
    for a, b in zip(g_pipe, g_seq):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_pipeline_errors_match_jax():
    blocks = _blocks(n_layers=3)
    layers = pipeline.unstack_layer_params(
        pipeline.stack_layer_params(blocks), 3)
    for each in (blocks, layers):
        with pytest.raises(ValueError, match="not divisible into 2"):
            pipeline.shard_layers(each, ["cpu"] * 2)
    stages = pipeline.shard_layers(blocks, ["cpu"])
    with pytest.raises(ValueError, match="batch 3 not divisible by M=2"):
        pipeline.pipeline_blocks(pipeline.call_layer, stages,
                                 torch.zeros(3, 5, 128), 2)
    # JAX: the same two cases raise ValueError
    jb = JaxBlock(2, 4, 1e-5)
    lp = {f"layers_{i}": jb.init(jax.random.PRNGKey(i),
                                 jnp.zeros((1, 5, 32)))["params"]
          for i in range(3)}
    st = jax_pipeline.stack_layer_params(lp, 3)
    mesh = Mesh(np.array(jax.devices()[:2]), (jax_pipeline.PIPE_AXIS,))
    run = lambda x, m: jax_pipeline.pipeline_blocks(
        lambda p, a: jb.apply({"params": p}, a), st, x, mesh=mesh,
        n_microbatches=m)
    with pytest.raises(ValueError, match="divisible"):
        run(jnp.zeros((4, 5, 32)), 2)
    with pytest.raises(ValueError, match="batch 3 not divisible by M=2"):
        run(jnp.zeros((3, 5, 32)), 2)


def test_moe_tower_is_refused_under_pp():
    """A Switch-MoE tree cannot go through the dense pipelined block: the
    JAX embedder fails at its first encode (its layers do not stack), the
    port's at construction with a ValueError that says why."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (4, 224, 224, 3), np.uint8)
    jemb = JaxEmbedder(TINY_MOE_224, dtype=jnp.float32, parallel="pp")
    with pytest.raises((ValueError, TypeError)):
        jemb.embed_frames(frames)
    with pytest.raises(ValueError, match="Switch-MoE"):
        CLIPEmbedder(TINY_MOE_224, dtype=torch.float32, device="cpu",
                     parallel="pp")
    with pytest.raises(ValueError, match="unknown parallel mode"):
        CLIPEmbedder(TINY_PP_224, device="cpu", parallel="tp")
    model = CLIP(torch_cfg.get_config(TINY_MOE_224))
    with pytest.raises(ValueError, match="differ from layer 0"):
        pipeline.stack_layer_params(model.vision.layers)


def test_pipe_devices():
    devs = mesh_mod.pipe_devices(devices=["cpu"] * 8, depth=12)
    assert devs == (torch.device("cpu"),) * 6
    assert len(mesh_mod.pipe_devices(devices=["cpu"] * 8, depth=24)) == 8
    assert len(mesh_mod.pipe_devices(4, devices=["cpu"] * 8)) == 4
    assert len(mesh_mod.pipe_devices(devices=["cpu"], depth=12)) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh_mod.pipe_devices(depth=12)


def test_embedder_pp_routes_through_the_pipeline(tower, monkeypatch):
    jemb, _ = tower
    sd = port_state_dict(jemb.params, TINY_PP_224)
    emb = CLIPEmbedder(TINY_PP_224, dtype=torch.float32, device="cpu",
                       state_dict=sd, parallel="pp", pipeline_microbatches=2,
                       pipe_devices=["cpu"] * 4)
    assert not emb._fused_vision and len(emb._pipe_stages) == 4
    seen = []
    real = emb_mod.pipelined_encode_image

    def spy(*a, **kw):
        seen.append(kw["n_microbatches"])
        return real(*a, **kw)

    monkeypatch.setattr(emb_mod, "pipelined_encode_image", spy)
    frames = np.random.default_rng(2).integers(0, 255, (260, 224, 224, 3),
                                               np.uint8)
    got = emb.embed_frames(frames)
    assert seen == [2, 2]               # chunks 256 and 4 (bucket 32)
    want = jemb.embed_frames(frames)
    assert row_cosine(got, want).min() >= MIN_COS
    # the default pipe on a CPU embedder: one stage
    one = CLIPEmbedder(TINY_PP_224, dtype=torch.float32, device="cpu",
                       state_dict=sd, parallel="pp")
    assert len(one._pipe_stages) == 1


def test_engine_passes_parallel_through(tmp_path, monkeypatch):
    built = []
    monkeypatch.setattr(emb_mod, "CLIPEmbedder",
                        lambda **kw: built.append(kw) or "clip")
    cfg = torch_config.EngineConfig(videos_dir=str(tmp_path))
    cfg.model.parallel = "pp"
    cfg.model.pipeline_microbatches = 8
    engine = VideoSearchEngine(tmp_path, config=cfg, device="cpu")
    assert engine._get_embedder() == "clip"
    assert built[0]["parallel"] == "pp"
    assert built[0]["pipeline_microbatches"] == 8


def _engine_cfg(mod, d):
    cfg = mod.EngineConfig(videos_dir=str(d),
                           api=mod.ApiConfig(max_frames=12))
    cfg.index.embed_dim = 64
    cfg.model.dtype = "float32"
    cfg.model.parallel = "pp"
    cfg.model.pipeline_microbatches = 4
    cfg.model.name = TINY_PP_224
    cfg.ingest.batch_size = 16
    return cfg


def test_pp_engine_rows_match_jax(tmp_path, tower, monkeypatch):
    """The JAX engine over its ``pp`` embedder (4 stages over the CPU
    devices), the port's engine building its own ``pp`` tower (one stage
    on the CPU) on the same weights."""
    jemb, _ = tower
    sd = port_state_dict(jemb.params, TINY_PP_224)
    real = emb_mod.CLIPEmbedder
    monkeypatch.setattr(emb_mod, "CLIPEmbedder",
                        lambda **kw: real(state_dict=sd, **kw))
    src = tmp_path / "src"
    src.mkdir()
    vids = [make_synthetic_video(src / f"v{i}.mp4", n_frames=36,
                                 scene_every=6 + 3 * i, seed=i)
            for i in range(2)]
    engines = []
    for name, mod in (("jax", jax_config), ("port", torch_config)):
        d = tmp_path / name
        d.mkdir()
        for v in vids:
            shutil.copy2(v, d / v.name)
        cfg = _engine_cfg(mod, d)
        if name == "jax":
            eng = JaxEngine(d, config=cfg, embedder=jemb)
            assert jemb._pipe_mesh.shape[jax_pipeline.PIPE_AXIS] == 4
        else:
            eng = VideoSearchEngine(d, config=cfg, device="cpu")
            assert eng._get_embedder()._pipe_stages is not None
        eng.startup()
        engines.append(eng)
    jeng, peng = engines
    want, got = jeng.index.to_cache_dict(), peng.index.to_cache_dict()
    assert len(got["metadata"]) == 24 and got["metadata"] == \
        want["metadata"]
    w, g = np.stack(want["embeddings"]), np.stack(got["embeddings"])
    assert row_cosine(g, w).min() >= MIN_COS
    for q in ("a red square", "moving shapes at night"):
        rows_p = peng.search_ex(q, k=10, use_cache=False)[0]
        rows_j = jeng.search_ex(q, k=10, use_cache=False)[0]
        assert [(r["video_name"], r["frame_id"]) for r in rows_p] == \
            [(r["video_name"], r["frame_id"]) for r in rows_j]
        np.testing.assert_allclose([r["score"] for r in rows_p],
                                   [r["score"] for r in rows_j], rtol=1e-5,
                                   atol=1e-6)
    assert peng.metrics.counter("embed_fallbacks") == 0
    assert jeng.metrics.counter("embed_fallbacks") == 0
