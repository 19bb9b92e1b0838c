"""The port's Switch-MoE towers (video_quierer_tpu_torch/parallel/moe.py,
the MoE vision tower of models/clip/model.py, the trainer's aux loss, the
finetune CLI's MoE flags) against the JAX package's, on the CPU.

The same numpy-seeded inputs go through both packages; weights cross with
``bridge.params_from_jax``. The JAX side's attention (kernel B3) runs in
interpret mode (``VQT_PALLAS_INTERPRET=1``) in the block's test and
through its plain einsum reference elsewhere (as the JAX package's own
MoE tests run on the CPU; interpreting it under ``jax.grad`` takes ~30 s).
Tolerances:

- the layer, f32: the same expert and the same kept mask for every token,
  the output within rtol 1e-5 / atol 1e-6 (dropped tokens exactly 0 in
  both), aux within 1e-6; bf16: the same experts, the output within
  atol 3e-2 (bf16 rounding of the expert products at outputs up to ~2);
- the block and the tower, f32: rows at cosine >= 1 - 1e-5;
- the loss rtol 1e-5, every gradient within atol 1e-5 (rtol 1e-5);
- the engine: the same rows (names, timestamps, frame ids), embeddings at
  cosine >= 1 - 1e-5, search rows the same frames in the same order with
  scores within rtol 1e-5 and atol 1e-6 (near-zero scores carry the
  towers' f32 rounding, ~1e-7).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_synthetic_video
from tests.torch_parity import (
    TINY_FULL_VOCAB,
    TINY_MOE,
    TINY_MOE_224,
    TINY_MOE_VOCAB,
    jax_init,
    numpy_tree,
    one_torch_thread,
    port_state_dict,
    row_cosine,
    token_ids,
)
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.models.clip import config as jax_cfg
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxEmbedder
from video_quierer_tpu.models.clip.embedder import \
    MemoizedEmbedder as JaxMemo
from video_quierer_tpu.models.clip.model import CLIP as JaxCLIP
from video_quierer_tpu.parallel import moe as jax_moe
from video_quierer_tpu.train import trainer as jax_trainer
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.models.clip import bridge
from video_quierer_tpu_torch.models.clip import config as torch_cfg
from video_quierer_tpu_torch.models.clip.embedder import (
    CLIPEmbedder,
    MemoizedEmbedder,
)
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.parallel import moe
from video_quierer_tpu_torch.train import checkpoint as ckpt_mod
from video_quierer_tpu_torch.train import finetune, trainer

MIN_COS = 1 - 1e-5
D, E = 128, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VQT_PALLAS_INTERPRET", "1")
        yield


def _layer_sd(p) -> dict:
    p = numpy_tree(p)
    sd = {"router.weight": torch.tensor(p["router"]["kernel"]).t(),
          "router.bias": torch.tensor(p["router"]["bias"])}
    for k in moe.EXPERT_STACKS:
        sd[k] = torch.tensor(p[k])
    return sd


def _jax_routing(p, x, cap):
    """JAX ``moe.py:66-85``'s expert and kept mask, on its parameters."""
    xt = jnp.asarray(x, jnp.float32).reshape(-1, x.shape[-1])
    logits = xt @ p["router"]["kernel"] + p["router"]["bias"]
    probs = jax.nn.softmax(logits, axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    assign = jax.nn.one_hot(expert, probs.shape[-1], dtype=jnp.float32)
    pos = jnp.cumsum(assign, axis=0) - assign
    keep = jnp.sum(assign * (pos < cap), axis=-1) > 0
    return np.asarray(expert), np.asarray(keep)


def _layer_pair(capacity_factor, seed=0, b=4, s=17):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    jm = jax_moe.SwitchMoEMLP(E, ratio=4, capacity_factor=capacity_factor)
    p = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    tm = moe.SwitchMoEMLP(D, E, ratio=4, capacity_factor=capacity_factor)
    tm.load_state_dict(_layer_sd(p))
    return x, jm, p, tm


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 4.0])
def test_switch_moe_layer_matches_jax(capacity_factor):
    """Routing, capacity (0.5 drops about half the tokens), output, aux."""
    x, jm, p, tm = _layer_pair(capacity_factor)
    want, want_aux = jm.apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        got, got_aux = tm(torch.from_numpy(x))
    n = x.shape[0] * x.shape[1]
    cap = moe.capacity(n, E, capacity_factor)
    assert cap == max(1, int(np.ceil(capacity_factor * n / E)))
    expert, keep = _jax_routing(p, x, cap)
    with torch.no_grad():
        probs = torch.softmax(tm.router(torch.from_numpy(x).reshape(n, D)),
                              dim=-1)
    _, t_expert, _, t_keep = moe.route(probs, cap)
    np.testing.assert_array_equal(t_expert.numpy(), expert)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    if capacity_factor < 1:
        assert (~keep).sum() >= n // 3
    want, got = np.asarray(want), got.numpy()
    dropped = ~keep.reshape(x.shape[:2])
    assert not np.any(got[dropped]) and not np.any(want[dropped])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


def test_switch_moe_layer_bf16():
    x, jm, p, tm = _layer_pair(1.25, seed=1)
    jb = jax_moe.SwitchMoEMLP(E, ratio=4, dtype=jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, want_aux = jb.apply({"params": p}, xb)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        got, got_aux = tm(xt)
    assert got.dtype == torch.bfloat16
    n = x.shape[0] * x.shape[1]
    expert, _ = _jax_routing(p, np.asarray(xb.astype(jnp.float32)), 1)
    with torch.no_grad():
        probs = torch.softmax(tm.router(xt.reshape(n, D).float()), dim=-1)
    np.testing.assert_array_equal(moe.route(probs, 1)[1].numpy(), expert)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=0)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-5


def test_dense_dispatch_is_not_materialised():
    """The dispatch is an index gather: no saved tensor of the forward
    has both a token axis and a slot axis, as the dense [N, E, C] mask
    has."""
    x, _, _, tm = _layer_pair(1.25, b=64)
    n = x.shape[0] * x.shape[1]
    cap = moe.capacity(n, E, 1.25)
    assert (n, cap) == (1088, 340)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tm(torch.from_numpy(x).requires_grad_())
    assert shapes and not any(n in s and cap in s for s in shapes), shapes


def test_expert_partition_spec():
    w1 = torch.zeros(E, 8, 32)
    assert moe.expert_partition_spec("vision.layers.1.moe.w1", w1) == \
        (moe.EXPERT_AXIS, None, None)
    assert moe.expert_partition_spec(("moe", "b2"), torch.zeros(E, 8)) == \
        (moe.EXPERT_AXIS, None)
    assert moe.expert_partition_spec("vision.layers.1.moe.router.weight",
                                     torch.zeros(E, 8)) == ()
    spec = jax_moe.expert_partition_spec(
        (jax.tree_util.DictKey("w1"),), jnp.zeros((E, 8, 32)))
    assert tuple(spec) == moe.expert_partition_spec("w1", w1)


# -- the block and the tower ------------------------------------------------

@pytest.fixture(scope="module")
def moe_tiny():
    jcfg = jax_cfg.get_config(TINY_MOE)
    params = jax_init(JaxCLIP(jcfg), 32, 77)
    return jcfg, torch_cfg.get_config(TINY_MOE), params, port_state_dict(
        params, TINY_MOE)


def test_moe_block_matches_jax(interpret):
    from video_quierer_tpu_torch.models.clip.config import CLIPVisionConfig
    c = CLIPVisionConfig(hidden_size=D, num_heads=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 17, D)).astype(np.float32)
    jb = jax_moe.MoEEncoderBlock(2, E, 4, c.layer_norm_eps)
    p = numpy_tree(jb.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want, want_aux = jb.apply({"params": p}, jnp.asarray(x))
    block = moe.MoEEncoderBlock(c, E)
    sd = bridge._blocks_from_jax({"layers_0": p}, "b", 1)
    block.load_state_dict({k[len("b.layers.0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got, got_aux = block(torch.from_numpy(x))
    assert row_cosine(got.numpy().reshape(-1, D),
                      np.asarray(want).reshape(-1, D)).min() >= MIN_COS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


def test_moe_tower_layout_and_bridge(moe_tiny):
    """Layers 1 and 3 are MoE blocks; the bridged tree loads strictly; the
    seeded init loads strictly with flax's expert-stack fan-in."""
    _, tcfg, params, sd = moe_tiny
    model = CLIP(tcfg)
    kinds = [type(layer).__name__ for layer in model.vision.layers]
    assert kinds == ["EncoderBlock", "MoEEncoderBlock"] * 2
    model.load_state_dict(sd)
    assert sd["vision.layers.1.moe.w1"].shape == (E, D, 4 * D)
    np.testing.assert_array_equal(
        sd["vision.layers.3.moe.router.weight"].numpy(),
        np.asarray(params["vision"]["encoder"]["layers_3"]["moe"]["router"]
                   ["kernel"]).T)
    seeded = bridge.init_params(tcfg, torch.Generator().manual_seed(0))
    CLIP(tcfg).load_state_dict(seeded)
    for name, fan_in in (("w1", E * D), ("w2", E * 4 * D)):
        want = 1 / np.sqrt(fan_in)
        for tree in (seeded[f"vision.layers.1.moe.{name}"].numpy(),
                     np.asarray(params["vision"]["encoder"]["layers_1"]
                                ["moe"][name])):
            assert abs(tree.std() / want - 1) < 0.02
    assert not seeded["vision.layers.1.moe.b1"].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_tower_rows_match_jax(moe_tiny, dtype):
    jcfg, tcfg, params, sd = moe_tiny
    rng = np.random.default_rng(3)
    images = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda a: a.astype(jdt), params)
    jmodel = JaxCLIP(jcfg, dtype=jdt)
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, method=JaxCLIP.encode_image))(
        jp, jnp.asarray(images, jdt)))
    model = CLIP(tcfg)
    model.load_state_dict(sd)
    model = model.to(tdt).eval()
    aux = []
    with torch.inference_mode():
        got = model.encode_image(torch.from_numpy(images).to(tdt),
                                 aux=aux).numpy()
    assert len(aux) == 2
    cos = row_cosine(got, want).min()
    assert cos >= (MIN_COS if dtype == "float32" else 0.999), cos


# -- training ---------------------------------------------------------------

def _batch(seed=0, b=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            token_ids(rng, b, 77, 1000))


def test_moe_loss_and_gradients_match_jax(moe_tiny):
    jcfg, tcfg, params, sd = moe_tiny
    images, ids = _batch()
    jmodel = JaxCLIP(jcfg)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p, x, t: jax_trainer.loss_fn(p, jmodel, x, t)))(
        params, jnp.asarray(images), jnp.asarray(ids))
    model = CLIP(tcfg)
    model.load_state_dict(sd)
    model.train()
    assert trainer.is_moe(model)
    loss = trainer.loss_fn(model, torch.from_numpy(images),
                           torch.from_numpy(ids).long())
    # the aux term is there: the loss without it differs by 0.01 · Σ aux
    aux = []
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(ids).long(),
                    aux=aux)
        plain = trainer.clip_contrastive_loss(*out)
    assert len(aux) == 2
    np.testing.assert_allclose(
        float(loss.detach()) - float(plain),
        trainer.MOE_AUX_WEIGHT * float(sum(aux)), rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    want_g = bridge.params_from_jax(numpy_tree(jgrads), tcfg)
    assert set(want_g) == set(names)
    for name, g in zip(names, grads):
        if name == "logit_scale":
            want_v = np.asarray(jgrads["logit_scale"])
        else:
            want_v = want_g[name].numpy()
        np.testing.assert_allclose(g.numpy(), want_v, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_moe_trainer_steps_and_remat(moe_tiny):
    _, tcfg, _, sd = moe_tiny
    images, ids = _batch(1)
    tr = trainer.CLIPTrainer(tcfg, learning_rate=1e-3, params=sd,
                             device="cpu")
    losses = [tr.step(images, ids) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    model = CLIP(tcfg, remat=True)
    model.load_state_dict(sd)
    plain = CLIP(tcfg)
    plain.load_state_dict(sd)
    x, i = torch.from_numpy(images), torch.from_numpy(ids).long()
    a = trainer.loss_fn(model, x, i)
    b = trainer.loss_fn(plain, x, i)
    ga = torch.autograd.grad(a, list(model.parameters()))
    gb = torch.autograd.grad(b, list(plain.parameters()))
    assert float(a) == float(b)
    for u, v in zip(ga, gb):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_moe_checkpoint_round_trip(moe_tiny, tmp_path):
    _, tcfg, _, sd = moe_tiny
    tr = trainer.CLIPTrainer(tcfg, learning_rate=1e-3, params=sd,
                             ema_decay=0.9, device="cpu")
    tr.step(*_batch(2))
    path = ckpt_mod.save_checkpoint(tmp_path / "ck", tr, 1)
    fresh = trainer.CLIPTrainer(tcfg, ema_decay=0.9, seed=5, device="cpu")
    ckpt_mod.restore_checkpoint(tmp_path / "ck", fresh)
    assert fresh.state.step == 1
    for name in ("params", "ema_params"):
        a, b = getattr(tr.state, name), getattr(fresh.state, name)
        assert a.keys() == b.keys() and any("moe.w1" in k for k in a)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in tr.state.opt_state["mu"]:
        assert torch.equal(tr.state.opt_state["mu"][k],
                           fresh.state.opt_state["mu"][k])
        assert torch.equal(tr.state.opt_state["nu"][k],
                           fresh.state.opt_state["nu"][k])
    loaded = ckpt_mod.load_params(path)
    assert all(torch.equal(loaded[k], tr.state.params[k]) for k in loaded)


def test_finetune_cli_moe_to_serving(tmp_path):
    """``--moe-experts 4`` on a dense config at ``--ep 1`` trains on the
    CPU and writes a checkpoint that ``CLIPEmbedder(model_name=<the MoE
    config>, orbax_checkpoint=...)`` serves as unit rows (JAX
    ``tests/test_moe_tower.py:89-113``)."""
    vids = tmp_path / "videos"
    vids.mkdir()
    make_synthetic_video(vids / "a.mp4", n_frames=40, scene_every=10)
    out = tmp_path / "ckpt"
    rc = finetune.main([
        "--videos-dir", str(vids), "--out", str(out), "--model",
        TINY_FULL_VOCAB,
        "--moe-experts", "4", "--batch", "8", "--max-frames-per-video",
        "16", "--lr", "1e-3", "--device", "cpu"])
    assert rc == 0
    step = sorted(p for p in out.iterdir() if p.name.startswith("step_"))
    assert step
    params = ckpt_mod.load_params(step[-1])
    assert params["vision.layers.1.moe.w1"].shape == (E, D, 4 * D)
    emb = CLIPEmbedder(model_name=TINY_MOE_VOCAB, orbax_checkpoint=step[-1],
                       dtype=torch.float32, device="cpu")
    assert emb.pretrained and not emb._fused_vision
    frames = np.random.default_rng(1).integers(0, 255, (4, 32, 32, 3),
                                               np.uint8)
    feats = emb.embed_frames(frames)
    assert feats.shape == (4, 64)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0,
                               atol=1e-5)
    # the trained weights are served, not a seeded init
    model = CLIP(torch_cfg.get_config(TINY_MOE_VOCAB))
    model.load_state_dict(params)
    assert torch.equal(emb.params.vision.layers[1].moe.w1,
                       model.vision.layers[1].moe.w1)


def test_finetune_cli_moe_refusals(tmp_path):
    """JAX ``finetune.py:109-120``'s refusals; then ``--ep 4`` over 8
    experts builds its ``(data, expert)`` mesh and runs up to the missing
    videos (the mesh's run: ``tests/test_torch_moe_mesh.py``)."""
    base = ["--videos-dir", str(tmp_path), "--out", str(tmp_path / "o"),
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="dense tree"):
        finetune.main(base + ["--moe-experts", "4", "--hf-checkpoint",
                              str(tmp_path)])
    with pytest.raises(SystemExit, match="divide evenly"):
        finetune.main(base + ["--moe-experts", "6", "--ep", "4"])
    with pytest.raises(SystemExit, match="no videos"):
        finetune.main(base + ["--moe-experts", "8", "--ep", "4", "--model",
                              TINY_FULL_VOCAB])


# -- the engine -------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_engines_towers():
    jemb = JaxEmbedder(TINY_MOE_224, dtype=jnp.float32, seed=4)
    pemb = CLIPEmbedder(TINY_MOE_224, dtype=torch.float32, device="cpu",
                        state_dict=port_state_dict(jemb.params,
                                                   TINY_MOE_224))
    return jemb, pemb


def _engine_cfg(mod, d):
    cfg = mod.EngineConfig(videos_dir=str(d),
                           api=mod.ApiConfig(max_frames=12))
    cfg.index.embed_dim = 64
    cfg.model.dtype = "float32"
    cfg.ingest.batch_size = 16
    cfg.ingest.stream_mirror = False
    return cfg


def test_moe_engine_rows_match_jax(tmp_path, moe_engines_towers):
    """Ingest through the frame memo (a rebuild after a new video: some
    frames of a batch hit, the rest pad a smaller bucket), then text
    searches: the same rows in both engines."""
    jemb, pemb = moe_engines_towers
    src = tmp_path / "src"
    src.mkdir()
    vids = [make_synthetic_video(src / f"v{i}.mp4", n_frames=36,
                                 scene_every=6 + 3 * i, seed=i)
            for i in range(2)]
    engines = []
    for name, mod, eng_cls, memo, emb in (
            ("jax", jax_config, JaxEngine, JaxMemo, jemb),
            ("port", torch_config, VideoSearchEngine, MemoizedEmbedder,
             pemb)):
        d = tmp_path / name
        d.mkdir()
        shutil.copy2(vids[0], d / vids[0].name)
        kw = {} if name == "jax" else {"device": "cpu"}
        eng = eng_cls(d, config=_engine_cfg(mod, d), embedder=memo(emb),
                      **kw)
        eng.startup()
        shutil.copy2(vids[1], d / vids[1].name)
        eng.rebuild()
        engines.append(eng)
    jeng, peng = engines
    assert peng._embedder.hits == jeng._embedder.hits > 0
    assert peng._embedder.misses == jeng._embedder.misses
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


def test_moe_rows_depend_on_the_padded_bucket(moe_engines_towers):
    """Capacity counts every token of the padded bucket, so one frame's
    row can change with the rest of its batch; the port pads as the JAX
    embedder does, so both agree in every case."""
    jemb, pemb = moe_engines_towers
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (40, 224, 224, 3), np.uint8)
    for batch in (frames[:5], frames, frames[:33]):
        w, g = jemb.embed_frames(batch), pemb.embed_frames(batch)
        assert row_cosine(g, w).min() >= MIN_COS
    alone = pemb.embed_frames(frames[:1])[0]
    assert alone.shape == (64,)


def test_moe_config_keeps_the_module_tower():
    cfg = torch_cfg.get_config(TINY_MOE_224)
    assert cfg.vision.moe_experts == E
    from video_quierer_tpu_torch.ops import fused_layer
    assert not fused_layer.fused_vision_tower_eligible(cfg.vision)
