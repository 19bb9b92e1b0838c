"""The port's training path (video_quierer_tpu_torch/train/trainer.py, the
gradient of ``ops/attention.py``) against the JAX package's, on the CPU,
at the tiny widths (``tests/torch_parity.py`` TINY: 2 layers of 128, heads
of 64; SigLIP's tiny config of ``tests/test_torch_siglip.py``), with the
JAX package's Pallas attention in interpret mode (``VQT_PALLAS_INTERPRET
=1``: its step runs ``_attn``'s ``custom_vjp``, the kernel forward with
the einsum backward). Weights cross with the bridges' ``params_from_jax``;
gradient and moment trees cross the same way. Tolerances:

- B3's gradient against ``jax.vjp`` of ``fused_attention``: f32 atol
  1e-5 (same math, other summation order), bf16 atol 2e-2 for the output
  (as ``tests/test_torch_attention.py``) and 6e-2 for dq, dk, dv (bf16
  rounding of the weights and of each product, at gradients up to ~4);
- the losses: rtol 1e-6 (f32 arithmetic in both);
- the schedules: rtol 1e-6 (f32; ``np.cos`` against XLA's cos);
- one step's loss and every gradient against ``jax.value_and_grad(
  loss_fn)``: CLIP f32 loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6;
  SigLIP f32 the same; CLIP bf16 loss rtol 1e-2 and each gradient's RMS
  error within 10% of its RMS plus 1e-2 (bf16 rounds the towers'
  activations at other points; the key biases' gradient is 0 in exact
  arithmetic and its rounding noise is absolute);
- AdamW with the clip, the warmup-cosine schedule and the EMA against
  optax on identical gradient trees over 5 steps: parameters, moments
  and EMA rtol 1e-5 / atol 1e-7;
- three end-to-end steps, held by their losses only (rtol 1e-4): Adam
  turns near-zero gradient differences into updates of up to ``lr``, so
  parameters after several steps are not compared element by element.
"""

import weakref

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_siglip import tiny_configs
from tests.test_torch_stageprof import spans_on  # noqa: F401  (a fixture)
from tests.torch_parity import (
    TINY,
    jax_init,
    numpy_tree,
    one_torch_thread,
    token_ids,
)
from video_quierer_tpu.models.clip import config as jax_cfg
from video_quierer_tpu.models.clip.model import CLIP as JaxCLIP
from video_quierer_tpu.models.siglip import model as jax_sm
from video_quierer_tpu.ops.attention import fused_attention
from video_quierer_tpu.train import trainer as jax_trainer
from video_quierer_tpu_torch.models.clip import bridge
from video_quierer_tpu_torch.models.clip import config as torch_cfg
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.models.siglip import bridge as siglip_bridge
from video_quierer_tpu_torch.models.siglip import model as sm
from video_quierer_tpu_torch.ops import attention as attn_mod
from video_quierer_tpu_torch.train import trainer

B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VQT_PALLAS_INTERPRET", "1")
        yield


@pytest.fixture(scope="module")
def clip_tiny(interpret):
    jcfg = jax_cfg.get_config(TINY)
    params = jax_init(JaxCLIP(jcfg), 32, 77)
    tcfg = torch_cfg.get_config(TINY)
    return jcfg, tcfg, params, bridge.params_from_jax(numpy_tree(params),
                                                      tcfg)


@pytest.fixture(scope="module")
def siglip_tiny(interpret):
    jcfg, tcfg = tiny_configs()
    params = jax_init(jax_sm.SigLIP(jcfg), 32, 16)
    return jcfg, tcfg, params, siglip_bridge.params_from_jax(
        numpy_tree(params), tcfg)


def clip_batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            token_ids(rng, b, 77, 1000))


def siglip_batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            rng.integers(1, 1000, (b, 16)).astype(np.int32))


def port_grads(model, images, ids):
    loss = trainer.loss_fn(model, torch.from_numpy(images),
                           torch.from_numpy(ids).long())
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return loss.item(), dict(zip(names, grads))


# -- B3 with a gradient -----------------------------------------------------

ATTN_ATOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 6e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,causal", [(77, True), (17, False)])
def test_attention_gradient_matches_jax(interpret, dtype, s, causal):
    """The Function's output and dq, dk, dv against ``jax.vjp`` of
    ``fused_attention`` (the Pallas forward, the einsum VJP)."""
    rng = np.random.default_rng(s)
    q, k, v, g = ((0.5 * rng.standard_normal((2, s, 128)))
                  .astype(np.float32) for _ in range(4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda a, b, c: fused_attention(
        a, b, c, num_heads=2, causal=causal),
        *(jnp.asarray(t, jdt) for t in (q, k, v)))
    want = [out] + list(vjp(jnp.asarray(g, jdt)))
    leaves = [torch.from_numpy(t).to(tdt).requires_grad_()
              for t in (q, k, v)]
    got = attn_mod.attention(*leaves, num_heads=2, causal=causal)
    assert got.grad_fn is not None \
        and type(got.grad_fn).__name__ == "AttentionFunctionBackward"
    got.backward(torch.from_numpy(g).to(tdt))
    out_atol, grad_atol = ATTN_ATOL[dtype]
    for i, (a, w) in enumerate(zip([got] + [t.grad for t in leaves], want)):
        assert a.dtype == tdt
        np.testing.assert_allclose(
            a.detach().float().numpy(), np.asarray(w.astype(jnp.float32)),
            atol=out_atol if i == 0 else grad_atol, rtol=0)


def test_attention_saves_only_qkv_and_serves_without_autograd():
    """The Function saves ``(q, k, v)`` alone; under inference mode, and
    for inputs that need no gradient, no autograd node is made."""
    q, k, v = (torch.randn(2, 17, 128, requires_grad=True)
               for _ in range(3))
    out = attn_mod.attention(q, k, v, num_heads=2)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(a is b for a, b in zip(saved, (q, k, v)))
    with torch.inference_mode():
        assert attn_mod.attention(q, k, v, num_heads=2).grad_fn is None
    with torch.no_grad():
        assert attn_mod.attention(q, k, v, num_heads=2).grad_fn is None
    plain = [t.detach() for t in (q, k, v)]
    assert attn_mod.attention(*plain, num_heads=2).grad_fn is None
    torch.testing.assert_close(out.detach(), attn_mod.attention(
        *plain, num_heads=2), rtol=0, atol=0)


# -- the losses ---------------------------------------------------------------

def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("family", ["clip", "siglip"])
def test_losses_match_jax(family):
    rng = np.random.default_rng(5)
    img, txt = _unit(rng, 16, 64), _unit(rng, 16, 64)
    t = [torch.from_numpy(a) for a in (img, txt)]
    if family == "clip":
        want = jax_trainer.clip_contrastive_loss(img, txt, jnp.float32(14.3))
        got = trainer.clip_contrastive_loss(*t, torch.tensor(14.3))
    else:
        want = jax_sm.siglip_sigmoid_loss(img, txt, jnp.float32(10.0),
                                          jnp.float32(-10.0))
        got = sm.siglip_sigmoid_loss(*t, torch.tensor(10.0),
                                     torch.tensor(-10.0))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# -- the schedules ------------------------------------------------------------

SCHEDULES = {"constant": dict(schedule="constant"),
             "constant-warmup": dict(schedule="constant", warmup_steps=5),
             "cosine": dict(schedule="cosine", warmup_steps=4,
                            total_steps=15),
             "cosine-no-warmup": dict(schedule="cosine", total_steps=12)}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax(name):
    kw = SCHEDULES[name]
    want = jax_trainer.build_lr_schedule(3e-4, **kw)
    got = trainer.build_lr_schedule(3e-4, **kw)
    for count in range(21):
        np.testing.assert_allclose(
            float(got(count)), float(want(jnp.asarray(count, jnp.int32))),
            rtol=1e-6, err_msg=f"count {count}")


def test_schedule_refusals_match_jax():
    for build in (trainer.build_lr_schedule, jax_trainer.build_lr_schedule):
        with pytest.raises(ValueError, match="total_steps"):
            build(1e-3, "cosine", warmup_steps=2)
        with pytest.raises(ValueError, match="unknown schedule"):
            build(1e-3, "linear")


# -- one step against jax.value_and_grad(loss_fn) ---------------------------

def _jax_step(model, params, images, ids):
    f = jax.jit(jax.value_and_grad(jax_trainer.loss_fn), static_argnums=1)
    return f(params, model, jnp.asarray(images), jnp.asarray(ids))


@pytest.mark.parametrize("case", ["clip-float32", "clip-bfloat16",
                                  "siglip-float32"])
def test_step_loss_and_gradients_match_jax(clip_tiny, siglip_tiny, case):
    family, dtype = case.split("-")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if family == "clip":
        jcfg, tcfg, params, sd = clip_tiny
        jmodel, model = JaxCLIP(jcfg, dtype=jdt), CLIP(tcfg, dtype=tdt)
        to_port, (images, ids) = bridge.params_from_jax, clip_batch()
    else:
        jcfg, tcfg, params, sd = siglip_tiny
        jmodel, model = jax_sm.SigLIP(jcfg, dtype=jdt), sm.SigLIP(tcfg,
                                                                  dtype=tdt)
        to_port, (images, ids) = siglip_bridge.params_from_jax, \
            siglip_batch()
    model.load_state_dict(sd)
    jloss, jgrads = _jax_step(jmodel, params, images, ids)
    loss, grads = port_grads(model, images, ids)
    want = to_port(numpy_tree(jgrads), tcfg)
    assert grads.keys() == want.keys()
    if dtype == "float32":
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        for name, g in grads.items():
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        return
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-2)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        w = want[name].numpy().astype(np.float64)
        err = g.numpy().astype(np.float64) - w
        rms = lambda a: np.sqrt(np.mean(a * a))
        assert rms(err) <= 0.1 * rms(w) + 1e-2, name


# -- the optimizer against optax ----------------------------------------------

GRAD_SCALES = (1e-4, 1.0, 1e-3, 2.0, 1e-4)    # the clip acts on 1.0 and 2.0


def test_optimizer_matches_optax_on_identical_gradients(clip_tiny):
    """optax's chain (clip_by_global_norm, adamw over the warmup-cosine
    schedule) plus the JAX trainer's EMA, against the trainer's
    ``apply_gradients``, on the same seeded gradient trees, step by
    step."""
    jcfg, tcfg, params, sd = clip_tiny
    kw = dict(schedule="cosine", warmup_steps=2, total_steps=8)
    max_norm, wd, decay = 50.0, 0.05, 0.9
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adamw(
        jax_trainer.build_lr_schedule(1e-3, **kw), weight_decay=wd))
    opt_state, ema = tx.init(params), jax.tree.map(jnp.copy, params)

    @jax.jit
    def step(grads, opt_state, params, ema):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree.map(lambda e, p: e * decay + p * (1.0 - decay), ema,
                           params)
        return opt_state, params, ema

    port = trainer.CLIPTrainer(tcfg, params=sd, learning_rate=1e-3,
                               weight_decay=wd, max_grad_norm=max_norm,
                               ema_decay=decay, device="cpu", **kw)
    rng = np.random.default_rng(11)
    leaves, treedef = jax.tree.flatten(params)
    clipped = []
    for scale in GRAD_SCALES:
        grads = jax.tree.unflatten(treedef, [jnp.asarray(
            scale * rng.standard_normal(x.shape), jnp.float32)
            for x in leaves])
        clipped.append(float(optax.global_norm(grads)) >= max_norm)
        opt_state, params, ema = step(grads, opt_state, params, ema)
        port.apply_gradients(bridge.params_from_jax(numpy_tree(grads),
                                                    tcfg))
        adam = opt_state[1][0]
        for tree, got in ((params, port.state.params),
                          (adam.mu, port.state.opt_state["mu"]),
                          (adam.nu, port.state.opt_state["nu"]),
                          (ema, port.state.ema_params)):
            want = bridge.params_from_jax(numpy_tree(tree), tcfg)
            for name, t in got.items():
                np.testing.assert_allclose(t.detach().numpy(),
                                           want[name].numpy(), rtol=1e-5,
                                           atol=1e-7, err_msg=name)
    assert clipped == [False, True, False, True, False]
    assert port.state.step == port.state.opt_state["count"] == 5
    assert int(adam.count) == 5


# -- the trainer end to end -----------------------------------------------

def test_three_steps_match_jax_by_their_losses(clip_tiny):
    jcfg, tcfg, params, sd = clip_tiny
    images, ids = clip_batch(1)
    kw = dict(learning_rate=1e-3, max_grad_norm=1.0, ema_decay=0.5)
    # the JAX step donates its state: hand it a copy of the fixture's tree
    ref = jax_trainer.CLIPTrainer(
        jcfg, params=jax.tree.map(jnp.copy, params), **kw)
    port = trainer.CLIPTrainer(tcfg, params=sd, device="cpu", **kw)
    want = [ref.step(images, ids) for _ in range(3)]
    got = [port.step(images, ids) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


STEP_SPANS = ("train.forward", "train.backward", "train.optimizer",
              "train.loss_fetch")


def test_step_spans_log_each_step_and_leave_the_losses(  # noqa: F811
        clip_tiny, spans_on):
    """Each step logs its four spans in order under its step number; the
    losses with spans on equal those with spans off, bit for bit."""
    _, tcfg, _, sd = clip_tiny
    images, ids = clip_batch(3, b=4)
    on = trainer.CLIPTrainer(tcfg, params=sd, device="cpu",
                             learning_rate=1e-3)
    got = [on.step(images, ids) for _ in range(3)]
    evs = [e for e in spans_on.events()[0] if e.name in STEP_SPANS]
    assert [(e.unit, e.name) for e in evs] == [
        (n, name) for n in range(3) for name in STEP_SPANS]
    assert all(e.parent is None for e in evs)
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(evs, evs[1:]))
    spans_on.enable(False)
    off = trainer.CLIPTrainer(tcfg, params=sd, device="cpu",
                              learning_rate=1e-3)
    assert [off.step(images, ids) for _ in range(3)] == got
    assert len(spans_on.events()[0]) == len(evs)


def test_step_frees_its_graph_and_gradients_before_the_loss_fetch(
        clip_tiny, monkeypatch):
    """The step's loss (with its autograd graph) and its gradients are
    released inside ``train.optimizer``: nothing of them is alive when
    ``train.loss_fetch`` opens, so the fetch is the step's last work."""
    _, tcfg, _, sd = clip_tiny
    images, ids = clip_batch(3, b=4)
    tr = trainer.CLIPTrainer(tcfg, params=sd, device="cpu",
                             learning_rate=1e-3)
    refs, alive = [], []
    loss_and_grads, span = tr._loss_and_grads, trainer.span

    def spy(*args):
        loss, grads = loss_and_grads(*args)
        refs.extend(weakref.ref(t) for t in (loss, *grads))
        return loss, grads

    def check(name):
        if name == "train.loss_fetch":
            alive.append(sum(r() is not None for r in refs))
        return span(name)

    monkeypatch.setattr(tr, "_loss_and_grads", spy)
    monkeypatch.setattr(trainer, "span", check)
    loss = tr.step(images, ids)
    assert len(refs) == 1 + len(tr.state.params) and alive == [0]
    assert np.isfinite(loss)


def test_current_lr_and_serving_params(clip_tiny):
    _, tcfg, _, sd = clip_tiny
    images, ids = clip_batch(2, b=4)
    kw = dict(learning_rate=1e-3, schedule="constant", warmup_steps=2,
              device="cpu")
    with_ema = trainer.CLIPTrainer(tcfg, params=sd, ema_decay=0.5, **kw)
    plain = trainer.CLIPTrainer(tcfg, params=sd, **kw)
    assert plain.serving_params is plain.state.params
    assert with_ema.serving_params is with_ema.state.ema_params
    lrs = []
    for _ in range(3):
        lrs.append(with_ema.current_lr())
        with_ema.step(images, ids)
    assert lrs == [0.0, float(np.float32(5e-4)), float(np.float32(1e-3))]
    live = with_ema.state.params
    for name, e in with_ema.serving_params.items():
        assert e is not live[name]
    # the EMA lags the live weights: after 3 steps at decay 0.5 it holds
    # 1/8 of the start and differs from the live tensors
    name = "text.layers.0.mlp.fc1.weight"
    assert not torch.equal(with_ema.serving_params[name], live[name])
    # the trainer copied the state dict it was given: sd is unchanged
    assert torch.equal(plain.state.params[name], sd[name])


def test_remat_gives_equal_gradients(clip_tiny):
    _, tcfg, _, sd = clip_tiny
    images, ids = clip_batch(3, b=4)
    out = []
    for remat in (False, True):
        model = CLIP(tcfg, remat=remat)
        model.load_state_dict(sd)
        out.append(port_grads(model, images, ids))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_compute_dtype_keeps_f32_parameters(clip_tiny):
    """A bf16 tower over f32 parameters: f32 gradients, bf16 activations;
    a module cast whole (the serving form) computes as before."""
    _, tcfg, _, sd = clip_tiny
    model = CLIP(tcfg, dtype=torch.bfloat16)
    model.load_state_dict(sd)
    images, ids = clip_batch(4, b=2)
    feats = model.vision(torch.from_numpy(images))
    assert feats.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    served = CLIP(tcfg)
    served.load_state_dict(sd)
    served = served.to(torch.bfloat16)
    with torch.inference_mode():
        pixels = torch.from_numpy(images).to(torch.bfloat16)
        a = served.encode_image(pixels)
        b = model.encode_image(pixels)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mesh_and_moe_are_refused(clip_tiny):
    """A mesh is no longer refused: ``mesh=`` (a ``DataMesh``) places the
    parameters by the partition rules and steps on the global batch, the
    first loss the one-device trainer's (its parity with JAX's mesh step:
    ``tests/test_torch_train_mesh.py``); a Switch-MoE tower trains on one
    device (its parity: ``tests/test_torch_moe.py``)."""
    import dataclasses
    from video_quierer_tpu_torch.parallel.mesh import ShardedTree, data_mesh
    _, tcfg, _, sd = clip_tiny
    images, ids = clip_batch(7, b=4)
    mesh = data_mesh(devices=["cpu"] * 4, model_parallel=2)
    on_mesh = trainer.CLIPTrainer(tcfg, params=sd, mesh=mesh, device="cpu")
    assert isinstance(on_mesh.state.params, ShardedTree)
    assert len(on_mesh.state.params.parts(
        "text.layers.0.mlp.fc1.weight")) == 2
    one = trainer.CLIPTrainer(tcfg, params=sd, device="cpu")
    np.testing.assert_allclose(on_mesh.step(images, ids),
                               one.step(images, ids), rtol=1e-5)
    moe = dataclasses.replace(tcfg, vision=dataclasses.replace(
        tcfg.vision, moe_experts=4))
    tr = trainer.CLIPTrainer(moe, device="cpu")
    assert trainer.is_moe(tr.model) and not trainer.is_moe(
        CLIP(tcfg))
    assert "vision.layers.1.moe.w1" in tr.state.params


def test_siglip_trainer_steps(siglip_tiny):
    """A built SigLIP module trains through the same trainer (four
    outputs: the sigmoid loss), its scale and bias among the updated
    parameters."""
    _, tcfg, _, sd = siglip_tiny
    port = trainer.CLIPTrainer(model=sm.SigLIP(tcfg), params=sd,
                               learning_rate=1e-3, device="cpu")
    images, ids = siglip_batch(2, b=4)
    losses = [port.step(images, ids) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for name in ("logit_scale", "logit_bias"):
        assert port.state.params[name].item() != sd[name].item()
