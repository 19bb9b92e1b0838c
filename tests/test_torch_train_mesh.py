"""The port's training meshes (video_quierer_tpu_torch/train/trainer.py
with ``mesh=``, ``parallel/mesh.py:DataMesh``/``ShardedTree``,
``parallel/moe.py:SwitchMoEMLP.mesh_forward``, ``train/finetune.py:
build_mesh``) against the JAX package's mesh step on the CPU.

The port's mesh is one process over ``["cpu"] * 8`` (devices may repeat),
the JAX mesh the 8 virtual CPU devices of ``tests/conftest.py``; the
same numpy-seeded batches and the same ``params_from_jax`` weights go
through both. The JAX side's attention runs through its plain einsum
reference (as the JAX package's own mesh tests run on the CPU), and in
interpret mode (``VQT_PALLAS_INTERPRET=1``) in one case: interpreting it
under ``jax.grad`` on a mesh takes ~10 s a step. The Switch-MoE tower's
mesh tests are ``tests/test_torch_moe_mesh.py``. Tolerances, as the
one-device tests' (``tests/test_torch_train.py``):

- one step's loss and every gradient against ``jax.value_and_grad`` of
  the JAX loss on the JAX mesh (sharded params, the batch split over
  ``data``): f32 loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6; bf16
  loss rtol 1e-2 and each gradient's RMS error within 10% of its RMS
  plus 1e-2;
- three steps by their losses, rtol 1e-4;
- the optimizer on identical gradient trees, with the clip and the EMA:
  parameters, moments and EMA rtol 1e-5 / atol 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.helpers import make_synthetic_video
from tests.test_torch_siglip import tiny_configs
from tests.torch_parity import (
    TINY,
    TINY_224_FULL_VOCAB,
    TINY_MOE,
    jax_init,
    numpy_tree,
    one_torch_thread,
    token_ids,
)
from video_quierer_tpu.models.clip import config as jax_cfg
from video_quierer_tpu.models.clip.model import CLIP as JaxCLIP
from video_quierer_tpu.models.siglip import model as jax_sm
from video_quierer_tpu.parallel import mesh as jax_mesh
from video_quierer_tpu.train import finetune as jax_finetune
from video_quierer_tpu.train import trainer as jax_trainer
from video_quierer_tpu_torch.models.clip import bridge
from video_quierer_tpu_torch.models.clip import config as torch_cfg
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.models.siglip import bridge as siglip_bridge
from video_quierer_tpu_torch.models.siglip import model as sm
from video_quierer_tpu_torch.parallel import mesh as port_mesh
from video_quierer_tpu_torch.train import checkpoint as ckpt
from video_quierer_tpu_torch.train import finetune, trainer

B = 8
# TINY's widths with 4 heads of 32 in both towers: a (data 2, model 4)
# grid splits them one a part
TINY_4H = "torch-parity-tiny-4h"


def _tiny_4h():
    c = jax_cfg.get_config(TINY)
    return dataclasses.replace(
        c, name=TINY_4H,
        vision=dataclasses.replace(c.vision, num_heads=4),
        text=dataclasses.replace(c.text, num_heads=4))


def _tiny_4h_torch():
    c = _tiny_4h()
    return torch_cfg.CLIPConfig(
        name=c.name, projection_dim=c.projection_dim,
        vision=torch_cfg.CLIPVisionConfig(**vars(c.vision)),
        text=torch_cfg.CLIPTextConfig(**vars(c.text)))


jax_cfg.register_config(TINY_4H, _tiny_4h)
torch_cfg.register_config(TINY_4H, _tiny_4h_torch)

# (data, second axis) grids over the 8 devices, by name
GRIDS = {"4x2": (2, "model"), "2x4": (4, "model"),
         "2x4-expert": (4, "expert"), "4x2-expert": (2, "expert")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def port_grid(grid: str, n: int = 8) -> port_mesh.DataMesh:
    mp, axis = GRIDS[grid]
    return port_mesh.data_mesh(devices=["cpu"] * n, model_parallel=mp,
                               axis=axis)


def jax_grid(grid: str):
    mp, axis = GRIDS[grid]
    if axis == "model":
        return jax_mesh.data_mesh(8, model_parallel=mp)
    return jax_finetune.build_mesh(8 // mp, 1, mp)


class Towers(dict):
    """name → (JAX config, port config, JAX params, port state dict), each
    tower initialised when first asked for."""

    def __missing__(self, name):
        if name == "siglip":
            jcfg, tcfg = tiny_configs()
            params = jax_init(jax_sm.SigLIP(jcfg), 32, 16)
            sd = siglip_bridge.params_from_jax(numpy_tree(params), tcfg)
        else:
            jcfg, tcfg = jax_cfg.get_config(name), torch_cfg.get_config(name)
            params = jax_init(JaxCLIP(jcfg), 32, 77)
            sd = bridge.params_from_jax(numpy_tree(params), tcfg)
        self[name] = (jcfg, tcfg, params, sd)
        return self[name]


@pytest.fixture(scope="module")
def towers():
    return Towers()


def clip_batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            token_ids(rng, b, 77, 1000))


def siglip_batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            rng.integers(1, 1000, (b, 16)).astype(np.int32))


def _models(towers, name, dtype="float32"):
    """(JAX module, port module on the meta device, params, state dict,
    port config, the family's batch and bridge)."""
    jcfg, tcfg, params, sd = towers[name]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if name == "siglip":
        with torch.device("meta"):
            model = sm.SigLIP(tcfg, dtype=tdt)
        return (jax_sm.SigLIP(jcfg, dtype=jdt), model, params, sd, tcfg,
                siglip_batch, siglip_bridge.params_from_jax)
    with torch.device("meta"):
        model = CLIP(tcfg, dtype=tdt)
    return (JaxCLIP(jcfg, dtype=jdt), model, params, sd, tcfg, clip_batch,
            bridge.params_from_jax)


def jax_mesh_value_and_grad(jmodel, params, jmesh, images, ids):
    """The JAX mesh step's loss and gradients: ``jax.value_and_grad`` of
    the JAX loss over params placed by ``shard_params`` and a batch split
    over ``data``."""
    sharded = jax_trainer.shard_params(params, jmesh)
    img = jax.device_put(jnp.asarray(images),
                         NamedSharding(jmesh, P("data", None, None, None)))
    tid = jax.device_put(jnp.asarray(ids), NamedSharding(jmesh,
                                                         P("data", None)))
    f = jax.jit(jax.value_and_grad(jax_trainer.loss_fn), static_argnums=1)
    return f(sharded, jmodel, img, tid)


def frames_u8(seed: int, b: int = 3, image: int = 32):
    return np.random.default_rng(seed).integers(
        0, 256, (b, image, image, 3), dtype=np.uint8)


def port_trainer(model, sd, grid, **kw):
    return trainer.CLIPTrainer(model=model, params=sd, mesh=port_grid(grid),
                               device="cpu", **kw)


# -- the partition rules -----------------------------------------------------

def _tags(shape, spec, mesh_shape) -> np.ndarray:
    """Each element's part along the split dimension, plus 1 (0 where
    ``spec`` replicates): a layout-independent picture of a placement."""
    tags = np.zeros(shape, np.float32)
    for k, ax in enumerate(spec):
        if ax is not None and mesh_shape.get(ax, 1) > 1:
            idx = np.arange(shape[k]) // (shape[k] // mesh_shape[ax]) + 1
            tags = tags + idx.reshape([-1 if i == k else 1
                                       for i in range(len(shape))])
    return tags


@pytest.mark.parametrize("grid", ["4x2", "2x4-expert"])
@pytest.mark.parametrize("name", [TINY, "siglip"])
def test_partition_specs_match_jax(towers, name, grid):
    check_partition_specs(towers, name, grid)


def check_partition_specs(towers, name, grid):
    """Every parameter's placement equals JAX's ``param_partition_spec``
    and ``_spec_for_mesh`` on the same name: each JAX leaf's part tags
    go through ``params_from_jax`` (transposes, reshapes) and must equal
    the port's spec's tags on the port's layout."""
    jcfg, tcfg, params, sd = towers[name]
    jmesh, pmesh = jax_grid(grid), port_grid(grid)
    jshape = dict(jmesh.shape)
    jtags = jax.tree_util.tree_map_with_path(
        lambda path, leaf: _tags(leaf.shape, jax_trainer._spec_for_mesh(
            jax_trainer.param_partition_spec(path, leaf), jmesh), jshape),
        numpy_tree(params))
    to_port = (siglip_bridge.params_from_jax if name == "siglip"
               else bridge.params_from_jax)
    want = to_port(jtags, tcfg)
    specs = trainer.param_shardings(sd, pmesh)
    assert specs.keys() == want.keys()
    split = 0
    for k, spec in specs.items():
        got = _tags(tuple(sd[k].shape), spec, pmesh.shape)
        np.testing.assert_array_equal(got, want[k].numpy(), err_msg=k)
        split += bool(got.any())
    # a dense tree has nothing to split over ``expert``
    assert (split > 0) == (GRIDS[grid][1] == "model" or name == TINY_MOE)
    tree = trainer.shard_params(sd, pmesh)
    n = len(pmesh.grid[0])
    for k, spec in specs.items():
        parts = tree.parts(k)
        if any(ax == pmesh.axis for ax in spec):
            # a split tensor: n parts, each 1/n of it, on its own device
            assert len(parts) == n, k
            assert all(p.numel() * n == sd[k].numel() for p in parts), k
        else:
            assert len(parts) == 1, k
        torch.testing.assert_close(tree[k], sd[k], rtol=0, atol=0)


def test_tp_parts_hold_a_fraction_of_each_split_tensor(towers):
    """On (data 4, model 2) each split kernel's parts hold half of it:
    the column splits' output rows, the row splits' input columns; the
    moments and the EMA have the same parts; the whole tensors by name
    are the one-device values."""
    _, model, _, sd, *_ = _models(towers, TINY)
    tr = port_trainer(model, sd, "4x2", ema_decay=0.5)
    st = tr.state
    q = st.params.parts("vision.layers.0.attn.q_proj.weight")
    o = st.params.parts("vision.layers.0.attn.out_proj.weight")
    f = st.params.parts("text.layers.1.mlp.fc1.bias")
    assert [tuple(p.shape) for p in q] == [(64, 128)] * 2
    assert [tuple(p.shape) for p in o] == [(128, 64)] * 2
    assert [tuple(p.shape) for p in f] == [(256,)] * 2
    torch.testing.assert_close(
        o[1], sd["vision.layers.0.attn.out_proj.weight"][:, 64:],
        rtol=0, atol=0)
    assert len(st.params.parts("vision.layers.0.attn.out_proj.bias")) == 1
    n_split = sum(len(st.params.parts(k)) > 1 for k in st.params)
    # 2 layers x 2 towers, each: q/k/v weights and biases, out_proj's
    # weight, fc1's weight and bias, fc2's weight
    assert n_split == 4 * 10
    for tree in (st.opt_state["mu"], st.opt_state["nu"], st.ema_params):
        assert [p.shape for p in tree.flat()] == [p.shape for p in
                                                  st.params.flat()]
    stored = sum(p.numel() for p in st.params.flat())
    assert stored == sum(t.numel() for t in sd.values())
    for k, t in sd.items():
        assert torch.equal(st.params[k], t), k


# -- the mesh step against JAX's ----------------------------------------------

STEP_CASES = ["clip-float32-4x2-interpret", "clip4h-float32-2x4",
              "clip-bfloat16-4x2", "siglip-float32-4x2"]
NAMES = {"clip": TINY, "clip4h": TINY_4H, "siglip": "siglip",
         "moe": TINY_MOE}


@pytest.mark.parametrize("case", STEP_CASES)
def test_mesh_step_loss_and_gradients_match_jax(towers, case, monkeypatch):
    check_mesh_step(towers, case, monkeypatch)


def check_mesh_step(towers, case, monkeypatch):
    family, dtype, grid = case.split("-", 2)
    if grid.endswith("-interpret"):
        grid = grid[:-len("-interpret")]
        monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    jmodel, model, params, sd, tcfg, batch, to_port = _models(
        towers, NAMES[family], dtype)
    images, ids = batch()
    jloss, jgrads = jax_mesh_value_and_grad(jmodel, params, jax_grid(grid),
                                            images, ids)
    loss, grads = port_trainer(model, sd, grid).value_and_grad(images, ids)
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
        w = want[name].numpy().astype(np.float64)
        err = g.numpy().astype(np.float64) - w
        rms = lambda a: np.sqrt(np.mean(a * a))    # noqa: E731
        assert rms(err) <= 0.1 * rms(w) + 1e-2, name


def test_three_mesh_steps_match_jax_by_their_losses(towers):
    """The port's (data 4, model 2) trainer and JAX's ``CLIPTrainer(mesh=
    data_mesh(8, model_parallel=2))``, with the clip, the EMA and the
    warmup-cosine schedule, three steps on one batch."""
    jcfg, tcfg, params, sd = towers[TINY]
    images, ids = clip_batch(1)
    kw = dict(learning_rate=1e-3, max_grad_norm=1.0, ema_decay=0.5,
              schedule="cosine", warmup_steps=1, total_steps=4)
    ref = jax_trainer.CLIPTrainer(
        jcfg, mesh=jax_grid("4x2"), params=jax.tree.map(jnp.copy, params),
        **kw)
    port = trainer.CLIPTrainer(tcfg, params=sd, mesh=port_grid("4x2"),
                               device="cpu", **kw)
    want = [ref.step(images, ids) for _ in range(3)]
    got = [port.step(images, ids) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert port.state.step == 3 and port.current_lr() == pytest.approx(
        ref.current_lr(), rel=1e-6)


GRAD_SCALES = (1e-4, 1.0, 1e-3, 2.0)    # the clip acts on 1.0 and 2.0


def test_mesh_optimizer_matches_optax_on_identical_gradients(towers):
    check_mesh_optimizer(towers, "4x2")


def check_mesh_optimizer(towers, grid):
    """optax's chain (clip_by_global_norm, adamw over the warmup-cosine
    schedule) plus the EMA against the mesh trainer's ``apply_gradients``
    on the same seeded gradient trees, step by step: the norm counts each
    master once, AdamW and the EMA run on the parts."""
    name = TINY if grid == "4x2" else TINY_MOE
    _, tcfg, params, sd = towers[name]
    kw = dict(schedule="cosine", warmup_steps=2, total_steps=6)
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
                               ema_decay=decay, device="cpu",
                               mesh=port_grid(grid), **kw)
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
            for k, t in got.items():
                np.testing.assert_allclose(t.detach().numpy(),
                                           want[k].numpy(), rtol=1e-5,
                                           atol=1e-7, err_msg=k)
    assert clipped == [False, True, False, True]
    assert port.state.step == port.state.opt_state["count"] == 4


# -- the cases a wrong design fails -------------------------------------------

def test_global_loss_is_not_the_mean_of_row_losses(towers):
    """The loss is taken once over the global batch: the mean of the
    data rows' own losses (a plain DDP's objective) is another number,
    far outside the tolerance, and JAX's mesh loss is the global one."""
    jmodel, model, params, sd, tcfg, batch, _ = _models(towers, TINY)
    images, ids = batch(4)
    jloss, _ = jax_mesh_value_and_grad(jmodel, params, jax_grid("4x2"),
                                       images, ids)
    loss, _ = port_trainer(model, sd, "4x2").value_and_grad(images, ids)
    one = CLIP(tcfg)
    one.load_state_dict(sd)
    with torch.no_grad():
        img, txt, scale = one(torch.from_numpy(images),
                              torch.from_numpy(ids).long())
        rows = [trainer.clip_contrastive_loss(img[r:r + 2], txt[r:r + 2],
                                              scale).item()
                for r in range(0, B, 2)]
        whole = trainer.clip_contrastive_loss(img, txt, scale).item()
    per_row = float(np.mean(rows))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(loss, whole, rtol=1e-5)
    assert abs(per_row - float(jloss)) > 1e-2 * abs(float(jloss))


def test_indivisible_batches_heads_and_experts_raise(towers):
    _, model, _, sd, tcfg, *_ = _models(towers, TINY)
    tr = port_trainer(model, sd, "4x2")
    images, ids = clip_batch(b=6)
    with pytest.raises(ValueError, match="does not split over 4 data rows"):
        tr.step(images, ids)
    with pytest.raises(ValueError, match="2 heads do not split over 4"):
        port_trainer(model, sd, "2x4")
    assert tr.state.step == 0


# -- remat, SigLIP and the EMA on the mesh ------------------------------------

def test_siglip_and_ema_on_the_mesh(towers):
    """A SigLIP mesh trainer steps as the one-device trainer does (its MAP
    head split by heads), and its EMA is ``e · decay + p · (1 - decay)``
    of its own whole parameters after each step."""
    _, model, _, sd, tcfg, batch, _ = _models(towers, "siglip")
    images, ids = batch(2)
    kw = dict(learning_rate=1e-3, ema_decay=0.5, device="cpu")
    mesh_tr = trainer.CLIPTrainer(model=model, params=sd,
                                  mesh=port_grid("4x2"), **kw)
    one = trainer.CLIPTrainer(model=sm.SigLIP(tcfg), params=sd, **kw)
    ema = {k: v.clone() for k, v in sd.items()}
    got = []
    for _ in range(3):
        got.append(mesh_tr.step(images, ids))
        for k, p in mesh_tr.state.params.items():
            ema[k] = ema[k] * 0.5 + p.detach() * 0.5
    want = [one.step(images, ids) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    q = "vision.head.q_proj.weight"
    assert len(mesh_tr.state.params.parts(q)) == 2
    assert mesh_tr.serving_params is mesh_tr.state.ema_params
    for k, e in mesh_tr.serving_params.items():
        np.testing.assert_allclose(e.numpy(), ema[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# -- checkpoints and the CLI --------------------------------------------------

def test_checkpoint_round_trip_mesh_one_device_mesh(towers, tmp_path):
    """A (data 4, model 2) trainer's checkpoint holds whole tensors in the
    port's format; it restores onto one device and, saved again from
    there, onto a (data 2, model 2) mesh of four devices: params, moments,
    EMA and step bit for bit, and the next step's loss alike."""
    _, model, _, sd, tcfg, batch, _ = _models(towers, TINY)
    images, ids = batch(3)
    kw = dict(learning_rate=1e-3, ema_decay=0.5, device="cpu")
    first = trainer.CLIPTrainer(tcfg, params=sd, mesh=port_grid("4x2"),
                                **kw)
    for _ in range(2):
        first.step(images, ids)
    path = ckpt.save_checkpoint(tmp_path / "a", first, first.state.step)
    on_disk = ckpt.load_params(path)
    assert on_disk["vision.layers.0.mlp.fc1.weight"].shape == (512, 128)
    one = trainer.CLIPTrainer(tcfg, params=sd, **kw)
    assert ckpt.restore_checkpoint(tmp_path / "a", one) == 2
    ckpt.save_checkpoint(tmp_path / "b", one, one.state.step)
    other = trainer.CLIPTrainer(tcfg, params=sd, mesh=port_mesh.data_mesh(
        devices=["cpu"] * 4, model_parallel=2), **kw)
    assert ckpt.restore_checkpoint(tmp_path / "b", other) == 2
    for a, b in ((first.state, one.state), (first.state, other.state)):
        assert b.step == 2 and b.opt_state["count"] == 2
        for x, y in ((a.params, b.params),
                     (a.opt_state["mu"], b.opt_state["mu"]),
                     (a.opt_state["nu"], b.opt_state["nu"]),
                     (a.ema_params, b.ema_params)):
            assert x.keys() == y.keys()
            for k in x:
                assert torch.equal(x[k], y[k]), k
    losses = [t.step(images, ids) for t in (first, one, other)]
    np.testing.assert_allclose(losses[1:], [losses[0]] * 2, rtol=1e-5)


def test_finetune_cli_on_a_mesh_serves_its_checkpoint(tmp_path):
    """``finetune --dp 2 --tp 2 --device cpu`` on synthetic videos trains
    on a (data 2, model 2) mesh of four ``"cpu"`` entries and writes a
    checkpoint that ``model.orbax_checkpoint`` serves: the served
    vectors are the trained module's on the saved weights."""
    videos = tmp_path / "videos"
    videos.mkdir()
    for name in ("a_red_car.mp4", "blue-sky.mp4"):
        make_synthetic_video(videos / name, n_frames=30, size=(64, 48))
    out = tmp_path / "out"
    assert finetune.main([
        "--videos-dir", str(videos), "--out", str(out),
        "--model", TINY_224_FULL_VOCAB, "--device", "cpu", "--batch", "4",
        "--max-frames-per-video", "8", "--lr", "1e-3", "--dp", "2",
        "--tp", "2", "--ema-decay", "0.9"]) == 0
    assert ckpt.latest_step(out) == 2
    params = ckpt.load_params(out / "step_2")
    tower = CLIPEmbedder(TINY_224_FULL_VOCAB, orbax_checkpoint=out / "step_2",
                         dtype=torch.float32, device="cpu")
    assert tower.pretrained is True
    frames = frames_u8(3, image=224)
    got = tower.embed_frames(frames)
    model = CLIP(torch_cfg.get_config(TINY_224_FULL_VOCAB))
    model.load_state_dict(params)
    from video_quierer_tpu_torch.ops.preprocess import normalize_images
    with torch.no_grad():
        want = model.encode_image(normalize_images(torch.from_numpy(frames)))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_build_mesh_and_its_refusals_match_jax():
    """``build_mesh`` as JAX's: None for one device, ``(data, model)`` or
    ``(data, expert)`` grids; JAX's refusals with JAX's messages."""
    assert finetune.build_mesh(1, 1, 1, device="cpu") is None
    m = finetune.build_mesh(2, 2, 1, device="cpu")
    assert m.shape == {"data": 2, "model": 2} == dict(
        jax_finetune.build_mesh(2, 2, 1).shape)
    m = finetune.build_mesh(2, 1, 4, device="cpu")
    assert m.shape == {"data": 2, "expert": 4} == dict(
        jax_finetune.build_mesh(2, 1, 4).shape)
    assert finetune.build_mesh(4, 1, 1, device="cpu").shape == {
        "data": 4, "model": 1}
    for build in (lambda: finetune.build_mesh(2, 2, 2, device="cpu"),
                  lambda: jax_finetune.build_mesh(2, 2, 2)):
        with pytest.raises(SystemExit, match="mutually exclusive"):
            build()
    with pytest.raises(SystemExit, match=r"mesh needs 16 devices, have 8"):
        jax_finetune.build_mesh(16, 1, 1)
    with pytest.raises(SystemExit, match=r"mesh needs 16 devices, have 8"):
        finetune.build_mesh(16, 1, 1, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="mesh needs 2 devices, have 0"):
            finetune.build_mesh(2, 1, 1)
