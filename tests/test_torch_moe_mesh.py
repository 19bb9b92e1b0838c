"""The port's Switch-MoE towers on the training meshes
(``parallel/moe.py:SwitchMoEMLP.mesh_forward``, ``shard_moe_params``,
``expert_mesh``; ``train/trainer.py`` with ``mesh=``) against the JAX
package's mesh step on the CPU: ``(data 2, expert 4)`` and ``(data 4,
model 2)`` grids over ``["cpu"] * 8`` against JAX's meshes over its 8
virtual devices, the JAX tower's attention through its einsum reference
(as ``tests/test_torch_moe.py``). Helpers and tolerances are
``tests/test_torch_train_mesh.py``'s: f32 loss rtol 1e-5, gradients rtol
1e-4 / atol 1e-6; the optimizer rtol 1e-5 / atol 1e-7."""

import numpy as np
import pytest
import torch

from tests.test_torch_train_mesh import (
    Towers,
    _models,
    check_mesh_optimizer,
    check_mesh_step,
    check_partition_specs,
    jax_grid,
    jax_mesh_value_and_grad,
    port_trainer,
)
from tests.torch_parity import TINY_MOE, one_torch_thread
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.parallel import mesh as port_mesh
from video_quierer_tpu_torch.parallel import moe
from video_quierer_tpu_torch.train import trainer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def towers():
    return Towers()


@pytest.mark.parametrize("grid", ["4x2", "2x4-expert"])
def test_partition_specs_match_jax(towers, grid):
    check_partition_specs(towers, TINY_MOE, grid)


@pytest.mark.parametrize("grid", ["2x4-expert", "4x2"])
def test_mesh_step_loss_and_gradients_match_jax(towers, grid, monkeypatch):
    check_mesh_step(towers, f"moe-float32-{grid}", monkeypatch)


def test_mesh_optimizer_matches_optax_on_identical_gradients(towers):
    check_mesh_optimizer(towers, "2x4-expert")


def test_shard_moe_params_and_expert_mesh(towers):
    """JAX ``shard_moe_params`` over ``expert_mesh``: the expert stacks
    split on their leading axis, one expert a part over four parts, the
    router and the dense weights replicated; the whole tensors are the
    given ones. Without a card the mesh takes ``devices`` or raises."""
    _, _, _, sd = towers[TINY_MOE]
    mesh = moe.expert_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"data": 1, moe.EXPERT_AXIS: 4}
    tree = moe.shard_moe_params(sd, mesh)
    w1 = tree.parts("vision.layers.1.moe.w1")
    assert [tuple(p.shape) for p in w1] == [(1, 128, 512)] * 4
    assert len(tree.parts("vision.layers.1.moe.router.weight")) == 1
    assert len(tree.parts("vision.layers.0.mlp.fc1.weight")) == 1
    for k, t in sd.items():
        assert torch.equal(tree[k], t), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            moe.expert_mesh(4)
    _, mmodel, _, msd, *_ = _models(towers, TINY_MOE)
    with pytest.raises(ValueError, match="4 experts do not split over 8"):
        trainer.CLIPTrainer(model=mmodel, params=msd, device="cpu",
                            mesh=port_mesh.data_mesh(
                                devices=["cpu"] * 8, model_parallel=8,
                                axis=moe.EXPERT_AXIS))


# -- the global routing -------------------------------------------------------

def _dropped_one_device(tcfg, sd, images) -> list:
    """The tokens each MoE layer of a one-device tower drops on the whole
    batch (its routing recomputed from the layer's input)."""
    model = CLIP(tcfg)
    model.load_state_dict(sd)
    out = []

    def hook(layer, inputs, _):
        x = inputs[0]
        n = x.shape[0] * x.shape[1]
        probs = torch.softmax(layer.router(x.reshape(n, -1).float()), -1)
        keep = moe.route(probs, moe.capacity(n, layer.num_experts,
                                             layer.capacity_factor))[3]
        out.append(int((~keep).sum()))

    for m in model.modules():
        if isinstance(m, moe.SwitchMoEMLP):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.encode_image(torch.from_numpy(images))
    return out


class _LocalRouting(trainer.RowPlan):
    """The wrong design: each data row routes only its own tokens (its
    own capacity, no offsets)."""

    def __init__(self, row, names, parts, data_rows, offsets):
        super().__init__(row, names, parts, 1, {})


def test_moe_overflow_routes_the_global_batch(towers, monkeypatch):
    """A batch that overflows capacity on (data 2, expert 4): the mesh
    drops the one-device tower's tokens, layer by layer, and its loss is
    JAX's mesh loss; routing each row alone drops other tokens and gives
    a loss far from JAX's."""
    jmodel, model, params, sd, tcfg, batch, _ = _models(towers, TINY_MOE)
    images, ids = batch(5)
    jloss, _ = jax_mesh_value_and_grad(jmodel, params,
                                       jax_grid("2x4-expert"), images, ids)
    tr = port_trainer(model, sd, "2x4-expert")
    loss, _ = tr.value_and_grad(images, ids)
    dropped = [int(v) for v in tr.last_dropped.values()]
    assert dropped == _dropped_one_device(tcfg, sd, images)
    assert sum(dropped) > 0
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    monkeypatch.setattr(trainer, "RowPlan", _LocalRouting)
    local = port_trainer(model, sd, "2x4-expert")
    wrong, _ = local.value_and_grad(images, ids)
    assert [int(v) for v in local.last_dropped.values()] != dropped
    assert abs(wrong - float(jloss)) > 1e-4 * abs(float(jloss))


def test_mesh_remat_and_bf16_match_one_device(towers):
    """Under remat (each block recomputed in the backward, its MoE
    offsets and parts included) the mesh gives the same loss and
    gradients as without; bf16 towers over f32 parts keep f32 gradients
    and the one-device bf16 loss within rtol 1e-2."""
    _, _, _, sd, tcfg, batch, _ = _models(towers, TINY_MOE)
    images, ids = batch(6)
    out = []
    for remat in (False, True):
        with torch.device("meta"):
            m = CLIP(tcfg, remat=remat)
        out.append(port_trainer(m, sd, "4x2-expert").value_and_grad(
            images, ids))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    for k in g0:
        torch.testing.assert_close(g0[k], g1[k], rtol=0, atol=0)
    with torch.device("meta"):
        bf = CLIP(tcfg, dtype=torch.bfloat16)
    lb, gb = port_trainer(bf, sd, "4x2-expert").value_and_grad(images, ids)
    one = trainer.CLIPTrainer(tcfg, params=sd, dtype=torch.bfloat16,
                              device="cpu")
    lo, _ = one.value_and_grad(images, ids)
    np.testing.assert_allclose(lb, lo, rtol=1e-2)
    assert all(g.dtype == torch.float32 for g in gb.values())
