"""The port's retrieval evaluation (video_quierer_tpu_torch/train/eval.py)
against the JAX package's, at the tiny CLIP (``tests/torch_parity.py``
TINY) on the same weights (``params_from_jax``), the JAX towers' attention
in interpret mode: pessimistic ranks on ties, the padded fixed-batch
encode (features per-row cosine >= 1 - 1e-5, unit rows within 1e-5), and
the metrics, equal."""

import numpy as np
import pytest
import torch

from tests.torch_parity import (
    TINY,
    jax_init,
    numpy_tree,
    one_torch_thread,
    row_cosine,
    token_ids,
)
from video_quierer_tpu.models.clip import config as jax_cfg
from video_quierer_tpu.models.clip.model import CLIP as JaxCLIP
from video_quierer_tpu.train import eval as jax_eval
from video_quierer_tpu_torch.models.clip import bridge
from video_quierer_tpu_torch.models.clip import config as torch_cfg
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.train import eval as train_eval
from video_quierer_tpu_torch.train.trainer import CLIPTrainer

N = 20          # pairs: two whole batches of 8 and a padded one of 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def towers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VQT_PALLAS_INTERPRET", "1")
        jmodel = JaxCLIP(jax_cfg.get_config(TINY))
        params = jax_init(jmodel, 32, 77)
        tcfg = torch_cfg.get_config(TINY)
        sd = bridge.params_from_jax(numpy_tree(params), tcfg)
        model = CLIP(tcfg)
        model.load_state_dict(sd)
        rng = np.random.default_rng(7)
        images = rng.standard_normal((N, 32, 32, 3)).astype(np.float32)
        ids = token_ids(rng, N, 77, 1000)
        want = jax_eval.retrieval_metrics(jmodel, params, images, ids,
                                          batch_size=8)
        feats = jax_eval._encode(jmodel, params, images, ids, batch_size=8)
        yield dict(model=model, sd=sd, tcfg=tcfg, images=images, ids=ids,
                   want=want, feats=feats)


@pytest.mark.parametrize("sim", [
    [[1.0, 1.0, 0.0], [0.5, 0.5, 0.5], [0.0, 0.2, 0.1]],
    [[0.3, 0.3], [0.3, 0.3]],
    np.eye(4).tolist()])
def test_ranks_are_pessimistic_on_ties(sim):
    sim = np.asarray(sim, np.float32)
    got = train_eval._ranks(sim)
    np.testing.assert_array_equal(got, jax_eval._ranks(sim))
    # an equal score ahead of the match counts against it
    np.testing.assert_array_equal(
        got, [int((row >= row[i]).sum()) - 1 for i, row in enumerate(sim)])


def test_encode_pads_to_a_fixed_batch_and_matches_jax(towers):
    t = towers
    img, txt = train_eval._encode(t["model"], t["sd"], t["images"],
                                  t["ids"], batch_size=8)
    want_img, want_txt = t["feats"]
    assert img.shape == txt.shape == (N, 64)
    for got, want in ((img, want_img), (txt, want_txt)):
        assert row_cosine(got, want).min() >= 1 - 1e-5
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   rtol=1e-5)


def test_retrieval_metrics_match_jax(towers):
    t = towers
    got = train_eval.retrieval_metrics(t["model"], t["sd"], t["images"],
                                       t["ids"], batch_size=8)
    assert got == t["want"]
    assert set(got) == {f"{d}_{m}" for d in ("i2t", "t2i")
                        for m in ("recall@1", "recall@5", "recall@10",
                                  "median_rank")}


def test_retrieval_metrics_validate_pairing(towers):
    t = towers
    with pytest.raises(ValueError, match="1:1"):
        train_eval.retrieval_metrics(t["model"], t["sd"], t["images"][:3],
                                     t["ids"][:2])
    assert train_eval.retrieval_metrics(t["model"], t["sd"],
                                        t["images"][:0], t["ids"][:0]) == {}


def test_evaluate_trainer_uses_the_serving_params(towers):
    """With an EMA tracked, the trainer is evaluated on the EMA; the
    module's live parameters are left as they are."""
    t = towers
    trainer = CLIPTrainer(t["tcfg"], params=t["sd"], learning_rate=1e-2,
                          ema_decay=0.5, device="cpu")
    trainer.step(t["images"][:8], t["ids"][:8])
    live = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    kw = dict(ks=(1, 3), batch_size=8)
    got = train_eval.evaluate_trainer(trainer, t["images"], t["ids"], **kw)
    assert got == train_eval.retrieval_metrics(
        trainer.model, trainer.state.ema_params, t["images"], t["ids"], **kw)
    img_ema, _ = train_eval._encode(trainer.model, trainer.serving_params,
                                    t["images"], t["ids"], batch_size=8)
    img_live, _ = train_eval._encode(trainer.model, trainer.state.params,
                                     t["images"], t["ids"], batch_size=8)
    assert not np.array_equal(img_ema, img_live)
    assert all(torch.equal(v, live[k])
               for k, v in trainer.state.params.items())
