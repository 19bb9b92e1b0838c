"""Port text towers vs the JAX package's, on the same weights (moved with
``params_from_jax``) and the same numpy-seeded token ids.

- fused text encode (video_quierer_tpu_torch/ops/fused_layer.py; plain
  version on the CPU) vs JAX ``fused_text_encode`` with its Pallas layer
  kernel in interpret mode;
- module tower (models/clip/model.py, attention through the port's
  ``attention``) vs flax ``CLIP.encode_text`` (fused attention kernel in
  interpret mode);
- the MIN_TOKENS routing on both sides of the boundary.

Tolerances on the unit output rows: f32 per-row cosine >= 1 - 1e-5 (same
math, other summation order); bf16 >= 0.999 (bf16 rounding at other
points). Kernel B2 is held against its plain version on the card by
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (TINY, port_state_dict, row_cosine,
                                token_ids)
from video_quierer_tpu.models.clip.config import get_config
from video_quierer_tpu.models.clip.model import CLIP as FlaxCLIP
from video_quierer_tpu.models.clip.model import init_params as \
    jax_init_params
from video_quierer_tpu.ops import fused_layer as jax_fl
from video_quierer_tpu_torch.models.clip import embedder as emb_mod
from video_quierer_tpu_torch.models.clip.bridge import init_params as \
    torch_init
from video_quierer_tpu_torch.models.clip.config import \
    get_config as torch_get_config
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.ops import fused_layer as torch_fl

MIN_COS = {"float32": 1 - 1e-5, "bfloat16": 0.999}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    # the f32 layer fits one kernel only above the default VMEM budget
    monkeypatch.setenv("VQT_FUSED_LAYER_BUDGET", str(64 * 2 ** 20))


@pytest.fixture(scope="module")
def towers():
    """(flax model f32, params f32) of the tiny config (both towers: the
    port's CLIP module holds both)."""
    cfg = get_config(TINY)
    params = jax_init_params(FlaxCLIP(cfg, dtype=jnp.float32), seed=0)
    return cfg, params


def _both(towers, dtype):
    cfg, params = towers
    jdt = getattr(jnp, dtype)
    jparams = jax.tree.map(
        lambda a: a.astype(jdt) if a.dtype == jnp.float32 else a, params)
    port = CLIP(torch_get_config(TINY))
    port.load_state_dict(port_state_dict(params))
    port = port.to(getattr(torch, dtype)).eval()
    return cfg, FlaxCLIP(cfg, dtype=jdt), jparams, port


@pytest.mark.parametrize("dtype,s", [("float32", 8), ("bfloat16", 16)])
def test_fused_encode_matches_jax(towers, dtype, s):
    cfg, _, jparams, port = _both(towers, dtype)
    ids = token_ids(np.random.default_rng(s), 32, s, cfg.text.vocab_size)
    want = np.asarray(jax_fl.fused_text_encode(
        jparams, jnp.asarray(ids), cfg=cfg, dtype=getattr(jnp, dtype)))
    ops = [torch_fl._layer_operands(b, getattr(torch, dtype))
           for b in port.text.layers]
    with torch.inference_mode():
        got = torch_fl.fused_text_encode(
            port, torch.from_numpy(ids).long(), ops).numpy()
    assert got.shape == want.shape == (32, 64)
    assert row_cosine(got, want).min() >= MIN_COS[dtype]
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,s", [("float32", 77), ("bfloat16", 8)])
def test_module_tower_matches_flax(towers, dtype, s):
    cfg, model, jparams, port = _both(towers, dtype)
    ids = token_ids(np.random.default_rng(100 + s), 3, s,
                    cfg.text.vocab_size)
    want = np.asarray(model.apply({"params": jparams}, jnp.asarray(ids),
                                  method=FlaxCLIP.encode_text))
    with torch.inference_mode():
        got = port.encode_text(torch.from_numpy(ids).long()).numpy()
    assert row_cosine(got, want).min() >= MIN_COS[dtype]


def test_min_tokens_gate_matches_jax():
    for b in (1, 8, 31, 32, 64, 256):
        for s in (8, 16, 32, 77):
            want = (jax_fl.fused_seq_eligible(s)
                    and jax_fl.fused_batch_eligible(b, s, jnp.bfloat16))
            got = (torch_fl.fused_seq_eligible(s)
                   and torch_fl.fused_batch_eligible(b, s))
            assert got == want, (b, s)


@pytest.mark.parametrize("b,s,fused", [(32, 8, True), (31, 8, False),
                                       (16, 16, True), (15, 16, False),
                                       (64, 77, False)])
def test_embedder_routes_at_min_tokens(monkeypatch, b, s, fused):
    calls = []
    real = emb_mod.fused_text_encode

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(emb_mod, "fused_text_encode", spy)
    emb = CLIPEmbedder(TINY, dtype=torch.float32, device="cpu")
    ids = token_ids(np.random.default_rng(b), b, s, 1000)
    out = emb.text_encode_fn(emb.params, torch.from_numpy(ids).long())
    assert out.shape == (b, 64)
    assert bool(calls) is fused


def test_seeded_init_is_deterministic():
    cfg = torch_get_config(TINY)
    a = torch_init(cfg, torch.Generator().manual_seed(3))
    b = torch_init(cfg, torch.Generator().manual_seed(3))
    assert a.keys() == CLIP(cfg).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
