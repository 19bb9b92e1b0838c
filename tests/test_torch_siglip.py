"""Port SigLIP vs the JAX package's, on the same weights (moved with the
port's ``models/siglip/bridge.py:params_from_jax``) and the same
numpy-seeded inputs, at a tiny config with heads of 64 (width 128, 2
heads, 2 layers; 32 px frames in 8 px patches, S = 16; context 16):

- the tanh-GELU halves: ``mlp_half_ref(act="gelu_tanh")`` against the
  Pallas kernel ``_mlp_half_call`` and ``attn_half_ref(causal=False)``
  then ``mlp_half_ref`` against ``_fused_layer_call(causal=False,
  act="gelu_tanh")``, both in interpret mode, also on activations wide
  enough to reach the kernel form's ``exp`` overflow (fc1 outputs below
  -10): f32 atol 1e-5, bf16 within two bf16 ulps at the residual's
  largest magnitude (the tolerances of ``tests/test_torch_vision.py``);
- the module tower's ``gelu_tanh`` against ``jax.nn.gelu(approximate=
  True)``: f32 within 2 ulps of the input (the two tanh implementations
  differ by an ulp near -1, where ``1 + tanh`` cancels), bf16 within one
  bf16 ulp of the result;
- both towers (``SigLIP.encode_image``/``encode_text``) against flax's,
  and the fused text encode against JAX's ``fused_siglip_text_encode``
  (Pallas layer kernels in interpret mode): per-row cosine >= 1 - 1e-5
  in f32, >= 0.999 in bf16;
- ``spm.py`` (the port's copy) against the JAX file, on ``spiece.model``
  bytes built in memory;
- the embedder: routing at ``MIN_TOKENS``, identity ``prepare_text_ids``,
  frames and texts against the JAX embedder on the same weights.

Kernels B5 and B6 (tanh-GELU) are held against their plain versions on
the card by ``tests/test_torch_kernels.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_siglip_spm import BASE_PIECES, make_spiece
from tests.test_torch_vision import _assert_half_close, _bf16_ulp
from tests.torch_parity import numpy_tree, row_cosine
from video_quierer_tpu.models.clip.model import gelu_tanh as jax_gelu_tanh
from video_quierer_tpu.models.siglip import embedder as jax_emb_mod
from video_quierer_tpu.models.siglip import model as jax_sm
from video_quierer_tpu.models.siglip import spm as jax_spm
from video_quierer_tpu.models.siglip.fused import \
    fused_siglip_text_encode as jax_fused_text
from video_quierer_tpu.ops import fused_layer as jax_fl
from video_quierer_tpu.ops.preprocess import SIGLIP_MEAN, SIGLIP_STD
from video_quierer_tpu.ops.preprocess import normalize_images as jax_norm
from video_quierer_tpu_torch.models.clip.model import gelu_tanh
from video_quierer_tpu_torch.models.siglip import bridge
from video_quierer_tpu_torch.models.siglip import embedder as emb_mod
from video_quierer_tpu_torch.models.siglip import model as sm
from video_quierer_tpu_torch.models.siglip import spm
from video_quierer_tpu_torch.models.siglip.fused import \
    fused_siglip_text_encode
from video_quierer_tpu_torch.ops import fused_layer as torch_fl
from video_quierer_tpu_torch.ops import preprocess as torch_pre

MIN_COS = {"float32": 1 - 1e-5, "bfloat16": 0.999}


def tiny_configs(image: int = 32, patch: int = 8, vocab: int = 1000,
                 context: int = 16):
    """(JAX config, port config) of the tiny SigLIP: width 128, 2 heads
    of 64, 2 layers in both towers."""
    kw = dict(hidden_size=128, num_layers=2, num_heads=2)
    jcfg = jax_sm.SigLIPConfig(
        name="siglip-parity-tiny",
        vision=jax_sm.SigLIPVisionConfig(image_size=image, patch_size=patch,
                                         **kw),
        text=jax_sm.SigLIPTextConfig(vocab_size=vocab,
                                     context_length=context, **kw))
    tcfg = sm.SigLIPConfig(
        name=jcfg.name,
        vision=sm.SigLIPVisionConfig(**dataclasses.asdict(jcfg.vision)),
        text=sm.SigLIPTextConfig(**dataclasses.asdict(jcfg.text)))
    return jcfg, tcfg


def jax_params(jcfg, seed: int = 0):
    return jax_sm.siglip_init_params(jax_sm.SigLIP(jcfg), seed=seed)


def port_model(params, tcfg, dtype) -> sm.SigLIP:
    model = sm.SigLIP(tcfg)
    model.load_state_dict(bridge.params_from_jax(numpy_tree(params), tcfg))
    return model.to(getattr(torch, dtype)).eval()


def _cast(params, dtype):
    jdt = getattr(jnp, dtype)
    return jax.tree.map(
        lambda a: a.astype(jdt) if a.dtype == jnp.float32 else a, params)


def _frames(seed, b, size=32):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3),
                                                dtype=np.uint8)


def _ids(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(
        1, vocab, (b, s)).astype(np.int32)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = tiny_configs()
    return jcfg, tcfg, jax_params(jcfg)


# -- the tanh-GELU halves -------------------------------------------------

def _half_inputs(tiny, dtype, b, s, scale):
    jcfg, tcfg, params = tiny
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = (scale * np.random.default_rng(b * s).standard_normal(
        (b * s, 128))).astype(np.float32)
    block = params["text"]["encoder"]["layers_0"]
    jops = jax_fl._layer_operands(_cast(block, dtype), jdt)
    tops = torch_fl._layer_operands(port_model(params, tcfg, dtype)
                                    .text.layers[0], tdt)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt), jops, tops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1.0, 16.0])
def test_mlp_half_gelu_tanh_matches_pallas_kernel(tiny, dtype, scale):
    """B6's plain version with tanh-GELU vs ``_mlp_half_call``; at scale
    16 the fc1 outputs reach far below -10, where exp(-2u) overflows to
    inf and the activation is -0 in both."""
    b, s = 4, 16
    jx, tx, jops, tops = _half_inputs(tiny, dtype, b, s, scale)
    eps = tiny[0].text.layer_norm_eps
    want = jax_fl._mlp_half_call(jx, jops[0], *jops[5:], t=2 * s, eps=eps,
                                 act="gelu_tanh", interpret=True)
    got = torch_fl.mlp_half_ref(tx, tops, eps=eps, act="gelu_tanh")
    _assert_half_close(got, want, tx, dtype)
    # the quick-GELU default stays what it was
    quick = torch_fl.mlp_half_ref(tx, tops, eps=eps)
    assert not torch.equal(quick, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncausal_gelu_tanh_layer_matches_pallas_kernel(tiny, dtype):
    """``_fused_layer_call(causal=False, act="gelu_tanh")`` (the TPU's B2
    as the SigLIP text tower runs it at narrow widths) vs the port's
    halves."""
    b, s = 4, 16
    jx, tx, jops, tops = _half_inputs(tiny, dtype, b, s, 1.0)
    eps, heads = tiny[0].text.layer_norm_eps, tiny[0].text.num_heads
    idr, idc = jax_fl._item_ids(2 * s, s)
    want = jax_fl._fused_layer_call(jx, idr, idc, *jops, heads=heads,
                                    eps=eps, causal=False, act="gelu_tanh",
                                    interpret=True)
    x3 = torch_fl.attn_half_ref(tx, tops, s=s, heads=heads, eps=eps,
                                causal=False)
    got = torch_fl.mlp_half_ref(x3, tops, eps=eps, act="gelu_tanh")
    _assert_half_close(got, want, tx, dtype)


def test_kernel_form_constants_and_negative_tail():
    """The kernel form's constants round to T as JAX's weak types do
    (bf16 0.796875 and 0.044677734375), and far negative inputs give -0
    where exp(-2u) overflows."""
    assert torch_fl._const(torch_fl.GELU_TANH_C1, torch.bfloat16) == 0.796875
    assert torch_fl._const(torch_fl.GELU_TANH_C2, torch.bfloat16) == \
        0.044677734375
    for dt in (torch.float32, torch.bfloat16):
        h = torch.tensor([-1e4, -200.0, -30.0, -12.0], dtype=dt)
        out = torch_fl.gelu_kernel_form(h, "gelu_tanh")
        assert torch.all(out == 0) and torch.all(torch.signbit(out))
    with pytest.raises(ValueError, match="activation"):
        torch_fl.gelu_kernel_form(h, "relu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_gelu_tanh_matches_jax(dtype):
    x = np.concatenate([
        np.random.default_rng(0).standard_normal(4096) * 3,
        np.linspace(-12, 12, 1001)]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_gelu_tanh(jnp.asarray(x, jdt))).astype(np.float64)
    got = gelu_tanh(torch.from_numpy(x).to(tdt)).double().numpy()
    if dtype == "float32":
        tol = 2 * np.spacing(np.abs(x)).astype(np.float64)
    else:
        tol = _bf16_ulp(want)
    assert np.all(np.abs(got - want) <= tol)


# -- towers ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_tower_matches_flax(tiny, dtype):
    jcfg, tcfg, params = tiny
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    frames = _frames(10, 5)
    want = np.asarray(jax_sm.SigLIP(jcfg, dtype=jdt).apply(
        {"params": _cast(params, dtype)},
        jax_norm(jnp.asarray(frames), dtype=jdt, mean=SIGLIP_MEAN,
                 std=SIGLIP_STD), method=jax_sm.SigLIP.encode_image))
    with torch.inference_mode():
        got = port_model(params, tcfg, dtype).encode_image(
            torch_pre.normalize_images(
                torch.from_numpy(frames), dtype=tdt,
                mean=torch_pre.SIGLIP_MEAN, std=torch_pre.SIGLIP_STD)
        ).numpy()
    assert got.shape == want.shape == (5, 128)
    assert row_cosine(got, want).min() >= MIN_COS[dtype]
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_tower_matches_flax(tiny, dtype):
    jcfg, tcfg, params = tiny
    ids = _ids(1, 3, 16, jcfg.text.vocab_size)
    want = np.asarray(jax_sm.SigLIP(jcfg, dtype=getattr(jnp, dtype)).apply(
        {"params": _cast(params, dtype)}, jnp.asarray(ids),
        method=jax_sm.SigLIP.encode_text))
    with torch.inference_mode():
        got = port_model(params, tcfg, dtype).encode_text(
            torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == (3, 128)
    assert row_cosine(got, want).min() >= MIN_COS[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_text_encode_matches_jax(tiny, dtype):
    jcfg, tcfg, params = tiny
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ids = _ids(2, 32, 16, jcfg.text.vocab_size)
    want = np.asarray(jax_fused_text(_cast(params, dtype), jnp.asarray(ids),
                                     cfg=jcfg, dtype=jdt))
    model = port_model(params, tcfg, dtype)
    ops = [torch_fl._layer_operands(b, tdt) for b in model.text.layers]
    with torch.inference_mode():
        got = fused_siglip_text_encode(model, torch.from_numpy(ids).long(),
                                       ops).numpy()
        tower = model.encode_text(torch.from_numpy(ids).long()).numpy()
    assert got.shape == want.shape == (32, 128)
    assert row_cosine(got, want).min() >= MIN_COS[dtype]
    assert row_cosine(got, tower).min() >= MIN_COS[dtype]
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               rtol=1e-5)


def test_params_from_jax_covers_the_module(tiny):
    jcfg, tcfg, params = tiny
    sd = bridge.params_from_jax(numpy_tree(params), tcfg)
    assert sd.keys() == sm.SigLIP(tcfg).state_dict().keys()
    # every leaf, the logit scale and bias included (training parameters)
    leaves = jax.tree_util.tree_leaves(params)
    assert sum(v.numel() for v in sd.values()) == \
        sum(int(np.prod(x.shape)) for x in leaves)
    for name in ("logit_scale", "logit_bias"):
        assert sd[name].item() == float(params[name])


def test_seeded_init_is_deterministic(tiny):
    _, tcfg, _ = tiny
    a = bridge.init_params(tcfg, torch.Generator().manual_seed(3))
    b = bridge.init_params(tcfg, torch.Generator().manual_seed(3))
    assert a.keys() == sm.SigLIP(tcfg).state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(a[k].shape == v.shape
               for k, v in sm.SigLIP(tcfg).state_dict().items())


def test_base_config_matches_jax():
    want, got = jax_sm.siglip_base_patch16(), sm.siglip_base_patch16()
    assert dataclasses.asdict(got.vision) == dataclasses.asdict(want.vision)
    assert dataclasses.asdict(got.text) == dataclasses.asdict(want.text)
    assert got.name == want.name and got.vision.num_patches == 196


def test_siglip_normalisation_constants_match_jax():
    assert torch_pre.SIGLIP_MEAN == SIGLIP_MEAN
    assert torch_pre.SIGLIP_STD == SIGLIP_STD


# -- spm ------------------------------------------------------------------

SPM_TEXTS = ["hello the cat", "Hello, the  CAT!", "zebra", "", "the the",
             "hello\tcat\n", "naïve café ﬁsh", "<unk> ▁ cat"]


@pytest.mark.parametrize("byte_fallback", [False, True])
def test_spm_copy_matches_jax(byte_fallback):
    blob = make_spiece(BASE_PIECES, byte_fallback=byte_fallback)
    want, got = jax_spm.load_model_proto(blob), spm.load_model_proto(blob)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    jt = jax_spm.SigLIPSPTokenizer(blob, context_length=12)
    tt = spm.SigLIPSPTokenizer(blob, context_length=12)
    for text in SPM_TEXTS:
        assert tt.encode(text) == jt.encode(text)
        assert spm.canonicalize_text(text) == \
            jax_spm.canonicalize_text(text)
        for flags in ((False, True, True), (True, False, False)):
            kw = dict(zip(("add_dummy_prefix", "remove_extra_whitespaces",
                           "escape_whitespaces"), flags))
            assert spm.normalize_nmt_nfkc(text, **kw) == \
                jax_spm.normalize_nmt_nfkc(text, **kw)
    assert np.array_equal(tt(SPM_TEXTS), jt(SPM_TEXTS))


def test_spm_found_by_env(tmp_path, monkeypatch):
    path = tmp_path / "spiece.model"
    path.write_bytes(make_spiece(BASE_PIECES))
    monkeypatch.delenv("VQT_SIGLIP_SPIECE", raising=False)
    assert spm.find_spiece_model() is None
    assert isinstance(emb_mod.siglip_tokenizer(), emb_mod.HashTokenizer)
    monkeypatch.setenv("VQT_SIGLIP_SPIECE", str(path))
    assert spm.find_spiece_model() == jax_spm.find_spiece_model() == path
    tok = emb_mod.siglip_tokenizer()
    assert isinstance(tok, spm.SigLIPSPTokenizer)
    assert np.array_equal(tok(SPM_TEXTS),
                          jax_emb_mod.siglip_tokenizer()(SPM_TEXTS))


# -- the embedder ---------------------------------------------------------

@pytest.fixture(scope="module")
def embedders():
    """The JAX embedder (f32, its ``siglip_base_patch16`` swapped for the
    tiny config while it is built) and the port's on its weights."""
    jcfg, tcfg = tiny_configs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_emb_mod, "siglip_base_patch16", lambda: jcfg)
        mp.delenv("VQT_SIGLIP_SPIECE", raising=False)
        mp.setenv("VQT_PALLAS_INTERPRET", "1")
        jax_emb = jax_emb_mod.SigLIPEmbedder(dtype=jnp.float32, seed=0)
        port = emb_mod.SigLIPEmbedder(
            tcfg, dtype=torch.float32, device="cpu",
            state_dict=bridge.params_from_jax(numpy_tree(jax_emb.params),
                                              tcfg))
    return jax_emb, port


def test_embedder_tokenizer_and_ids_match_jax(embedders):
    jax_emb, port = embedders
    texts = ["a dog on the beach", "night city", "x " * 40]
    ids = port.tokenizer(texts)
    assert np.array_equal(ids, jax_emb.tokenizer(texts))
    assert ids.shape == (3, 16) and port.embed_dim == jax_emb.embed_dim
    assert port.prepare_text_ids(ids) is ids
    assert port.tokenizer.sot == 998 and port.tokenizer.eot == 999
    full = emb_mod.siglip_tokenizer()
    assert (full.context_length, full.vocab_size, full.sot, full.eot) == \
        (64, 32000, 31998, 31999)


@pytest.mark.parametrize("n,fused", [(1, False), (8, False), (16, True),
                                     (32, True)])
def test_embedder_text_routing_and_rows(embedders, monkeypatch, n, fused):
    """``B·S >= MIN_TOKENS`` (B >= 16 at context 16) takes the fused
    encode, as the JAX embedder's gate; rows match the JAX embedder."""
    jax_emb, port = embedders
    calls = []
    real = emb_mod.fused_siglip_text_encode
    monkeypatch.setattr(emb_mod, "fused_siglip_text_encode",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    texts = [f"query number {i} about a dog" for i in range(n)]
    ids = port.tokenizer(texts)
    got = port.text_encode_fn(port.params, port.ids_tensor(ids)).numpy()
    assert bool(calls) is fused
    assert jax_fl.fused_batch_eligible(n, 16, jnp.float32) is fused
    want = np.asarray(jax_emb._encode_text(jax_emb.params,
                                           jnp.asarray(ids)))
    assert row_cosine(got, want).min() >= MIN_COS["float32"]
    np.testing.assert_allclose(port.embed_texts(texts),
                               jax_emb.embed_texts(texts), atol=2e-5)


def test_embedder_frames_match_jax(embedders):
    jax_emb, port = embedders
    frames = _frames(3, 40)
    feats_dev, got = port.embed_frames_device(frames)
    assert feats_dev.shape == (128, 128) and got.shape == (40, 128)
    want = jax_emb.embed_frames(frames)
    assert row_cosine(got, want).min() >= MIN_COS["float32"]
    np.testing.assert_allclose(got, want, atol=2e-5)
