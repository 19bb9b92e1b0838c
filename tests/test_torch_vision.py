"""Port vision tower vs the JAX package's, on the same weights (moved with
``params_from_jax``) and the same numpy-seeded frames, at the tiny tower
of ``tests/torch_parity.py`` (32 px frames, 8 px patches: S = 17; width
128, 2 heads of 64, 2 layers).

- ``normalize_images``: f32 within 1 ulp of the larger of ``x * scale``
  and the result (XLA fuses the multiply-add and skips the product's
  rounding; the port rounds the product, then subtracts), bf16 within
  one bf16 ulp;
- the module tower (``CLIP.encode_image``, attention through the port's
  ``attention``) vs flax ``CLIP.encode_image`` (Pallas attention in
  interpret mode), and the fused encode (plain halves on the CPU) vs JAX
  ``fused_vision_encode`` (Pallas layer kernels in interpret mode): f32
  within rtol/atol 2e-4 with per-row cosine >= 1 - 1e-5 (same math, other
  summation order), bf16 per-row cosine >= 0.999 (bf16 rounding at other
  points);
- ``attn_half_ref`` and ``mlp_half_ref`` vs the Pallas kernels
  ``_attn_half_call`` / ``_mlp_half_call`` run directly in interpret mode
  on the same ``_layer_operands``, causal and not: f32 atol 1e-5 (layer
  outputs of magnitude ~1, summation order only), bf16 within two bf16
  ulps at the residual stream's largest magnitude (the bf16 softmax chain
  rounds at other points: its sums accumulate in another precision, so a
  weight may land one ulp off and move the update by a few of its own
  ulps);
- the embedder's frames path (buckets, normalisation, routing) vs the
  JAX embedder's ``embed_frames`` on the same weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import TINY, port_state_dict, row_cosine
from video_quierer_tpu.models.clip.config import get_config
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxEmbedder
from video_quierer_tpu.models.clip.model import CLIP as FlaxCLIP
from video_quierer_tpu.models.clip.model import init_params as \
    jax_init_params
from video_quierer_tpu.ops import fused_layer as jax_fl
from video_quierer_tpu.ops.preprocess import normalize_images as jax_norm
from video_quierer_tpu_torch.models.clip import embedder as emb_mod
from video_quierer_tpu_torch.models.clip.config import \
    get_config as torch_get_config
from video_quierer_tpu_torch.models.clip.embedder import (
    IMAGE_BUCKETS,
    CLIPEmbedder,
)
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.ops import fused_layer as torch_fl
from video_quierer_tpu_torch.ops.preprocess import (
    CLIP_STD,
    normalize_images,
)

MIN_COS = {"float32": 1 - 1e-5, "bfloat16": 0.999}
F32_TOL = 2e-4
HALF_ATOL_F32 = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def towers():
    cfg = get_config(TINY)
    params = jax_init_params(FlaxCLIP(cfg, dtype=jnp.float32), seed=1)
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


def _frames(seed, b, size=32):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3),
                                                dtype=np.uint8)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at the magnitude of each element (8 significand
    bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_images_matches_jax(dtype):
    frames = np.concatenate([_frames(0, 3, 16),
                             np.arange(256, dtype=np.uint8).repeat(3)
                             .reshape(1, 16, 16, 3)])
    want = np.asarray(jax_norm(jnp.asarray(frames),
                               dtype=getattr(jnp, dtype))).astype(np.float64)
    got = normalize_images(torch.from_numpy(frames),
                           dtype=getattr(torch, dtype)).double().numpy()
    if dtype == "float32":
        product = frames / (255 * np.asarray(CLIP_STD))
        ulp = np.spacing(np.maximum(np.abs(product), np.abs(want))
                         .astype(np.float32)).astype(np.float64)
    else:
        ulp = _bf16_ulp(want)
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_tower_matches_flax(towers, dtype):
    cfg, model, jparams, port = _both(towers, dtype)
    frames = _frames(10, 5)
    want = np.asarray(model.apply(
        {"params": jparams}, jax_norm(jnp.asarray(frames),
                                      dtype=getattr(jnp, dtype)),
        method=FlaxCLIP.encode_image))
    with torch.inference_mode():
        got = port.encode_image(normalize_images(
            torch.from_numpy(frames), dtype=getattr(torch, dtype))).numpy()
    assert got.shape == want.shape == (5, 64)
    assert row_cosine(got, want).min() >= MIN_COS[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_encode_matches_jax(towers, dtype):
    cfg, _, jparams, port = _both(towers, dtype)
    frames = _frames(20, 32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_fl.fused_vision_encode(
        jparams, jax_norm(jnp.asarray(frames), dtype=jdt), cfg=cfg,
        dtype=jdt))
    ops = [torch_fl._layer_operands(b, tdt) for b in port.vision.layers]
    with torch.inference_mode():
        got = torch_fl.fused_vision_encode(
            port, normalize_images(torch.from_numpy(frames), dtype=tdt),
            ops).numpy()
    assert got.shape == want.shape == (32, 64)
    assert row_cosine(got, want).min() >= MIN_COS[dtype]
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               rtol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def _half_inputs(towers, dtype, b, s):
    cfg, _, jparams, port = _both(towers, dtype)
    d = cfg.vision.hidden_size
    x = np.random.default_rng(b * s).standard_normal(
        (b * s, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jops = jax_fl._layer_operands(jparams["vision"]["encoder"]["layers_0"],
                                  jdt)
    tops = torch_fl._layer_operands(port.vision.layers[0], tdt)
    return (cfg, jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt), jops,
            tops)


def _assert_half_close(got: torch.Tensor, want, x: torch.Tensor, dtype):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    atol = (HALF_ATOL_F32 if dtype == "float32"
            else 2 * _bf16_ulp(x.float().abs().max().item()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_half_matches_pallas_kernel(towers, dtype, causal):
    b, s = 4, 17
    cfg, jx, tx, jops, tops = _half_inputs(towers, dtype, b, s)
    eps, heads = cfg.vision.layer_norm_eps, cfg.vision.num_heads
    idr, idc = jax_fl._item_ids(b * s, s)
    want = jax_fl._attn_half_call(jx, idr, idc, *jops[:5], heads=heads,
                                  eps=eps, causal=causal, interpret=True)
    got = torch_fl.attn_half_ref(tx, tops, s=s, heads=heads, eps=eps,
                                 causal=causal)
    _assert_half_close(got, want, tx, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_half_matches_pallas_kernel(towers, dtype):
    b, s = 4, 17
    cfg, jx, tx, jops, tops = _half_inputs(towers, dtype, b, s)
    eps = cfg.vision.layer_norm_eps
    want = jax_fl._mlp_half_call(jx, jops[0], *jops[5:], t=2 * s, eps=eps,
                                 act="quick_gelu", interpret=True)
    got = torch_fl.mlp_half_ref(tx, tops, eps=eps)
    _assert_half_close(got, want, tx, dtype)


def test_vision_tower_eligibility():
    from video_quierer_tpu_torch.models.clip.config import (
        CLIPVisionConfig,
    )
    assert torch_fl.fused_vision_tower_eligible(CLIPVisionConfig())
    assert torch_fl.fused_vision_tower_eligible(
        CLIPVisionConfig(patch_size=14, hidden_size=1024, num_heads=16))
    assert not torch_fl.fused_vision_tower_eligible(
        CLIPVisionConfig(num_heads=8))                    # 96-wide heads
    assert not torch_fl.fused_vision_tower_eligible(
        CLIPVisionConfig(moe_experts=4))
    # every image bucket of ViT-B/32 (S = 50) clears the batch gate
    assert all(torch_fl.fused_batch_eligible(b, 50) for b in IMAGE_BUCKETS)


@pytest.mark.parametrize("n", [5, 300])
def test_embed_frames_matches_jax_embedder(towers, monkeypatch, n):
    """Buckets, chunking and routing: every bucket takes the fused encode
    (spied), device rows past N are padding, rows match JAX's."""
    cfg, params = towers
    jax_emb = JaxEmbedder(TINY, dtype=jnp.float32, seed=1)
    calls = []
    real = emb_mod.fused_vision_encode

    def spy(model, pixels, *a, **kw):
        calls.append(pixels.shape[0])
        return real(model, pixels, *a, **kw)

    monkeypatch.setattr(emb_mod, "fused_vision_encode", spy)
    emb = CLIPEmbedder(TINY, dtype=torch.float32, device="cpu",
                       state_dict=port_state_dict(jax_emb.params))
    frames = _frames(30 + n, n)
    feats_dev, got = emb.embed_frames_device(frames)
    want = jax_emb.embed_frames(frames)
    assert calls == ([32] if n == 5 else [256, 128])
    assert feats_dev.shape == (sum(calls), 64) and got.shape == (n, 64)
    assert torch.equal(feats_dev[:n], torch.from_numpy(got))
    assert row_cosine(got, want).min() >= MIN_COS["float32"]
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    assert np.array_equal(emb.embed_frames(frames), got)
