"""AIMv2's kernels on the card against their plain versions: B3 at head
width 128 (causal and not, masked keys, the text and vision lengths), the
B5 half with RMSNorm and bias-free projections, the B6 half with the
SiLU-gated epilogue, and both fused encodes. Imports torch, numpy and the
port only, so it runs on a GPU machine without ``transformers`` or the
JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_aimv2_kernels.py

Every test but ``test_refusals_off_the_card`` carries the ``gpu`` marker
and skips without a CUDA card (the kernels run only there). Tolerances,
as ``tests/test_torch_kernels.py`` sets B3's, B5's and B6's: B3 f32 atol
1e-5, bf16 2e-2 (exact products summed in another order, so the bf16
softmax's denominator may round to the neighbouring value); the halves
f32 atol 1e-4 (sums of up to 2,816 products in another order), bf16
within two bf16 ulps at the largest input magnitude (a GEMM output may
round to the other side of a tie); the encodes per-row cosine >= 1 -
1e-5 in f32, >= 0.999 in bf16.
"""

import numpy as np
import pytest
import torch

from video_quierer_tpu_torch.models.aimv2 import config as ac
from video_quierer_tpu_torch.models.aimv2.convert import (
    convert_hf_state_dict,
    init_hf_state_dict,
)
from video_quierer_tpu_torch.models.aimv2.fused import (
    fused_aimv2_text_encode,
    fused_aimv2_vision_encode,
    gated_operands,
)
from video_quierer_tpu_torch.models.aimv2.model import AIMv2
from video_quierer_tpu_torch.ops import fused_layer as fl
from video_quierer_tpu_torch.ops import kernels
from video_quierer_tpu_torch.ops.attention import attention, attention_ref

ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MIN_COS = {torch.float32: 1 - 1e-5, torch.bfloat16: 0.999}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, *shape, scale=1.0):
    return torch.randn(*shape, generator=torch.Generator()
                       .manual_seed(seed)) * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,heads,valid,causal", [
    (1, 8, 6, 8, True), (64, 16, 6, 16, True), (64, 77, 6, 77, True),
    (3, 50, 8, 33, False), (32, 256, 8, 256, False),
    (4, 256, 8, 200, True), (2, 272, 8, 272, False)])
def test_attention_kernel_head_width_128(cuda, dtype, b, s, heads, valid,
                                         causal):
    q, k, v = (_rand(i, b, s, 128 * heads, scale=0.5).to(cuda, dtype)
               for i in range(3))
    before = attention.launches, attention.launches_hd128
    got = attention(q, k, v, num_heads=heads, valid_len=valid, causal=causal)
    torch.cuda.synchronize()
    assert (attention.launches, attention.launches_hd128) == \
        (before[0] + 1, before[1] + 1)
    qs = (q.float() * 128 ** -0.5).to(dtype)
    want = attention_ref(qs, k, v, num_heads=heads, valid_len=valid,
                         causal=causal)
    torch.testing.assert_close(got[:, :valid].float(),
                               want[:, :valid].float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 96, 256])
def test_attention_refuses_other_head_widths(cuda, hd):
    q = torch.zeros(2, 16, 2 * hd, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention(q, q, q, num_heads=2)
    err = kernels.lib().vqt_attention(
        kernels.ptr(q), kernels.ptr(q), kernels.ptr(q), kernels.ptr(q), 2,
        16, 2, hd, 2 * hd, 2 * hd, 16, 0, 1.0, 1.0, kernels.dtype_code(q),
        kernels.stream(cuda))
    assert err != 0


def test_refusals_off_the_card():
    """On the CPU every head width takes the plain version; the operand
    checks of the gated halves run only on the card."""
    q = _rand(0, 2, 8, 192)
    torch.testing.assert_close(
        attention(q, q, q, num_heads=2),
        attention_ref((q * 96 ** -0.5), q, q, num_heads=2, valid_len=8,
                      causal=False))


def _gated_layer(dtype, device, t, d=1024, f=2816, seed=0):
    """N(0, 1) activations of ``t`` tokens and one AIMv2 block's
    operands: LeCun-scaled matrices, RMSNorm scales near 1."""
    rms = 1 + _rand(seed, 2, d, scale=0.1)
    mats = (_rand(seed + 1, d, 3 * d, scale=d ** -0.5),
            _rand(seed + 2, d, d, scale=d ** -0.5),
            fl.interleave_gate_up(_rand(seed + 3, d, f, scale=d ** -0.5),
                                  _rand(seed + 4, d, f, scale=d ** -0.5)),
            _rand(seed + 5, f, d, scale=f ** -0.5))
    ops = (rms.to(device),) + tuple(m.to(device, dtype) for m in mats)
    return _rand(seed + 6, t, d).to(device, dtype), ops


def _half_atol(x):
    if x.dtype == torch.float32:
        return 1e-4
    top = x.float().abs().max().item()
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)     # two bf16 ulps


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,d,heads,causal", [
    (1, 256, 1024, 8, False), (3, 256, 1024, 8, False),
    (32, 256, 1024, 8, False), (64, 16, 768, 6, True),
    (8, 77, 768, 6, True)])
def test_rms_attn_half_kernel(cuda, dtype, b, s, d, heads, causal):
    x, ops = _gated_layer(dtype, cuda, b * s, d=d, f=2048 if d == 768
                          else 2816)
    before = fl.rms_attn_half.launches
    got = fl.rms_attn_half(x, ops, s=s, heads=heads, eps=1e-5,
                           causal=causal)
    torch.cuda.synchronize()
    assert fl.rms_attn_half.launches == before + 1
    want = fl.rms_attn_half_ref(x, ops, s=s, heads=heads, eps=1e-5,
                                causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_half_atol(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,f", [(256, 1024, 2816), (3 * 256, 1024, 2816),
                                   (32 * 256, 1024, 2816),
                                   (64 * 16, 768, 2048), (150, 256, 96)])
def test_gated_mlp_half_kernel(cuda, dtype, t, d, f):
    """At AIMv2-L/14's vision and text widths, and a tail tile (T = 150)
    at an F of three 32-feature tiles."""
    x, ops = _gated_layer(dtype, cuda, t, d=d, f=f, seed=10)
    before = fl.gated_mlp_half.launches
    got = fl.gated_mlp_half(x, ops, eps=1e-5)
    torch.cuda.synchronize()
    assert fl.gated_mlp_half.launches == before + 1
    want = fl.gated_mlp_half_ref(x, ops, eps=1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_half_atol(x))


@pytest.mark.gpu
def test_gated_halves_refuse_bad_operands(cuda):
    x, ops = _gated_layer(torch.bfloat16, cuda, 512, d=768, f=2048)
    with pytest.raises(ValueError):                 # 96-wide heads
        fl.rms_attn_half(x, ops, s=256, heads=8, eps=1e-5, causal=False)
    with pytest.raises(ValueError):                 # 256 does not divide 500
        fl.rms_attn_half(x[:500], ops, s=256, heads=6, eps=1e-5,
                         causal=False)
    with pytest.raises(ValueError):                 # F % 32
        fl.gated_mlp_half(x, ops[:3] + (ops[3][:, :2 * 2040].contiguous(),
                                        ops[4][:2040]), eps=1e-5)


def _model(dtype, device, layers=2):
    """AIMv2-L/14 LiT at its published widths with ``layers`` blocks a
    tower, on seeded weights."""
    c = ac.get_config("aimv2-l14-lit")
    cfg = ac.AIMv2Config(
        vision=ac.AIMv2VisionConfig(num_layers=layers),
        text=ac.AIMv2TextConfig(num_layers=layers),
        projection_dim=c.projection_dim)
    sd = convert_hf_state_dict(init_hf_state_dict(
        cfg, torch.Generator().manual_seed(1)), cfg)
    model = AIMv2(cfg)
    model.load_state_dict(sd)
    return model.to(device, dtype).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_aimv2_encodes_kernels(cuda, dtype):
    model = _model(dtype, cuda)
    vops, tops = ([gated_operands(b, dtype) for b in tower.encoder.layers]
                  for tower in (model.vision_model, model.text_model))
    pixels = _rand(5, 32, 224, 224, 3).to(cuda, dtype)
    ids = torch.randint(1, 49406, (64, 16), generator=torch.Generator()
                        .manual_seed(6)).to(cuda)
    ids[:, 9:] = 49407
    before = fl.rms_attn_half.launches, fl.gated_mlp_half.launches
    with torch.inference_mode():
        got = (fused_aimv2_vision_encode(model, pixels, vops),
               fused_aimv2_text_encode(model, ids, tops))
        want = (fused_aimv2_vision_encode(model, pixels, vops,
                                          attn=fl.rms_attn_half_ref,
                                          mlp=fl.gated_mlp_half_ref),
                fused_aimv2_text_encode(model, ids, tops,
                                        attn=fl.rms_attn_half_ref,
                                        mlp=fl.gated_mlp_half_ref))
    torch.cuda.synchronize()
    assert (fl.rms_attn_half.launches, fl.gated_mlp_half.launches) == \
        (before[0] + 4, before[1] + 4)
    for g, w in zip(got, want):
        cos = torch.nn.functional.cosine_similarity(g, w, dim=-1)
        assert cos.min().item() >= MIN_COS[dtype]
        norms = torch.linalg.vector_norm(g, dim=-1)
        assert (norms - 1).abs().max().item() <= 1e-5
