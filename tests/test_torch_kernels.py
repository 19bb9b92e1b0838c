"""The port's CUDA kernels (video_quierer_tpu_torch/csrc/*.cu) vs their
plain PyTorch versions, on the card.

Imports torch, numpy and the port only (no jax), so the file also runs on
a GPU machine without the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Kernel tests carry the ``gpu`` marker and skip where no CUDA card is
present; the CPU tests check the wrappers' CPU routing and launch counts.
Tolerances: B1 exact (the inputs are multiples of 1/256, so every f32 dot
product is exact in any summation order); B2 per-row cosine >= 1 - 1e-5
in f32 and >= 0.999 in bf16; B3 f32 atol 1e-5, bf16 atol 2e-2 (under
autograd at the training shapes, its dq, dk, dv against autograd through
the plain version: f32 atol 1e-4, bf16 6e-2); B5 and B6
(one layer half at ViT-B/32 widths, N(0, 1) activations) f32 atol 1e-4
(sums of up to 3,072 products in another order), bf16 within two bf16
ulps at the largest input magnitude (a GEMM output may round to the
other side of a tie, and the bf16 softmax and residual carry it); B6
with tanh-GELU and fc1 outputs far below -10 as B6, at the larger of the
input's and the output's magnitude (the far negative tail bit for bit),
B2 with it per-row cosine as B2; the
whole vision encode per-row cosine as B2; B4 and B7
bit-identical (integer dot products are exact, and both versions multiply
the scales in the same order); B8 rows identical and scores equal on
exact inputs (on f32 rows past B = 8 too, whose 3xTF32 tile then has
zero small parts and exact sums), rows identical and scores within rtol
1e-5 on random unit rows (the kernel sums in another order than cuBLAS),
and on unnormalised N(0, 1e3^2) rows also against f64 host scores; B12
as B8, pads
(-inf, -1) in the same places, also for a pair on tile 4,096 and beyond
(64-bit tile offsets: 8.6 GB of tiles on the card), one pair split over
16 CTAs, 9-40 queries on one tile, every pair on the padding tile, and
the pair lists of B = 256 and of two plan windows; B9 and B8 over bf16
rows as B8 (rows and scores identical on exact inputs); B10 exact and
B11 bit-identical, as B1 and B4. With two or more cards, a corpus mesh
over the cards returns the rows and scores of the same mesh with every
shard on the first card, bit for bit (the same kernels on the same
shards; only the copies between cards differ).
"""

import numpy as np
import pytest
import torch

from video_quierer_tpu_torch.api.multipart import parse_multipart
from video_quierer_tpu_torch.index import device_index, ivf
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.models.clip.bridge import init_params
from video_quierer_tpu_torch.models.clip.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    get_config,
)
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.ops import fused_layer as fl
from video_quierer_tpu_torch.ops import topk
from video_quierer_tpu_torch.ops.attention import attention, attention_ref
from video_quierer_tpu_torch.ops.quantize import (
    quantize_rows,
    quantize_rows_int4,
)
from video_quierer_tpu_torch.parallel.mesh import CorpusMesh, corpus_mesh
from video_quierer_tpu_torch.utils.env import resolve_device

ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MIN_COS = {torch.float32: 1 - 1e-5, torch.bfloat16: 0.999}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    """The card; decided at run time, so collection is the same
    everywhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _exact(seed, shape):
    """Multiples of 1/256 in [-1/4, 1/4]: exact in bf16."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.integers(-64, 65, shape) / 256)
                            .astype(np.float32))


def _text_model(name_or_cfg, dtype, device):
    cfg = (get_config(name_or_cfg) if isinstance(name_or_cfg, str)
           else name_or_cfg)
    model = CLIP(cfg)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    return model.to(device, dtype).eval()


def _ids(b, s, vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab - 2, size=(b, s))
    ids[np.arange(b), rng.integers(s // 2, s, size=b)] = vocab - 1
    return torch.from_numpy(ids).long()


# -- CPU routing (runs everywhere) ---------------------------------------

def test_resolve_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _launch_counts():
    return (attention.launches, fl.fused_layer.launches,
            fl.attn_half.launches, fl.mlp_half.launches,
            topk.cand_scan_prefix.launches,
            topk.cand_scan_int8_prefix.launches,
            topk.cand_scan_int4_prefix.launches, topk.block_scan.launches,
            ivf.probe_scan.launches, topk.cand_scan.launches,
            topk.cand_scan_int8.launches, topk.block_scan_bf16.launches,
            topk.block_scan_int8.launches)


def test_cpu_tensors_take_the_plain_versions():
    counts = _launch_counts()
    q = _exact(0, (2, 8, 128))
    attention(q, q, q, num_heads=2, causal=True)
    topk.cand_scan_prefix(_exact(1, (8192, 64)), _exact(2, (3, 64)), 5000,
                          bucket=1024, rounds=2)
    codes, scales = quantize_rows(_exact(1, (8192, 128)))
    packed, scales4 = quantize_rows_int4(_exact(1, (8192, 128)))
    qc, qs = quantize_rows(_exact(2, (3, 128)))
    topk.cand_scan_int8_prefix(codes, scales, qc, qs, 5000, bucket=1024,
                               rounds=2)
    topk.cand_scan_int4_prefix(packed, scales4, qc, qs, 5000, bucket=1024,
                               rounds=2)
    topk.cosine_topk(_exact(1, (3000, 64)), _exact(2, (3, 64)), 2500, k=10)
    perm = torch.randperm(8192, generator=torch.Generator().manual_seed(0))
    perm = perm.int()
    topk.cand_scan(_exact(1, (8192, 64)), perm, _exact(2, (3, 64)), 5000,
                   bucket=1024, rounds=2)
    topk.cand_scan_int8(codes, scales, perm, qc, qs, 5000, bucket=1024,
                        rounds=2)
    topk.cosine_topk(_exact(1, (3000, 64)).bfloat16(), _exact(2, (3, 64)),
                     2500, k=10)
    topk.cosine_topk_int8(codes, scales, _exact(2, (3, 128)), 5000, k=10)
    ivf.probe_scan(_exact(1, (2, 1024, 64)), torch.zeros(2, 1024,
                                                         dtype=torch.int32),
                   torch.tensor([0, 1], dtype=torch.int32),
                   torch.tensor([1, 0], dtype=torch.int32),
                   _exact(2, (2, 64)), k=5)
    cfg = CLIPConfig(projection_dim=64, text=CLIPTextConfig(
        vocab_size=100, hidden_size=128, num_layers=1, num_heads=2),
        vision=CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=128,
                                num_layers=1, num_heads=2))
    model = _text_model(cfg, torch.float32, "cpu")
    ops = [fl._layer_operands(b, torch.float32) for b in model.text.layers]
    out = fl.fused_text_encode(model, _ids(32, 8, 100), ops)
    assert out.shape == (32, 64)
    ops = [fl._layer_operands(b, torch.float32) for b in model.vision.layers]
    out = fl.fused_vision_encode(model, _exact(3, (32, 32, 32, 3)), ops)
    assert out.shape == (32, 64)
    assert _launch_counts() == counts


def test_gelu_tanh_routes_to_the_plain_version_on_cpu():
    """``act`` reaches the plain versions on CPU tensors (no launch), and
    an unknown activation raises before anything runs."""
    counts = _launch_counts()
    ops = _layer(128, 512, "cpu", seed=0, dtype=torch.float32)
    x = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
    want = fl.mlp_half_ref(x, ops, eps=1e-6, act="gelu_tanh")
    assert torch.equal(fl.mlp_half(x, ops, eps=1e-6, act="gelu_tanh"), want)
    assert not torch.equal(fl.mlp_half(x, ops, eps=1e-6), want)
    got = fl.fused_layer(x, ops, s=16, heads=2, eps=1e-6, act="gelu_tanh")
    x3 = fl.attn_half_ref(x, ops, s=16, heads=2, eps=1e-6, causal=True)
    assert torch.equal(got, fl.mlp_half_ref(x3, ops, eps=1e-6,
                                            act="gelu_tanh"))
    for call in (lambda: fl.mlp_half(x, ops, eps=1e-6, act="relu"),
                 lambda: fl.fused_layer(x, ops, s=16, heads=2, eps=1e-6,
                                        act="gelu")):
        with pytest.raises(ValueError, match="activation"):
            call()
    assert _launch_counts() == counts


# -- kernels vs plain, on the card ---------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,valid,causal", [(1, 8, 8, True),
                                              (64, 77, 77, True),
                                              (3, 50, 33, False)])
def test_attention_kernel(cuda, dtype, b, s, valid, causal):
    q, k, v = (torch.randn(b, s, 512, generator=torch.Generator()
                           .manual_seed(i)).mul(0.5).to(cuda, dtype)
               for i in range(3))
    before = attention.launches
    got = attention(q, k, v, num_heads=8, valid_len=valid, causal=causal)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    qs = (q.float() * 64 ** -0.5).to(dtype)
    want = attention_ref(qs, k, v, num_heads=8, valid_len=valid,
                         causal=causal)
    torch.testing.assert_close(got[:, :valid].float(),
                               want[:, :valid].float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [8, 16])
def test_fused_layer_kernel(cuda, dtype, s):
    model = _text_model("openai/clip-vit-base-patch32", dtype, cuda)
    ops = [fl._layer_operands(b, dtype) for b in model.text.layers[:2]]
    ids = _ids(64, s, 49408).to(cuda)
    before = fl.fused_layer.launches
    with torch.inference_mode():
        got = fl.fused_text_encode(model, ids, ops)
        want = fl.fused_text_encode(model, ids, ops, layer=fl.fused_layer_ref)
    torch.cuda.synchronize()
    assert fl.fused_layer.launches == before + len(ops)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert cos.min().item() >= MIN_COS[dtype]


def _vision_layer(dtype, device, b, seed=0, d=768, f=3072):
    """N(0, 1) activations of ``b`` frames (S = 50) and one ViT-B/32
    layer's operands: LeCun-scaled weights, small biases, LN rows near
    (1, 0)."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    ln = torch.stack([1 + rnd(d, scale=0.1), rnd(d, scale=0.1),
                      1 + rnd(d, scale=0.1), rnd(d, scale=0.1)])
    mats = (rnd(d, 3 * d, scale=d ** -0.5), rnd(3 * d, scale=0.02),
            rnd(d, d, scale=d ** -0.5), rnd(d, scale=0.02),
            rnd(d, f, scale=d ** -0.5), rnd(f, scale=0.02),
            rnd(f, d, scale=f ** -0.5), rnd(d, scale=0.02))
    ops = (ln.to(device),) + tuple(m.to(device, dtype) for m in mats)
    return rnd(b * 50, d).to(device, dtype), ops


def _half_atol(x):
    if x.dtype == torch.float32:
        return 1e-4
    top = x.float().abs().max().item()
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)     # two bf16 ulps


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [3, 32, 128, 256])
def test_attn_half_kernel(cuda, dtype, b):
    """B5 at every image bucket (T = 1,600 / 6,400 / 12,800) and a tail
    tile (B = 3: T = 150, items straddling the 64-row tiles)."""
    x, ops = _vision_layer(dtype, cuda, b)
    before = fl.attn_half.launches
    got = fl.attn_half(x, ops, s=50, heads=12, eps=1e-5, causal=False)
    torch.cuda.synchronize()
    assert fl.attn_half.launches == before + 1
    want = fl.attn_half_ref(x, ops, s=50, heads=12, eps=1e-5, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_half_atol(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [3, 32, 128, 256])
def test_mlp_half_kernel(cuda, dtype, b):
    """B6 at every image bucket and a tail tile."""
    x, ops = _vision_layer(dtype, cuda, b, seed=1)
    before = fl.mlp_half.launches
    got = fl.mlp_half(x, ops, eps=1e-5)
    torch.cuda.synchronize()
    assert fl.mlp_half.launches == before + 1
    want = fl.mlp_half_ref(x, ops, eps=1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_half_atol(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_vision_encode_kernels(cuda, dtype):
    cfg = CLIPConfig(vision=CLIPVisionConfig(num_layers=2),
                     text=CLIPTextConfig(num_layers=1))
    model = _text_model(cfg, dtype, cuda)
    ops = [fl._layer_operands(b, dtype) for b in model.vision.layers]
    pixels = torch.randn(32, 224, 224, 3, generator=torch.Generator()
                         .manual_seed(5)).to(cuda, dtype)
    before = fl.attn_half.launches, fl.mlp_half.launches
    with torch.inference_mode():
        got = fl.fused_vision_encode(model, pixels, ops)
        want = fl.fused_vision_encode(model, pixels, ops,
                                      attn=fl.attn_half_ref,
                                      mlp=fl.mlp_half_ref)
    torch.cuda.synchronize()
    assert (fl.attn_half.launches, fl.mlp_half.launches) == \
        (before[0] + 2, before[1] + 2)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert cos.min().item() >= MIN_COS[dtype]
    norms = torch.linalg.vector_norm(got, dim=-1)
    assert (norms - 1).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_layer_halves_refuse_bad_operands(cuda):
    x, ops = _vision_layer(torch.bfloat16, cuda, 2)
    with pytest.raises(ValueError):                 # 50 does not divide 70
        fl.attn_half(x[:70], ops, s=50, heads=12, eps=1e-5, causal=False)
    with pytest.raises(ValueError):                 # head width 96
        fl.attn_half(x, ops, s=50, heads=8, eps=1e-5, causal=False)
    with pytest.raises(ValueError):                 # f32 weights, bf16 x
        fl.mlp_half(x, (ops[0],) + tuple(o.float() for o in ops[1:]),
                    eps=1e-5)
    with pytest.raises(ValueError):                 # operands on the CPU
        fl.mlp_half(x, tuple(o.cpu() for o in ops), eps=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [8, 16, 50, 77, 197, 257])
@pytest.mark.parametrize("b", [1, 64, 256])
def test_attention_tensor_core_shapes(cuda, b, s, causal):
    """B3's bf16 tensor-core kernel at every length it serves (text 8/16/77,
    ViT-B/32 50, B/16 197, L/14 257: one or two 64-key chunks, one or
    several pairs a CTA) with masked keys (valid < S). atol 2e-2: the bf16
    weights are exact products summed in another order, so den may round
    to the neighbouring bf16 value."""
    valid = s - s // 4
    q, k, v = (_exact(10 * s + i, (b, s, 512)).mul(4).to(cuda, torch.bfloat16)
               for i in range(3))
    before = attention.launches
    got = attention(q, k, v, num_heads=8, valid_len=valid, causal=causal)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    qs = (q.float() * 64 ** -0.5).bfloat16()
    want = attention_ref(qs, k, v, num_heads=8, valid_len=valid,
                         causal=causal)
    torch.testing.assert_close(got[:, :valid].float(),
                               want[:, :valid].float(), atol=2e-2, rtol=0)


# B3 under autograd: forward atol as B3's, dq/dk/dv f32 1e-4 (two f32
# matmul chains in other orders), bf16 6e-2 (tests/test_torch_train.py)
GRAD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,heads,causal", [(50, 12, False), (77, 8, True)])
def test_attention_function_at_the_training_shapes(cuda, dtype, s, heads,
                                                   causal):
    """B3's autograd Function at the trainer's shapes (ViT-B/32 vision: B
    = 64, S = 50, 12 heads; text: S = 77, causal, 8 heads): one kernel
    launch forward, none backward (the einsum VJP), output and gradients
    against autograd through the plain version (q pre-scaled in the
    graph)."""
    g = torch.Generator().manual_seed(s)
    q, k, v, grad = (torch.randn(64, s, 64 * heads, generator=g).mul(0.5)
                     .to(cuda, dtype) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = attention.launches
    out = attention(*leaves, num_heads=heads, causal=causal)
    out.backward(grad)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    qs = (plain[0].float() * 64 ** -0.5).to(dtype)
    want = attention_ref(qs, plain[1], plain[2], num_heads=heads,
                         valid_len=s, causal=causal)
    want.backward(grad)
    torch.testing.assert_close(out.detach().float(), want.detach().float(),
                               atol=ATOL[dtype], rtol=0)
    for a, b in zip(leaves, plain):
        assert a.grad.dtype == dtype
        torch.testing.assert_close(a.grad.float(), b.grad.float(),
                                   atol=GRAD_ATOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 32, 256])
def test_attention_siglip_vision_shape(cuda, dtype, b):
    """B3 at the SigLIP vision tower's shape: S = 196 (no class token:
    keys in three 80-key chunks, the last 36 wide, so the two-pass
    branch), 12 heads, non-causal, every key valid."""
    q, k, v = (torch.randn(b, 196, 768, generator=torch.Generator()
                           .manual_seed(30 + i)).mul(0.5).to(cuda, dtype)
               for i in range(3))
    before = attention.launches
    got = attention(q, k, v, num_heads=12, causal=False)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    qs = (q.float() * 64 ** -0.5).to(dtype)
    want = attention_ref(qs, k, v, num_heads=12, valid_len=196,
                         causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,heads", [(16, 8), (50, 12), (77, 8)])
def test_attention_strided_qkv_layout(cuda, s, heads, causal):
    """The layout the layer halves pass: q, k, v the column blocks of one
    [B*S, 3D] QKV buffer (row stride 3D), the output [B*S, D], the hd^-0.5
    scale on the f32 logits."""
    from video_quierer_tpu_torch.ops import kernels

    b, d = 32, 64 * heads
    qkv = _exact(s, (b * s, 3 * d)).mul(4).to(cuda, torch.bfloat16)
    out = torch.empty(b * s, d, device=cuda, dtype=torch.bfloat16)
    base, col = qkv.data_ptr(), d * 2
    kernels.check(kernels.lib().vqt_attention(
        base, base + col, base + 2 * col, kernels.ptr(out), b, s, heads, 64,
        3 * d, d, s, int(causal), 1.0, 0.125, kernels.dtype_code(qkv),
        kernels.stream(cuda)), "attention")
    torch.cuda.synchronize()
    q, k, v = (qkv[:, i * d:(i + 1) * d].reshape(b, s, d) for i in range(3))
    want = attention_ref(q, k, v, num_heads=heads, valid_len=s,
                         causal=causal, scale=0.125)
    torch.testing.assert_close(out.float().reshape(b, s, d), want.float(),
                               atol=2e-2, rtol=0)


def _layer(d, f, device, seed, dtype=torch.bfloat16):
    """One layer's operands at width ``d`` (as _vision_layer)."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    ln = torch.stack([1 + rnd(d, scale=0.1), rnd(d, scale=0.1),
                      1 + rnd(d, scale=0.1), rnd(d, scale=0.1)])
    mats = (rnd(d, 3 * d, scale=d ** -0.5), rnd(3 * d, scale=0.02),
            rnd(d, d, scale=d ** -0.5), rnd(d, scale=0.02),
            rnd(d, f, scale=d ** -0.5), rnd(f, scale=0.02),
            rnd(f, d, scale=f ** -0.5), rnd(d, scale=0.02))
    return (ln.to(device),) + tuple(m.to(device, dtype) for m in mats)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1024, 1600, 6400, 12800])
@pytest.mark.parametrize("d", [512, 768])
def test_layer_gemm_shapes(cuda, d, m):
    """The TMA + wgmma GEMM through every prologue/epilogue it serves (LN +
    bias: QKV; bias + residual: out-proj and fc2; LN + bias + quick-GELU:
    fc1) at the text (512) and vision (768) widths and every M of the
    paths: each tile shape (128x128, 128x64, 64x64) and ragged last tiles.
    Tolerance as the halves' tests: two bf16 ulps at the largest
    magnitude (sums of bf16 products in another order may round a GEMM
    output to the other side); the whole text block per-row cosine as
    B2."""
    s = 50 if m % 50 == 0 else 16
    heads, causal = d // 64, d == 512
    ops = _layer(d, 4 * d, cuda, seed=m + d)
    x = torch.randn(m, d, generator=torch.Generator().manual_seed(m)).to(
        cuda, torch.bfloat16)
    got = fl.attn_half(x, ops, s=s, heads=heads, eps=1e-5, causal=causal)
    want = fl.attn_half_ref(x, ops, s=s, heads=heads, eps=1e-5,
                            causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_half_atol(x))
    got = fl.mlp_half(x, ops, eps=1e-5)
    want = fl.mlp_half_ref(x, ops, eps=1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_half_atol(x))
    if causal:
        got = fl.fused_layer(x, ops, s=s, heads=heads, eps=1e-5)
        want = fl.fused_layer_ref(x, ops, s=s, heads=heads, eps=1e-5)
        cos = torch.nn.functional.cosine_similarity(got.float(),
                                                    want.float(), dim=-1)
        assert cos.min().item() >= MIN_COS[torch.bfloat16]


def _gelu_tanh_layer(d, t, device, dtype, seed):
    """``t`` tokens and one layer's operands at width ``d`` (F = 4 d) with
    fc1 scaled 8x, so that LN2's unit rows give fc1 outputs of std ~8:
    many below -10, where the kernel form's exp(-2u) overflows to inf and
    the activation is -0."""
    ops = list(_layer(d, 4 * d, device, seed=seed, dtype=dtype))
    ops[5] = ops[5] * 8
    x = torch.randn(t, d, generator=torch.Generator().manual_seed(seed))
    return x.to(device, dtype), tuple(ops)


def _wide_atol(x, want):
    """f32: 1e-4 a unit of magnitude (sums of up to 3,072 products in
    another order); bf16: two bf16 ulps at the larger of the input's and
    the output's largest magnitude (the tanh-GELU outputs reach ~30)."""
    top = max(x.float().abs().max().item(), want.float().abs().max().item())
    if x.dtype == torch.float32:
        return 1e-4 * max(1.0, top)
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,t", [(128, 200), (128, 4096), (768, 200),
                                 (768, 4096)])
def test_mlp_half_gelu_tanh_kernel(cuda, dtype, d, t):
    """B6 with tanh-GELU at the SigLIP text shape (T = 64 queries x 64
    tokens, D = 768) and the tiny test width, with fc1 outputs far below
    -10: against its plain version, element by element."""
    x, ops = _gelu_tanh_layer(d, t, cuda, dtype, seed=d + t)
    z = fl._ln_f32(x, ops[0][2], ops[0][3], 1e-6, dtype)
    h = fl._dot(z, ops[5], ops[6]).float()
    assert (h < -10).float().mean().item() > 0.05
    before = fl.mlp_half.launches
    got = fl.mlp_half(x, ops, eps=1e-6, act="gelu_tanh")
    torch.cuda.synchronize()
    assert fl.mlp_half.launches == before + 1
    want = fl.mlp_half_ref(x, ops, eps=1e-6, act="gelu_tanh")
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_wide_atol(x, want))
    quick = fl.mlp_half(x, ops, eps=1e-6)
    assert not torch.equal(quick, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [128, 768])
def test_fused_layer_gelu_tanh_kernel(cuda, dtype, d):
    """B2 (the causal block in one C call) with tanh-GELU, 64 items of S =
    16, fc1 outputs far below -10: per-row cosine as B2's test."""
    x, ops = _gelu_tanh_layer(d, 64 * 16, cuda, dtype, seed=d)
    before = fl.fused_layer.launches
    got = fl.fused_layer(x, ops, s=16, heads=d // 64, eps=1e-6,
                         act="gelu_tanh")
    torch.cuda.synchronize()
    assert fl.fused_layer.launches == before + 1
    want = fl.fused_layer_ref(x, ops, s=16, heads=d // 64, eps=1e-6,
                              act="gelu_tanh")
    assert torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(),
                                                dim=-1)
    assert cos.min().item() >= MIN_COS[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_tanh_kernel_negative_tail(cuda, dtype):
    """The epilogue on a known range: LN2 of a ramp, fc1 = 64 I and fc2 =
    I with zero biases, so the output is ``x + GELU(h)`` element by
    element with h spanning about -110 .. 110. Below -10 exp(-2u)
    overflows, the activation is -0 and the output is x, bit for bit;
    everywhere against the plain version."""
    d = 128
    ops = list(_layer(d, d, cuda, seed=1, dtype=dtype))
    ops[0] = torch.tensor([[1.0] * d, [0.0] * d] * 2, device=cuda)
    eye = torch.eye(d, device=cuda, dtype=dtype)
    zero = torch.zeros(d, device=cuda, dtype=dtype)
    ops[5:] = [eye * 64, zero, eye, zero]
    ops = tuple(o.contiguous() for o in ops)
    x = torch.linspace(-1, 1, d, device=cuda).repeat(64, 1).to(dtype)
    got = fl.mlp_half(x, ops, eps=1e-6, act="gelu_tanh")
    want = fl.mlp_half_ref(x, ops, eps=1e-6, act="gelu_tanh")
    torch.cuda.synchronize()
    h = fl._dot(fl._ln_f32(x, ops[0][2], ops[0][3], 1e-6, dtype), ops[5],
                ops[6]).float()
    tail = h < -10
    assert tail.float().mean().item() > 0.3
    assert torch.equal(got[tail], x[tail])
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_wide_atol(x, want))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 5, 16, 17, 64, 70, 256])
def test_cand_scan_kernel(cuda, b):
    emb = _exact(b, (4 * 4096, 512)).to(cuda, torch.bfloat16)
    q = _exact(100 + b, (b, 512)).to(cuda)
    valid = 2 * 4096 + 1500
    before = topk.cand_scan_prefix.launches
    kv, ki = topk.cand_scan_prefix(emb, q, valid, bucket=1024, rounds=2)
    torch.cuda.synchronize()
    assert topk.cand_scan_prefix.launches == before + 1
    pv, pi = topk.cand_scan_prefix_ref(emb, q, valid, bucket=1024,
                                       rounds=2, block_rows=4096)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)


def _check_cand_prefix(emb, q, valid, bucket, rounds):
    """B1 against its plain version: winners bit-identical."""
    before = topk.cand_scan_prefix.launches
    kv, ki = topk.cand_scan_prefix(emb, q, valid, bucket=bucket,
                                   rounds=rounds)
    torch.cuda.synchronize()
    assert topk.cand_scan_prefix.launches == before + 1
    pv, pi = topk.cand_scan_prefix_ref(emb, q, valid, bucket=bucket,
                                       rounds=rounds, block_rows=4096)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)
    return kv, ki


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 9, 63, 65, 128])
def test_cand_scan_query_chunk_edges(cuda, b):
    """The tile's query widths: the 16-wide panel's edge (B = 8, 9 past
    it), the 64-wide one's (63, 65), and two whole chunks (128)."""
    emb = _exact(b, (4 * 4096, 512)).to(cuda, torch.bfloat16)
    q = _exact(100 + b, (b, 512)).to(cuda)
    _check_cand_prefix(emb, q, 2 * 4096 + 1500, 1024, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("bucket", [128, 1024])
@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_cand_scan_rounds_and_buckets(cuda, rounds, bucket, b):
    emb = _exact(rounds, (4 * 4096, 512)).to(cuda, torch.bfloat16)
    q = _exact(200 + b, (b, 512)).to(cuda)
    _check_cand_prefix(emb, q, 4096 + 777, bucket, rounds)


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [0, 1, 700, 1024, 4096 + 1500,
                                   4 * 4096])
def test_cand_scan_valid_cuts(cuda, valid):
    """``valid`` inside a tile (700: tile 10 of bucket 0; 4096 + 1500),
    on a bucket's edge, past the mirror, and none live: buckets wholly
    past it emit -inf at their first positions."""
    emb = _exact(7, (4 * 4096, 512)).to(cuda, torch.bfloat16)
    q = _exact(8, (64, 512)).to(cuda)
    kv, ki = _check_cand_prefix(emb, q, valid, 1024, 2)
    dead = -(-valid // 1024)                 # first bucket wholly dead
    if dead < 16:
        assert bool(torch.isinf(kv.view(4, 2, 4, 64)
                                .transpose(1, 2).reshape(16, 2, 64)[dead:])
                    .all())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 64])
def test_cand_scan_duplicate_rows(cuda, b):
    """Equal scores inside one tile, across tiles and across warps of a
    bucket: the lowest position wins, as the packed key says."""
    emb = _exact(9, (4 * 4096, 512))
    emb[70:80] = emb[64:74].clone()          # same tile
    emb[300:340] = emb[100:140]              # another tile, same bucket
    emb[1000:1024] = emb[1024:1048]          # across a bucket edge
    emb[2048:3072] = emb[2048].clone()       # a whole bucket of one row
    emb = emb.to(cuda, torch.bfloat16)
    q = _exact(10, (b, 512)).to(cuda)
    _check_cand_prefix(emb, q, 3 * 4096, 1024, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 16, 17, 64, 65, 256])
def test_cand_scan_siglip_width(cuda, b):
    """B1 over a 768-wide bf16 mirror (SigLIP's rows: twelve 64-column
    boxes a tile, a 64 x 768 query panel of 96 KB, so fewer ring stages):
    winners bit-identical on exact inputs."""
    emb = _exact(b, (4 * 4096, 768)).to(cuda, torch.bfloat16)
    q = _exact(200 + b, (b, 768)).to(cuda)
    _check_cand_prefix(emb, q, 3 * 4096 + 700, 1024, 2)
    stages = topk.cand_ring_stages(emb, b, 2)
    assert 2 <= stages < topk.cand_ring_stages(emb[:, :512].contiguous(),
                                               b, 2) or b <= 16


@pytest.mark.gpu
def test_cand_scan_partial_box(cuda):
    """D = 96: the second 64-column TMA box is half past the row (zeros)."""
    emb = _exact(11, (4096, 96)).to(cuda, torch.bfloat16)
    q = _exact(12, (5, 96)).to(cuda)
    _check_cand_prefix(emb, q, 3000, 128, 2)


@pytest.mark.gpu
def test_cand_scan_unaligned_queries(cuda):
    """Queries 2 bytes off a 16-byte boundary: the wrapper hands the
    kernel an aligned copy."""
    emb = _exact(15, (4096, 512)).to(cuda, torch.bfloat16)
    flat = torch.zeros(3 * 512 + 1, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(3, 512)
    q.copy_(_exact(16, (3, 512)))
    _check_cand_prefix(emb, q, 3000, 1024, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 64])
def test_cand_scan_perm_dead_bucket(cuda, b):
    """B10 with every row of bucket 5 dead by perm (and bucket 9 all
    live): the dead bucket emits -inf at its first positions."""
    n, valid = 4 * 4096, 4 * 4096 + 777
    perm = _shard_perm(3, n, valid).numpy().copy()
    perm[5 * 1024:6 * 1024] = valid + np.arange(1024)
    perm[9 * 1024:10 * 1024] = np.arange(1024)
    perm = torch.from_numpy(perm).to(cuda)
    emb = _exact(13, (n, 512)).to(cuda, torch.bfloat16)
    q = _exact(14, (b, 512)).to(cuda)
    kv, ki = topk.cand_scan(emb, perm, q, valid, bucket=1024, rounds=2)
    pv, pi = topk.cand_scan_ref(emb, perm, q, valid, bucket=1024, rounds=2,
                                block_rows=4096)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)
    # bucket 5: block 1, entries r * 4 + 1
    assert bool(torch.isinf(kv[1, [1, 5]]).all())
    assert torch.equal(ki[1, [1, 5]].cpu(),
                       torch.tensor([5 * 1024, 5 * 1024 + 1])[:, None]
                       .expand(2, b).int())


def _unit(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=-1, keepdims=True))


def _codes_mirror(tier, seed, n=4 * 4096, d=512):
    """A quantized mirror with ties (rows repeated) and zero rows."""
    rows = _unit(seed, (n, d))
    rows[1000:1100] = rows[100:200]          # duplicates: equal keys
    rows[5000:5010] = 0                      # zero rows: scale 0
    return (quantize_rows if tier == "int8" else quantize_rows_int4)(rows)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["int8", "int4"])
@pytest.mark.parametrize("b", [1, 5, 16, 17, 64, 70, 256])
def test_cand_scan_codes_kernel(cuda, tier, b):
    codes, scales = (t.to(cuda) for t in _codes_mirror(tier, b))
    q_codes, qscale = quantize_rows(_unit(100 + b, (b, 512)).to(cuda))
    valid = 2 * 4096 + 1500
    kern, ref = {
        "int8": (topk.cand_scan_int8_prefix, topk.cand_scan_int8_prefix_ref),
        "int4": (topk.cand_scan_int4_prefix, topk.cand_scan_int4_prefix_ref),
    }[tier]
    before = kern.launches
    kv, ki = kern(codes, scales, q_codes, qscale, valid, bucket=1024,
                  rounds=2)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    pv, pi = ref(codes, scales, q_codes, qscale, valid, bucket=1024,
                 rounds=2, block_rows=4096)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 64])
@pytest.mark.parametrize("b", [1, 5, 16, 17, 64, 70, 256])
def test_block_scan_kernel(cuda, b, k):
    # 3000 rows: the last tile is short; valid cuts the second tile;
    # duplicated rows tie exactly
    emb = _exact(b, (3000, 512))
    emb[1500:1550] = emb[200:250]
    emb, q = emb.to(cuda), _exact(200 + b, (b, 512)).to(cuda)
    before = topk.block_scan.launches
    kv, ki = topk.block_scan(emb, q, 1700, k=k)
    torch.cuda.synchronize()
    assert topk.block_scan.launches == before + 1
    pv, pi = topk.block_scan_ref(emb, q, 1700, k=k,
                                 tile_rows=topk.SCAN_TILE_ROWS)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)
    # random unit rows: the summation order differs from cuBLAS
    emb, q = _unit(b, (5000, 512)).to(cuda), _unit(300 + b, (b, 512)).to(cuda)
    kv, ki = topk.cosine_topk(emb, q, 4321, k=k)
    pv, pi = topk.block_scan_ref(emb, q, 4321, k=k, tile_rows=5000)
    pv, pi = pv[0], pi[0]
    torch.testing.assert_close(kv, pv, rtol=1e-5, atol=0)
    # rows identical except where two scores tie within the tolerance
    gap = torch.full_like(pv, float("inf"))
    gap[:, 1:] = pv[:, :-1] - pv[:, 1:]
    gap[:, :-1] = torch.minimum(gap[:, :-1], pv[:, :-1] - pv[:, 1:])
    apart = gap > 1e-5 * pv.abs()
    assert torch.equal(ki[apart], pi[apart])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 64])
@pytest.mark.parametrize("b", [9, 65])
def test_block_scan_kernel_route_edges(cuda, b, k):
    """B = 9, the first batch on the 3xTF32 tile, and B = 65, a second
    64-query chunk holding one query, over 2 x 1,024 + 37 rows (a short
    last tile) with valid cutting the second tile: exact inputs, so rows
    and scores equal the plain version's bit for bit."""
    n = 2 * 1024 + 37
    emb = _exact(10 + b, (n, 512))
    emb[1500:1540] = emb[100:140]
    emb, q = emb.to(cuda), _exact(600 + b, (b, 512)).to(cuda)
    before = topk.block_scan.launches
    kv, ki = topk.block_scan(emb, q, 1024 + 400, k=k)
    torch.cuda.synchronize()
    assert topk.block_scan.launches == before + 1
    pv, pi = topk.block_scan_ref(emb, q, 1024 + 400, k=k,
                                 tile_rows=topk.SCAN_TILE_ROWS)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 16, 64])
def test_block_scan_kernel_wide_range(cuda, b):
    """Unnormalised N(0, 1e3^2) rows (neighbouring pairs 1e-4 of a norm
    apart): the tile lists' scores within rtol 1e-5 of the f64 host
    scores of their rows, and rows identical to the plain version's except
    where two scores tie within it. One TF32 product per element (the
    small parts dropped) is off by ~4e-4 relative here."""
    rng = np.random.default_rng(b)
    emb = rng.normal(0.0, 1e3, (3000, 512))
    emb[1::2] = emb[0::2] + 1e-4 * np.linalg.norm(
        emb[0::2], axis=-1, keepdims=True) * _unit(b, (1500, 512)).numpy()
    emb = torch.from_numpy(emb.astype(np.float32)).to(cuda)
    q = _unit(700 + b, (b, 512)).to(cuda)
    kv, ki = topk.block_scan(emb, q, 2900, k=10)
    torch.cuda.synchronize()
    live = torch.isfinite(kv)
    host = torch.einsum("tbkd,bd->tbk",
                        emb.double()[ki.clamp(max=2999).long()], q.double())
    torch.testing.assert_close(kv.double()[live], host[live], rtol=1e-5,
                               atol=0)
    pv, pi = topk.block_scan_ref(emb, q, 2900, k=10,
                                 tile_rows=topk.SCAN_TILE_ROWS)
    assert torch.equal(live, torch.isfinite(pv))
    _check_close_rows(*(t.reshape(-1, 10) for t in (kv, ki, pv, pi)))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [16, 64])
def test_block_scan_bf16_and_int8_keep_their_counts(cuda, b):
    """Past B = 8 only f32 rows take the 3xTF32 tile: bf16 rows and int8
    codes (the span tile) count under block_scan_bf16 and block_scan_int8,
    never under block_scan, and still match their plain versions at the
    span on exact inputs."""
    emb = _exact(b, (3000, 512))
    codes, scales = _codes_mirror("int8", b, n=3000)
    rows16, codes, scales = (emb.to(cuda, torch.bfloat16), codes.to(cuda),
                             scales.to(cuda))
    q = _exact(800 + b, (b, 512)).to(cuda)
    before = (topk.block_scan.launches, topk.block_scan_bf16.launches,
              topk.block_scan_int8.launches)
    hv, hi = topk.block_scan_bf16(rows16, q, 1700, k=10)
    iv, ii = topk.block_scan_int8(codes, scales, q, 1700, k=10)
    torch.cuda.synchronize()
    assert (topk.block_scan.launches, topk.block_scan_bf16.launches,
            topk.block_scan_int8.launches) == \
        (before[0], before[1] + 1, before[2] + 1)
    pv, pi = topk.block_scan_ref(rows16, q, 1700, k=10,
                                 tile_rows=topk.SCAN_SPAN_ROWS)
    torch.testing.assert_close(hv, pv, rtol=0, atol=0)
    assert torch.equal(hi, pi)
    pv, pi = topk.block_scan_int8_ref(codes, scales,
                                      topk._int8_scan_queries(q, 3000),
                                      1700, k=10,
                                      tile_rows=topk.SCAN_SPAN_ROWS)
    torch.testing.assert_close(iv, pv, rtol=0, atol=0)
    assert torch.equal(ii, pi)


def _shard_perm(seed, n, valid, live=True):
    """A corpus shard's perm column: ``n`` distinct host rows drawn from
    ``[0, 2n)`` around the global ``valid``, so rows >= valid sit inside
    live buckets; ``live=False``: every row of the shard is dead."""
    rng = np.random.default_rng(seed)
    if live:
        rows = rng.permutation(2 * n)[:n]
    else:
        rows = valid + rng.permutation(n)
    return torch.from_numpy(rows.astype(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("live", [True, False])
@pytest.mark.parametrize("b", [1, 64, 256])
def test_cand_scan_perm_kernel(cuda, b, live):
    """B10: perm liveness against the global valid; winners exact."""
    n = 4 * 4096
    emb = _exact(b, (n, 512))
    emb[1000:1100] = emb[100:200]            # duplicates: equal keys
    emb = emb.to(cuda, torch.bfloat16)
    q = _exact(100 + b, (b, 512)).to(cuda)
    valid = n + 777                          # global: more than one shard
    perm = _shard_perm(b, n, valid, live).to(cuda)
    before = topk.cand_scan.launches
    kv, ki = topk.cand_scan(emb, perm, q, valid, bucket=1024, rounds=2)
    torch.cuda.synchronize()
    assert topk.cand_scan.launches == before + 1
    pv, pi = topk.cand_scan_ref(emb, perm, q, valid, bucket=1024, rounds=2,
                                block_rows=4096)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)
    assert bool(torch.isfinite(kv).any()) == live


@pytest.mark.gpu
@pytest.mark.parametrize("live", [True, False])
@pytest.mark.parametrize("b", [1, 64, 256])
def test_cand_scan_int8_perm_kernel(cuda, b, live):
    """B11: winners bit-identical to the plain version."""
    n = 4 * 4096
    codes, scales = (t.to(cuda) for t in _codes_mirror("int8", b, n=n))
    q_codes, qscale = quantize_rows(_unit(100 + b, (b, 512)).to(cuda))
    valid = n + 777
    perm = _shard_perm(b, n, valid, live).to(cuda)
    before = topk.cand_scan_int8.launches
    kv, ki = topk.cand_scan_int8(codes, scales, perm, q_codes, qscale,
                                 valid, bucket=1024, rounds=2)
    torch.cuda.synchronize()
    assert topk.cand_scan_int8.launches == before + 1
    pv, pi = topk.cand_scan_int8_ref(codes, scales, perm, q_codes, qscale,
                                     valid, bucket=1024, rounds=2,
                                     block_rows=4096)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)
    assert bool(torch.isfinite(kv).any()) == live


# -- B4, B11 and B7: the tensor-core tile's route edges --------------------

def _int8_scan(cuda, b, valid, *, n=4 * 4096, d=512, perm=None,
               bucket=1024, rounds=2, seed=0, scales_at=0, tier="int8",
               mirror=None, queries=None):
    """B4 (``perm`` None), B11, or B7 (``tier`` "int4") over a seeded
    mirror (ties and zero rows, as ``_codes_mirror``; or ``mirror``, codes
    and scales) against the plain version: winners bit-identical, one
    launch counted. ``scales_at`` shifts the scales' storage by that many
    floats (a column the tile's TMA cannot take as it is); ``queries``
    replaces the quantized unit queries (codes and scales)."""
    codes, scales = mirror or _codes_mirror(tier, seed, n=n, d=d)
    codes = codes.to(cuda)
    flat = torch.zeros(n + scales_at, 1, device=cuda)
    flat[scales_at:] = scales.to(cuda)
    scales = flat[scales_at:]
    q_codes, qscale = (t.to(cuda) for t in queries or quantize_rows(
        _unit(100 + seed, (b, d)).to(cuda)))
    scan = dict(bucket=bucket, rounds=rounds)
    if tier == "int4":
        kern, args = topk.cand_scan_int4_prefix, (codes, scales)
        ref = topk.cand_scan_int4_prefix_ref
    elif perm is None:
        kern, args = topk.cand_scan_int8_prefix, (codes, scales)
        ref = topk.cand_scan_int8_prefix_ref
    else:
        perm = perm.to(cuda)
        kern, args = topk.cand_scan_int8, (codes, scales, perm)
        ref = topk.cand_scan_int8_ref
    counts = (topk.cand_scan_int8_prefix.launches,
              topk.cand_scan_int8.launches,
              topk.cand_scan_int4_prefix.launches)
    kv, ki = kern(*args, q_codes, qscale, valid, **scan)
    torch.cuda.synchronize()
    want = list(counts)
    want[2 if tier == "int4" else 0 if perm is None else 1] += 1
    assert [topk.cand_scan_int8_prefix.launches,
            topk.cand_scan_int8.launches,
            topk.cand_scan_int4_prefix.launches] == want
    pv, pi = ref(*args, q_codes, qscale, valid, block_rows=4096, **scan)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)
    return kv, ki


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["prefix", "perm"])
@pytest.mark.parametrize("valid", [0, 1500, 4 * 4096])
@pytest.mark.parametrize("b", [1, 16, 17, 64, 65, 256])
def test_int8_tile_batch_edges(cuda, layout, valid, b):
    """Both panel widths (QN = 16 for B <= 16, 64 above) and the query
    chunks of B > 64, with no row live, ``valid`` inside the first bucket,
    and every row live."""
    n = 4 * 4096
    perm = None
    if layout == "perm":
        # the shard's rows are host rows 0 .. n - 1 scattered: the same
        # liveness count as the prefix, spread over the buckets
        perm = torch.from_numpy(np.random.default_rng(b).permutation(n)
                                .astype(np.int32))
    kv, _ = _int8_scan(cuda, b, valid, n=n, perm=perm, seed=b)
    assert bool(torch.isfinite(kv).any()) == (valid > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [700, 150 * 1024 + 333, 300 * 1024])
@pytest.mark.parametrize("b", [1, 64])
def test_int8_tile_persistent_grid(cuda, valid, b):
    """300 buckets over the card's CTAs (a count the SM count does not
    divide: ranges of unequal length, halves with unequal bucket counts);
    a live prefix shorter than one CTA's range (700 rows), one that ends
    mid-bucket half-way, and every bucket live."""
    _int8_scan(cuda, b, valid, n=300 * 1024, seed=7)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 17, 64])
def test_int8_tile_perm_interleaved(cuda, b):
    """B11 on a shard whose perm alternates live and dead rows (global
    ``valid`` = the shard's row count), with one bucket wholly dead by perm
    and one wholly live."""
    n = 4 * 4096
    p = np.arange(n)
    perm = np.where(p % 2 == 0, p // 2, n + p // 2)
    perm[3 * 1024:4 * 1024] = n + 10_000 + np.arange(1024)   # dead bucket
    perm[5 * 1024:6 * 1024] = np.arange(1024)                # live bucket
    kv, _ = _int8_scan(cuda, b, n, n=n, perm=torch.from_numpy(
        perm.astype(np.int32)), seed=b)
    # bucket 3 (block 0, entries r * 4 + 3) is dead: -inf winners
    assert not bool(torch.isfinite(kv[0, 3::4]).any())
    assert bool(torch.isfinite(kv[1, 1::4]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", [1, 3, 4])
@pytest.mark.parametrize("bucket", [128, 1024])
@pytest.mark.parametrize("b", [1, 64])
def test_int8_tile_rounds_and_buckets(cuda, rounds, bucket, b):
    _int8_scan(cuda, b, 4096 + 777, bucket=bucket, rounds=rounds, seed=b)
    perm = torch.from_numpy(np.random.default_rng(rounds).permutation(
        2 * 4 * 4096)[:4 * 4096].astype(np.int32))
    _int8_scan(cuda, b, 4 * 4096 + 777, perm=perm, bucket=bucket,
               rounds=rounds, seed=b)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 192, 768])
def test_int8_tile_other_widths(cuda, d):
    """D = 64 (half a box), 192 (a box and a half: the second box's far
    columns arrive as zeros) and 768 (six boxes)."""
    _int8_scan(cuda, 64, 3 * 4096 + 5, d=d, seed=d)
    _int8_scan(cuda, 5, 3 * 4096 + 5, d=d, seed=d + 1)


@pytest.mark.gpu
def test_int8_tile_unaligned_scales(cuda):
    """Scales 4 bytes off a 16-byte boundary: the wrapper hands the tile
    an aligned copy; the winners stay the plain version's."""
    _int8_scan(cuda, 64, 2 * 4096 + 9, scales_at=1, seed=3)


@pytest.mark.gpu
def test_int8_tile_buckets_of_whole_tiles(cuda):
    """The tile takes buckets of whole 64-row tiles, over int8 codes (B4,
    B11) and packed int4 rows (B7) alike; a refused call counts no
    launch."""
    codes = torch.zeros(4096, 512, device=cuda, dtype=torch.int8)
    scales = torch.zeros(4096, 1, device=cuda)
    qc = torch.zeros(2, 512, device=cuda, dtype=torch.int8)
    qs = torch.ones(2, 1, device=cuda)
    perm = torch.arange(4096, dtype=torch.int32, device=cuda)
    before = _launch_counts()
    with pytest.raises(ValueError):
        topk.cand_scan_int8_prefix(codes, scales, qc, qs, 10, bucket=32,
                                   rounds=2)
    with pytest.raises(ValueError):
        topk.cand_scan_int8(codes, scales, perm, qc, qs, 10, bucket=32,
                            rounds=2)
    with pytest.raises(ValueError):
        topk.cand_scan_int4_prefix(codes[:, :256].contiguous(), scales, qc,
                                   qs, 10, bucket=32, rounds=2)
    assert _launch_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [0, 1500, 4 * 4096])
@pytest.mark.parametrize("b", [1, 16, 17, 64, 65, 256])
def test_int4_tile_batch_edges(cuda, valid, b):
    """B7 on both panel widths and the query chunks of B > 64, with no row
    live, ``valid`` inside the first bucket, and every row live."""
    kv, _ = _int8_scan(cuda, b, valid, tier="int4", seed=b)
    assert bool(torch.isfinite(kv).any()) == (valid > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("valid", [700, 150 * 1024 + 333, 300 * 1024])
@pytest.mark.parametrize("b", [1, 64])
def test_int4_tile_persistent_grid(cuda, valid, b):
    """B7 over 300 buckets on the card's CTAs, a live prefix shorter than
    one CTA's range, one ending mid-bucket, and every bucket live."""
    _int8_scan(cuda, b, valid, n=300 * 1024, tier="int4", seed=7)


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", [1, 2, 3, 4])
@pytest.mark.parametrize("bucket", [128, 1024])
@pytest.mark.parametrize("b", [1, 64])
def test_int4_tile_rounds_and_buckets(cuda, rounds, bucket, b):
    _int8_scan(cuda, b, 4096 + 777, bucket=bucket, rounds=rounds,
               tier="int4", seed=b)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 384, 768])
def test_int4_tile_other_widths(cuda, d):
    """D = 128 (a packed row of 64 bytes: half a box), 384 (192 bytes: the
    second box's far half arrives as zeros, and the panel's columns past
    the row are zero) and 768 (three boxes)."""
    _int8_scan(cuda, 64, 3 * 4096 + 5, d=d, tier="int4", seed=d)
    _int8_scan(cuda, 5, 3 * 4096 + 5, d=d, tier="int4", seed=d + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 64])
def test_int4_tile_extreme_nibbles(cuda, b):
    """Nibbles at -8 and 7 against query codes at +-127: the widest sums
    (|raw| up to 8 x 127 x 512) and every sign of the widened bytes."""
    n, d = 4 * 4096, 512
    rng = np.random.default_rng(b)
    packed = rng.choice(np.array([0x88, 0x77, 0x78, 0x87, 0x80, 0x07],
                                 np.uint8), (n, d // 2))
    packed[:64] = 0x88                          # every nibble -8
    packed[64:128] = 0x77                       # every nibble 7
    scales = rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    q_codes = rng.choice(np.array([-127, 127], np.int8), (b, d))
    q_codes[0] = -127
    qscale = rng.uniform(0.5, 1.5, (b, 1)).astype(np.float32)
    _int8_scan(cuda, b, n - 100, tier="int4", mirror=(
        torch.from_numpy(packed.view(np.int8)), torch.from_numpy(scales)),
        queries=(torch.from_numpy(q_codes), torch.from_numpy(qscale)))


@pytest.mark.gpu
def test_int4_tile_unaligned_scales(cuda):
    """B7's scales 4 bytes off a 16-byte boundary: the wrapper hands the
    tile an aligned copy."""
    _int8_scan(cuda, 64, 2 * 4096 + 9, scales_at=1, tier="int4", seed=3)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 40])
@pytest.mark.parametrize("b", [1, 64, 256])
def test_block_scan_int8_kernel(cuda, b, k):
    """B9 over int8 codes (3,000 rows: one short span, valid cutting it):
    exact queries (multiples of 1/256) make every sum exact, so the lists
    equal the plain version's at the kernel's span; on random unit queries
    the scores agree within rtol 1e-5 and rows differ only on ties within
    it."""
    codes, scales = _codes_mirror("int8", b, n=3000)
    codes, scales = codes.to(cuda), scales.to(cuda)
    q = _exact(200 + b, (b, 512)).to(cuda)
    before = topk.block_scan_int8.launches
    kv, ki = topk.block_scan_int8(codes, scales, q, 1700, k=k)
    torch.cuda.synchronize()
    assert topk.block_scan_int8.launches == before + 1
    pv, pi = topk.block_scan_int8_ref(codes, scales,
                                      topk._int8_scan_queries(q, 3000),
                                      1700, k=k,
                                      tile_rows=topk.SCAN_SPAN_ROWS)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)
    codes, scales = (t.to(cuda) for t in _codes_mirror("int8", b, n=8192))
    q = _unit(300 + b, (b, 512)).to(cuda)
    kv, ki = topk.cosine_topk_int8(codes, scales, q, 8000, k=k)
    pv, pi = topk.block_scan_int8_ref(codes, scales,
                                      topk._int8_scan_queries(q, 8192),
                                      8000, k=k, tile_rows=8192)
    _check_close_rows(kv, ki, pv[0], pi[0])


def _check_close_rows(kv, ki, pv, pi):
    """Scores within rtol 1e-5; rows identical except where two scores tie
    within it."""
    torch.testing.assert_close(kv, pv, rtol=1e-5, atol=0)
    gap = torch.full_like(pv, float("inf"))
    gap[:, 1:] = pv[:, :-1] - pv[:, 1:]
    gap[:, :-1] = torch.minimum(gap[:, :-1], pv[:, :-1] - pv[:, 1:])
    apart = gap > 1e-5 * pv.abs()
    assert torch.equal(ki[apart], pi[apart])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 40])
@pytest.mark.parametrize("b", [1, 64, 256])
def test_block_scan_bf16_kernel(cuda, b, k):
    """B8 over bf16 rows (the hatch's scan of a bf16 mirror), queries
    rounded to bf16 as the reference rounds them: lists equal the plain
    version's at the kernel's span on exact inputs, merged rows and scores
    as B9's on random unit rows."""
    emb = _exact(b, (3000, 512))
    emb[1500:1550] = emb[200:250]
    emb = emb.to(cuda, torch.bfloat16)
    q = _exact(400 + b, (b, 512)).to(cuda)
    before = topk.block_scan_bf16.launches, topk.block_scan.launches
    kv, ki = topk.block_scan_bf16(emb, q, 1700, k=k)
    torch.cuda.synchronize()
    assert (topk.block_scan_bf16.launches, topk.block_scan.launches) == \
        (before[0] + 1, before[1])
    pv, pi = topk.block_scan_ref(emb, q, 1700, k=k,
                                 tile_rows=topk.SCAN_SPAN_ROWS)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)
    emb = _unit(b, (8192, 512)).to(cuda, torch.bfloat16)
    q = _unit(500 + b, (b, 512)).to(cuda)
    kv, ki = topk.cosine_topk(emb, q, 8000, k=k)
    pv, pi = topk.block_scan_ref(emb, q.bfloat16().float(), 8000, k=k,
                                 tile_rows=8192)
    _check_close_rows(kv, ki, pv[0], pi[0])


def _span_scan(rows, emb, q, valid, k, **kw):
    """The exact scan of ``rows`` ("bf16" or "int8") over the f32 matrix
    ``emb`` on the card and its plain version: ``(kernel lists, plain
    lists one entry deeper)``. int8 codes are ``emb``'s quantization."""
    span = kw.get("tile_rows", topk.SCAN_SPAN_ROWS)
    if rows == "bf16":
        m = emb.to(q.device, torch.bfloat16)
        return (topk.block_scan_bf16(m, q, valid, k=k, **kw),
                topk.block_scan_ref(m, q.bfloat16().float(), valid,
                                    k=k + 1, tile_rows=span))
    codes, scales = (t.to(q.device) for t in quantize_rows(emb))
    return (topk.block_scan_int8(codes, scales, q, valid, k=k, **kw),
            topk.block_scan_int8_ref(
                codes, scales, topk._int8_scan_queries(q, emb.shape[0]),
                valid, k=k + 1, tile_rows=span))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 16, 17, 40, 64])
@pytest.mark.parametrize("b", [1, 2, 16, 17, 64, 65, 256])
@pytest.mark.parametrize("rows", ["bf16", "int8"])
def test_span_scan_route_edges(cuda, rows, b, k):
    """The span tile (B8 over bf16 rows, B9) at its routes' edges: B = 1
    (the query split), 2 and 16 (the 16-wide panel), 17, 64 and 65 (the
    64-wide panel; a second chunk of one query), 256 (four chunks); k = 1
    and 16 (the half-warp fold), 17 and 64 (the warp fold); over 2 x 8,192
    + 1,037 rows (N not a multiple of 64: the last span and tile short),
    with duplicated rows, first all live, then with valid cutting the
    second span so that the third lies wholly past it (not read). Exact
    inputs: the lists equal the plain version's at the span bit for bit."""
    n = 2 * topk.SCAN_SPAN_ROWS + 1037
    emb = _exact(b + k, (n, 512))
    emb[9000:9040] = emb[100:140]
    emb[n - 20:] = emb[300:320]
    q = _exact(900 + b, (b, 512)).to(cuda)
    counts = topk.block_scan_bf16.launches, topk.block_scan_int8.launches
    for valid in (n, topk.SCAN_SPAN_ROWS + 3000):
        (kv, ki), (pv, pi) = _span_scan(rows, emb, q, valid, k)
        torch.cuda.synchronize()
        assert kv.shape == (3, b, k)
        torch.testing.assert_close(kv, pv[..., :k], rtol=0, atol=0)
        assert torch.equal(ki, pi[..., :k])
    grew = 2 if rows == "bf16" else 0, 0 if rows == "bf16" else 2
    assert (topk.block_scan_bf16.launches, topk.block_scan_int8.launches) \
        == (counts[0] + grew[0], counts[1] + grew[1])


@pytest.mark.gpu
@pytest.mark.parametrize("span", [64, 1024])
@pytest.mark.parametrize("rows", ["bf16", "int8"])
def test_span_scan_other_spans(cuda, rows, span):
    """The span tile at spans other than the reference's macro (whole
    64-row tiles), valid cutting a span: exact inputs, lists equal the
    plain version's at the same span."""
    n = 3 * 1024 + 100
    emb = _exact(span, (n, 512))
    q = _exact(950, (5, 512)).to(cuda)
    (kv, ki), (pv, pi) = _span_scan(rows, emb, q, 2 * 1024 + 30, 10,
                                       tile_rows=span)
    torch.cuda.synchronize()
    assert kv.shape == (-(-n // span), 5, 10)
    torch.testing.assert_close(kv, pv[..., :10], rtol=0, atol=0)
    assert torch.equal(ki, pi[..., :10])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 40])
@pytest.mark.parametrize("rows", ["bf16", "int8"])
def test_span_scan_random_queries(cuda, rows, k):
    """B = 1 over whole 1,024-row blocks (B9: the f32-query contract, the
    kernel's three bf16 parts) and B = 64, on random unit rows and queries:
    the span lists' scores within rtol 1e-5 of the plain version's, rows
    identical except where two scores tie within it (the plain list's
    next entry included, so a tie across the cut counts)."""
    n = 2 * topk.SCAN_SPAN_ROWS
    emb = _unit(k, (n, 512))
    emb[5000:5040] = emb[40:80]
    for b in (1, 64):
        q = _unit(1100 + b, (b, 512)).to(cuda)
        (kv, ki), (pv, pi) = _span_scan(rows, emb, q, n - 300, k)
        torch.cuda.synchronize()
        torch.testing.assert_close(kv, pv[..., :k], rtol=1e-5, atol=0)
        gap = torch.full_like(pv[..., :k], float("inf"))
        gap[..., 1:] = pv[..., :k - 1] - pv[..., 1:k]
        gap[..., :-1] = torch.minimum(gap[..., :-1],
                                      pv[..., :k - 1] - pv[..., 1:k])
        gap[..., -1:] = torch.minimum(gap[..., -1:],
                                      pv[..., k - 1:k] - pv[..., k:])
        apart = gap > 1e-5 * pv[..., :k].abs()
        assert torch.equal(ki[apart], pi[..., :k][apart])


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8])
def test_block_scan_small_batches_keep_the_fma_tile(cuda, b):
    """f32 rows at B <= 8 stay on the FMA tile with 1,024-row tiles: one
    launch under block_scan, none under the span tile's wrappers, lists
    equal the plain version's on exact inputs."""
    emb = _exact(70 + b, (2 * 1024 + 37, 512)).to(cuda)
    q = _exact(80 + b, (b, 512)).to(cuda)
    before = (topk.block_scan.launches, topk.block_scan_bf16.launches,
              topk.block_scan_int8.launches)
    kv, ki = topk.block_scan(emb, q, 1024 + 400, k=10)
    torch.cuda.synchronize()
    assert (topk.block_scan.launches, topk.block_scan_bf16.launches,
            topk.block_scan_int8.launches) == \
        (before[0] + 1, before[1], before[2])
    assert kv.shape == (3, b, 10)
    pv, pi = topk.block_scan_ref(emb, q, 1024 + 400, k=10,
                                 tile_rows=topk.SCAN_TILE_ROWS)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    assert torch.equal(ki, pi)


@pytest.mark.gpu
def test_new_scans_refuse_bad_operands(cuda):
    emb = torch.zeros(4096, 512, device=cuda, dtype=torch.bfloat16)
    q = torch.zeros(2, 512, device=cuda)
    perm = torch.arange(4096, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                 # int64 perm
        topk.cand_scan(emb, perm.long(), q, 10, bucket=1024, rounds=2)
    with pytest.raises(ValueError):                 # perm of another length
        topk.cand_scan(emb, perm[:4095], q, 10, bucket=1024, rounds=2)
    with pytest.raises(ValueError):                 # perm on the CPU
        topk.cand_scan(emb, perm.cpu(), q, 10, bucket=1024, rounds=2)
    with pytest.raises(TypeError):                  # f32 mirror
        topk.cand_scan(emb.float(), perm, q, 10, bucket=1024, rounds=2)
    flat = torch.zeros(4096 * 512 + 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                 # mirror 16-byte aligned
        topk.cand_scan(flat[8:].view(4096, 512), perm, q, 10, bucket=1024,
                       rounds=2)
    codes = torch.zeros(4096, 512, device=cuda, dtype=torch.int8)
    scales = torch.zeros(4096, 1, device=cuda)
    qc = torch.zeros(2, 512, device=cuda, dtype=torch.int8)
    qs = torch.zeros(2, 1, device=cuda)
    with pytest.raises(ValueError):                 # int64 perm
        topk.cand_scan_int8(codes, scales, perm.long(), qc, qs, 10,
                            bucket=1024, rounds=2)
    with pytest.raises(TypeError):                  # f32 query codes
        topk.cand_scan_int8(codes, scales, perm, qc.float(), qs, 10,
                            bucket=1024, rounds=2)
    with pytest.raises(TypeError):                  # bf16 codes
        topk.block_scan_int8(emb, scales, q, 10, k=10)
    with pytest.raises(ValueError):                 # scales [N]
        topk.block_scan_int8(codes, scales[:, 0], q, 10, k=10)
    with pytest.raises(ValueError):                 # f64 scales
        topk.block_scan_int8(codes, scales.double(), q, 10, k=10)
    flat8 = torch.zeros(4096 * 512 + 4, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError):                 # codes 4 bytes off
        topk.block_scan_int8(flat8[4:].view(4096, 512), scales, q, 10, k=10)
    with pytest.raises(ValueError):                 # k > MAX_K
        topk.block_scan_int8(codes, scales, q, 10, k=65)
    with pytest.raises(TypeError):                  # f32 rows
        topk.block_scan_bf16(emb.float(), q, 10, k=10)
    with pytest.raises(ValueError):                 # span of partial tiles
        topk.block_scan_bf16(emb, q, 10, k=10, tile_rows=1000)
    with pytest.raises(ValueError):
        topk.block_scan_int8(codes, scales, q, 10, k=10, tile_rows=100)
    with pytest.raises(ValueError):                 # bf16 rows 8 bytes off
        topk.block_scan_bf16(flat[4:4 + 4096 * 512].view(4096, 512), q, 10,
                             k=10)


def _probe_operands(seed, n_tiles, b, exact, d=512, used=None):
    """Tiles (ids a permutation; tile 1 with 5 live rows, tile 2 with 700,
    tile 3 all padding, tile 4 every row twice), ``b`` queries, and every
    query paired with every used tile in a shuffled order."""
    rng = np.random.default_rng(seed)
    used = list(range(n_tiles)) if used is None else used
    tiles = torch.empty(n_tiles, 1024, d)
    ids = torch.full((n_tiles, 1024), -1, dtype=torch.int32)
    for j, t in enumerate(used):
        tiles[t] = (_exact(seed + t, (1024, d)) if exact
                    else _unit(seed + t, (1024, d)))
        ids[t] = torch.from_numpy(rng.permutation(1 << 22)[:1024].astype(
            np.int32))
    ids[used[1], 5:] = -1
    ids[used[2], 700:] = -1
    ids[used[3]] = -1
    tiles[used[4], 512:] = tiles[used[4], :512]
    q = _exact(seed, (b, d)) if exact else _unit(seed, (b, d))
    pairs = rng.permutation([(t, i) for t in used for i in range(b)])
    return (tiles, ids, torch.from_numpy(pairs[:, 0].astype(np.int32)),
            torch.from_numpy(pairs[:, 1].astype(np.int32)), q)


def _check_probe(kern, plain, exact):
    (kv, ki), (pv, pi) = kern, plain
    assert torch.equal(torch.isfinite(kv), torch.isfinite(pv))
    pad = ~torch.isfinite(pv)
    assert (ki[pad] == -1).all() and (pi[pad] == -1).all()
    if exact:
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
        return
    torch.testing.assert_close(kv[~pad], pv[~pad], rtol=1e-5, atol=0)
    gap = torch.full_like(pv, float("inf"))
    gap[:, 1:] = pv[:, :-1] - pv[:, 1:]
    gap[:, :-1] = torch.minimum(gap[:, :-1], pv[:, :-1] - pv[:, 1:])
    apart = (gap > 1e-5 * pv.abs()) & ~pad
    assert torch.equal(ki[apart], pi[apart])


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_probe_scan_kernel(cuda, k, exact):
    tiles, ids, tl, qi, q = (t.to(cuda) for t in _probe_operands(
        k, 8, 5, exact))
    before = ivf.probe_scan.launches
    got = ivf.probe_scan(tiles, ids, tl, qi, q, k=k)
    torch.cuda.synchronize()
    assert ivf.probe_scan.launches == before + 1
    assert got[0].shape == got[1].shape == (tl.shape[0], k)
    _check_probe(got, ivf.probe_scan_ref(tiles, ids, tl, qi, q, k=k), exact)
    if k > 5:      # the 5-live-row tile's pairs pad from slot 5 on
        assert (got[1][tl == 1][:, 5:] == -1).all()


@pytest.mark.gpu
def test_probe_scan_kernel_64bit_tile_offsets(cuda):
    """Pairs on tiles 4,096-4,099: their element offsets pass 2^31."""
    used = [0, 4097, 2048, 4096, 4099, 3]
    tiles, ids, tl, qi, q = _probe_operands(1, 4100, 3, False, used=used)
    tiles, ids, tl, qi, q = (t.to(cuda) for t in (tiles, ids, tl, qi, q))
    got = ivf.probe_scan(tiles, ids, tl, qi, q, k=10)
    torch.cuda.synchronize()
    _check_probe(got, ivf.probe_scan_ref(tiles, ids, tl, qi, q, k=10),
                 False)


def _probe_tiles(seed, n_tiles, exact, d=512, live=None):
    """``n_tiles`` tiles with random distinct ids (the last all padding;
    tile ``t`` keeps ``live[t]`` live rows where given)."""
    rng = np.random.default_rng(seed)
    tiles = (_exact(seed, (n_tiles, 1024, d)) if exact
             else _unit(seed, (n_tiles * 1024, d)).view(n_tiles, 1024, d))
    ids = torch.from_numpy(rng.permutation(1 << 24)[:n_tiles * 1024].astype(
        np.int32)).view(n_tiles, 1024).clone()
    ids[-1] = -1
    for t, n in (live or {}).items():
        ids[t, n:] = -1
    return tiles, ids


def _probe_ref(tiles, ids, tl, qi, q, k, step=2048):
    """The plain version, ``step`` pairs at a time (it gathers each pair's
    tile)."""
    parts = [ivf.probe_scan_ref(tiles, ids, tl[lo:lo + step],
                                qi[lo:lo + step], q, k=k)
             for lo in range(0, tl.shape[0], step)]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([i for _, i in parts]))


def _probe_launch(tiles, ids, tl, qi, q, k):
    before = ivf.probe_scan.launches
    got = ivf.probe_scan(tiles, ids, tl, qi, q, k=k)
    torch.cuda.synchronize()
    assert ivf.probe_scan.launches == before + 1
    assert got[0].shape == got[1].shape == (tl.shape[0], k)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("d", [96, 512, ivf.PROBE_MAX_D])
def test_probe_scan_one_pair_over_many_ctas(cuda, d, k, exact):
    """One query over one tile: the pair's 16 chunks of 64 rows go to 16
    CTAs, and the last to finish merges them."""
    tiles, ids = (t.to(cuda) for t in _probe_tiles(d + k, 2, exact, d=d))
    q = (_exact(1, (1, d)) if exact else _unit(1, (1, d))).to(cuda)
    tl = torch.zeros(1, dtype=torch.int32, device=cuda)
    assert ivf.probe_chunks(1) == ivf.PROBE_MAX_CHUNKS
    got = _probe_launch(tiles, ids, tl, tl, q, k)
    _check_probe(got, ivf.probe_scan_ref(tiles, ids, tl, tl, q, k=k), exact)
    assert torch.isfinite(got[0]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n_queries", [9, 16, 17, 40])
def test_probe_scan_queries_on_one_tile(cuda, n_queries, exact):
    """9 to 40 queries on one tile (groups of 8 and a remainder), twice
    each, beside pairs on a tile with 5 live rows."""
    tiles, ids = (t.to(cuda) for t in _probe_tiles(
        n_queries, 3, exact, live={1: 5}))
    q = (_exact(2, (n_queries, 512)) if exact
         else _unit(2, (n_queries, 512))).to(cuda)
    rng = np.random.default_rng(n_queries)
    pairs = [(0, i) for i in range(n_queries)] * 2 + [(1, i) for i in
                                                       range(n_queries)]
    pairs = rng.permutation(np.array(pairs, np.int32))
    tl, qi = (torch.from_numpy(np.ascontiguousarray(pairs[:, j])).to(cuda)
              for j in (0, 1))
    got = _probe_launch(tiles, ids, tl, qi, q, 10)
    _check_probe(got, ivf.probe_scan_ref(tiles, ids, tl, qi, q, k=10), exact)
    assert (got[1][tl == 1][:, 5:] == -1).all()


@pytest.mark.gpu
def test_probe_scan_padding_and_bad_pairs(cuda):
    """Every pair on the padding tile: pads only. Pairs whose query is out
    of range or whose tile is negative: pads only, beside live ones."""
    tiles, ids = (t.to(cuda) for t in _probe_tiles(3, 3, True))
    q = _exact(3, (4, 512)).to(cuda)
    pad = torch.full((64,), 2, dtype=torch.int32, device=cuda)
    qi = torch.arange(64, dtype=torch.int32, device=cuda) % 4
    v, i = _probe_launch(tiles, ids, pad, qi, q, 10)
    assert (v == float("-inf")).all() and (i == -1).all()
    tl = torch.tensor([0, -1, 1, 0, 2, 1], dtype=torch.int32, device=cuda)
    qi = torch.tensor([0, 1, 4, -1, 3, 2], dtype=torch.int32, device=cuda)
    v, i = _probe_launch(tiles, ids, tl, qi, q, 10)
    ok = torch.tensor([True, False, False, False, True, True], device=cuda)
    assert (v[~ok] == float("-inf")).all() and (i[~ok] == -1).all()
    _check_probe((v[ok], i[ok]), ivf.probe_scan_ref(
        tiles, ids, tl[ok], qi[ok], q, k=10), True)


@pytest.mark.gpu
@pytest.mark.parametrize("n_pairs", [256 * 32, 8192 + 3001])
def test_probe_scan_long_pair_lists(cuda, n_pairs):
    """The pair list of B = 256 (8,192 pairs: one plan CTA) and one past
    it (two plan windows, a tile's pairs in both): 64 tiles, the last all
    padding, a third of the pairs on it, some tiles partly live (one with
    its first 700 rows dead, one all dead)."""
    tiles, ids = (t.to(cuda) for t in _probe_tiles(
        5, 64, False, live={3: 1, 7: 100, 11: 600, 20: 1000}))
    ids[5, :700] = -1
    ids[9] = -1
    q = _unit(4, (256, 512)).to(cuda)
    rng = np.random.default_rng(n_pairs)
    tl = np.where(rng.random(n_pairs) < 1 / 3, 63,
                  rng.integers(0, 63, n_pairs)).astype(np.int32)
    qi = rng.integers(0, 256, n_pairs).astype(np.int32)
    tl, qi = (torch.from_numpy(x).to(cuda) for x in (tl, qi))
    got = _probe_launch(tiles, ids, tl, qi, q, 10)
    _check_probe(got, _probe_ref(tiles, ids, tl, qi, q, 10), False)


@pytest.mark.gpu
def test_kernels_refuse_bad_operands(cuda):
    emb = torch.zeros(4096, 512, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        topk.cand_scan_prefix(emb, torch.zeros(2, 256, device=cuda), 10,
                              bucket=1024, rounds=2)
    with pytest.raises(TypeError):                  # f32 mirror
        topk.cand_scan_prefix(emb.float(), torch.zeros(2, 512, device=cuda),
                              10, bucket=1024, rounds=2)
    codes = torch.zeros(4096, 512, device=cuda, dtype=torch.int8)
    scales = torch.zeros(4096, 1, device=cuda)
    qc = torch.zeros(2, 512, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError):                 # query scales [B]
        topk.cand_scan_int8_prefix(codes, scales, qc, torch.zeros(
            2, device=cuda), 10, bucket=1024, rounds=2)
    with pytest.raises(TypeError):                  # f32 query codes
        topk.cand_scan_int8_prefix(codes, scales, qc.float(), torch.zeros(
            2, 1, device=cuda), 10, bucket=1024, rounds=2)
    with pytest.raises(TypeError):                  # bf16 matrix
        topk.block_scan(emb, torch.zeros(2, 512, device=cuda), 10, k=10)
    with pytest.raises(ValueError):                 # k > MAX_K
        topk.block_scan(emb.float(), torch.zeros(2, 512, device=cuda), 10,
                        k=65)
    tiles = torch.zeros(2, 1024, 512, device=cuda)
    ids = torch.zeros(2, 1024, dtype=torch.int32, device=cuda)
    pairs = torch.zeros(3, dtype=torch.int32, device=cuda)
    qs = torch.zeros(2, 512, device=cuda)
    with pytest.raises(ValueError):                 # k > MAX_K
        ivf.probe_scan(tiles, ids, pairs, pairs, qs, k=65)
    with pytest.raises(ValueError):                 # D = 510
        ivf.probe_scan(tiles[..., :510].contiguous(), ids, pairs, pairs,
                       qs[:, :510].contiguous(), k=5)
    with pytest.raises(TypeError):                  # int64 tile list
        ivf.probe_scan(tiles, ids, pairs.long(), pairs, qs, k=5)
    with pytest.raises(ValueError):                 # tile list on the CPU
        ivf.probe_scan(tiles, ids, pairs.cpu(), pairs, qs, k=5)
    wide = torch.zeros(2, 1024, ivf.PROBE_MAX_D + 4, device=cuda)
    with pytest.raises(ValueError):                 # D past PROBE_MAX_D
        ivf.probe_scan(wide, ids, pairs, pairs,
                       torch.zeros(2, ivf.PROBE_MAX_D + 4, device=cuda), k=5)
    q = torch.zeros(1, 8, 512, device=cuda)
    with pytest.raises(ValueError):
        attention(q, q, q, num_heads=4)            # head dim 128
    with pytest.raises(ValueError):
        attention(q, q.cpu(), q, num_heads=8)


def _mesh_pair(dtype, corpus):
    """One index sharded over the cards (up to four) and one with as many
    shards all on the first card, both over ``corpus``."""
    cards = min(torch.cuda.device_count(), 4)
    out = []
    for mesh in (corpus_mesh(cards), CorpusMesh(["cuda:0"] * cards)):
        index = DeviceVideoIndex(dim=corpus.shape[1], device_dtype=dtype,
                                 mesh=mesh)
        index.add_batch(corpus, "v.mp4", [0.5 * t for t in range(len(corpus))])
        out.append(index)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hatch", [("bfloat16", False),
                                         ("int8", False),
                                         ("float32", False),
                                         ("bfloat16", True), ("int8", True)])
def test_mesh_across_cards(cuda, monkeypatch, dtype, hatch):
    """The perm-layout scans (B10, B11), B8, and under the hatch B8 on bf16
    rows and B9, per shard across the cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    if hatch:
        monkeypatch.setenv("VQT_CANDIDATE_TOPK", "pallas")
    corpus = _unit(0, (200_000, 512)).numpy()
    cards, one = _mesh_pair(dtype, corpus)
    q = _unit(1, (64, 512)).numpy()
    for b in (1, 64):
        got, want = cards.search_batch(q[:b], k=10), one.search_batch(q[:b],
                                                                   k=10)
        assert got == want
    assert len({e.device for e in cards._device_emb}) == len(cards.mesh.devices)


@pytest.mark.gpu
def test_mesh_ivf_across_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    cards = min(torch.cuda.device_count(), 4)
    corpus = _unit(2, (100_000, 512)).numpy()
    built = ivf.IVFIndex(nlist=64, nprobe=8, device="cuda:0")
    built.build(corpus)
    state = dict(centroids=built._centroids_np,
                 tiled=built._tiled.cpu().numpy(), row_ids=built._row_ids,
                 tile_start=built._tile_start_np,
                 tile_counts=built._tile_counts_np, n_built=built._n_built,
                 nlist=built.nlist, nprobe=built.nprobe)
    tiers = [ivf.IVFIndex.load_built(**state, mesh=mesh) for mesh in (
        corpus_mesh(cards), CorpusMesh(["cuda:0"] * cards))]
    assert tiers[0].stats() == tiers[1].stats()
    assert len({t.device for t in tiers[0]._sh_tiled}) == cards
    q = _unit(3, (64, 512)).numpy()
    for b in (1, 64):
        (v0, i0), (v1, i1) = (t.search(q[:b], k=10) for t in tiers)
        assert np.array_equal(i0, i1) and np.array_equal(v0, v1)
        _, i2 = built.search(q[:b], k=10)
        assert np.array_equal(np.sort(i0, axis=1), np.sort(i2, axis=1))


def _video_corpus(seed, n_videos=300, frames=700, d=512):
    """Clustered unit rows: each video's frames around its own centre;
    video 1 a copy of video 0 (a tie of videos) and frame 9 of each a copy
    of frame 4 (a tie of best frames)."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n_videos, 1, d)).astype(np.float32)
    rows = centres + 2.0 * rng.standard_normal(
        (n_videos, frames, d)).astype(np.float32)
    rows[1] = rows[0]
    rows[:, 9] = rows[:, 4]
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    return rows


def _fill_videos(index, rows):
    for v, frames in enumerate(rows):
        index.add_batch(frames, f"video_{v}.mp4",
                        [0.5 * t for t in range(len(frames))])


def _video_queries(rows, seed):
    rng = np.random.default_rng(seed)
    n, frames = rows.shape[:2]
    picks = [rows[v % n, t % frames]
             for v, t in ((0, 4), (5, 100), (77, 3), (299, 9))]
    return picks + [rows[1].mean(0)] + [
        rng.standard_normal(rows.shape[-1]).astype(np.float32)
        for _ in range(11)]


def _same_videos(got, want):
    assert [(r["video_name"], r["frame_count"], r["best_timestamp"])
            for r in got] == [(r["video_name"], r["frame_count"],
                               r["best_timestamp"]) for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=0,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kw,device_path", [
    ("float32", {}, True), ("bfloat16", {}, True),
    ("int8", {"device_rerank": "on"}, True),
    ("int8", {"device_rerank": "off"}, False),
    ("bfloat16", {"rerank_store_dtype": "bfloat16"}, False)])
def test_video_ranking_on_the_card(cuda, dtype, kw, device_path):
    """``search_videos`` on a CUDA index ranks on the card exactly where
    the reference's rule says (the f32 mirror, or the f32 re-rank store
    while the device re-rank is on; its counter moves once a search) and
    gives the host path's rows on the same index: the same videos in the
    same order, frame counts and best timestamps, scores within 1e-5;
    after a removal and an append, too."""
    rows = _video_corpus(5)
    index = DeviceVideoIndex(dim=512, device_dtype=dtype, device=cuda, **kw)
    _fill_videos(index, rows)
    for step in range(2):
        before = device_index.video_rank_device.launches
        queries = _video_queries(rows, step)
        for k in (1, 10, 64):
            for q in queries:
                want = index._search_videos_host(index.normalize_query(q),
                                                 k)
                _same_videos(index.search_videos(q, k), want)
        ran = device_index.video_rank_device.launches - before
        assert ran == (3 * len(queries) if device_path else 0)
        index.remove_video("video_77.mp4")
        index.add_batch(rows[77, :50], "late.mp4",
                        [0.5 * t for t in range(50)])


@pytest.mark.gpu
def test_multipart_pickle_part_loads_on_the_card(cuda):
    """A cache pickle sent as the binary ``.pkl`` part of a multipart body
    (the import route's upload) parses byte for byte and loads into a
    CUDA index, whose device video ranking then matches the writer's."""
    import pickle
    rows = _video_corpus(6, n_videos=40, frames=100)
    src = DeviceVideoIndex(dim=512, device_dtype="float32", device=cuda)
    _fill_videos(src, rows)
    payload = pickle.dumps(src.to_cache_dict())
    boundary = "vqt-boundary-7f3a"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="file"; filename="cache.pkl"\r\nContent-Type: '
            f"application/octet-stream\r\n\r\n").encode() + payload + \
        f"\r\n--{boundary}--\r\n".encode()
    parts = parse_multipart(body, f"multipart/form-data; boundary={boundary}")
    assert [(p.name, p.filename) for p in parts] == [("file", "cache.pkl")]
    assert parts[0].data == payload
    dst = DeviceVideoIndex(dim=512, device_dtype="float32", device=cuda)
    dst.load_cache_dict(device_index.safe_pickle_loads(parts[0].data))
    for q in _video_queries(rows, 3):
        assert dst.search_videos(q, 10) == src.search_videos(q, 10)



@pytest.mark.gpu
def test_frame_batches_are_pinned(cuda):
    """On a CUDA host the frame pipeline's ring batches are page-locked, so
    the embedder's upload of a batch is a pinned copy; a consumer that
    drops each batch gets the ring's slots again, and the frames arrive on
    the card as made."""
    from video_quierer_tpu_torch.ingest.pipeline import (
        RING_SLOTS,
        batched_frames,
    )

    def extract(path):
        v = int(path.stem[1:])
        return np.full((6, 224, 224, 3), v, np.uint8), \
            [0.5 * j for j in range(6)]

    ptrs = []
    for b in batched_frames([f"v{i}.mp4" for i in range(40)], batch_size=16,
                            num_workers=2, extract_fn=extract):
        frames = torch.from_numpy(b.frames)
        assert frames.is_pinned()
        want = torch.tensor(b.video_indices, dtype=torch.uint8)
        assert torch.equal(frames.to(cuda).cpu(),
                           want[:, None, None, None].expand_as(frames))
        ptrs.append(frames.data_ptr())
        del frames
    assert len(ptrs) == 15 and len(set(ptrs)) <= RING_SLOTS
