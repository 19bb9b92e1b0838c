"""Fused-layer CLIP encodes (counterpart of
``video_quierer_tpu/ops/fused_layer.py``).

One encoder block runs as two halves, each a kernel on a CUDA tensor and
its plain version on a CPU tensor:

- :func:`attn_half` (kernel B5, ``csrc/fused_layer.cu``; plain
  :func:`attn_half_ref`): LN1 → QKV → per-item attention (causal for
  text, non-causal for the vision tower) → out-proj → residual;
- :func:`mlp_half` (kernel B6; plain :func:`mlp_half_ref`): LN2 → fc1 →
  GELU → fc2 → residual;
- :func:`fused_layer` (kernel B2; plain :func:`fused_layer_ref`): the
  causal text block, B5 then B6 inside one C call.

AIMv2's blocks (``models/aimv2``) take the same two kernels with their
compile-time choices of RMSNorm, bias-free projections and a SiLU-gated
MLP (:func:`rms_attn_half`, :func:`gated_mlp_half` and their plain
versions; operands :data:`GatedOps`). Their rounding points are the
CLIP halves' with the bias steps left out: RMSNorm ``T(x · rstd · γ)``
with f32 statistics, ``T(x @ w)``, the gate and up products each rounded
to T, then ``T(T(g · T(1 / T(1 + T(exp(-g))))) · u)``
(:func:`silu_gate_kernel_form`), the residual adds in T.

All follow the TPU kernels' math and bf16 rounding points: LayerNorm with
f32 statistics, ``T(x @ w)`` then ``+ bias`` in T, attention with the
attention kernel's softmax contract and the ``hd**-0.5`` scale on the f32
logits, the GELU in T, residual adds in T. The GELU is ``act``: CLIP's
``"quick_gelu"``, ``x / (1 + exp(-1.702 x))``, or SigLIP's
``"gelu_tanh"`` in the TPU kernel's sigmoid form, ``u = c1·(x +
c2·((x·x)·x))`` then ``x · (1 / (1 + exp(-2u)))`` (``_mlp_math``), each
constant rounded to T and every step rounded to T. On the card the
activation is a template parameter of the GEMM epilogue, chosen once per
call (``ACT_CODES``).

:func:`fused_text_encode` is the drop-in for ``CLIP.encode_text`` on
coalesced batches (token + position embedding → blocks → EOT pooling →
final LN → projection → f32 L2 normalise); :func:`fused_vision_encode` the
drop-in for ``CLIP.encode_image`` (patchify → class token + positions →
pre-LN → blocks → CLS pooling → post-LN → projection → f32 L2 normalise).

:func:`fused_encode_shards` is the data mesh's counterpart of the
reference's ``fused_encode_shard_map``: a batch split over the mesh's
``data`` axis, each part encoded on its own device against that
device's replica, the rows gathered in order.

Routing is the port's own, not the TPU's VMEM budgets: a tower whose heads
are 64 wide and whose width divides by 64 takes the fused encode when
``B·S >= MIN_TOKENS`` (the reference's single-batch policy); text also
needs S in the 8/16/32 buckets. Single queries, small batches and S=77
stay on the module tower. The TPU's split/full modes, tile sizes and
pad-token scheme have no counterpart here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from video_quierer_tpu_torch.ops import kernels
from video_quierer_tpu_torch.ops.attention import (
    HEAD_DIM,
    HEAD_DIMS,
    attention_ref,
)

# Minimum tokens (B·S) for the fused text encode: the reference's
# single-batch policy (fused_layer.py:MIN_TOKENS)
MIN_TOKENS = 256
# the bf16 kernels' LayerNorm pass holds a row in registers (every dense
# CLIP tower with 64-wide heads is at most 1,024 wide)
BF16_MAX_WIDTH = 1024

LayerOps = Tuple[torch.Tensor, ...]

# the GEMM epilogue's activation codes (csrc/fused_layer.cu:ACT_*)
ACT_CODES = {"quick_gelu": 1, "gelu_tanh": 2}
# sqrt(2 / pi) and the cubic coefficient of tanh-GELU (_mlp_math)
GELU_TANH_C1 = 0.7978845608028654
GELU_TANH_C2 = 0.044715


# AIMv2's block operands: (rms [2, D] f32 — RMSNorm-1 and -2 scales —,
# wqkv [D, 3D], wout [D, D], wgu [D, 2F] — gate and up interleaved by 8
# columns, :func:`interleave_gate_up` —, wdown [F, D]), every matrix
# [in, out] row-major
GatedOps = Tuple[torch.Tensor, ...]
# the gated epilogue's interleave: 8 gate columns, then the same 8 up
# columns (one n-tile of the GEMM's accumulator fragment each)
GATE_GROUP = 8


def _width_eligible(d: int, heads: int) -> bool:
    """Whole 64-wide heads (the kernels' head width) and GEMM-tileable
    widths."""
    return d % heads == 0 and d // heads == HEAD_DIM and d % 64 == 0


def fused_text_tower_eligible(cfg_text) -> bool:
    """Static eligibility of the fused text tower."""
    return _width_eligible(cfg_text.hidden_size, cfg_text.num_heads)


def fused_vision_tower_eligible(cfg_vision) -> bool:
    """Static eligibility of the fused vision tower (every dense CLIP
    vision tower: B/32, B/16 and L/14 have 64-wide heads). MoE towers are
    not ported."""
    if getattr(cfg_vision, "moe_experts", 0):
        return False
    return _width_eligible(cfg_vision.hidden_size, cfg_vision.num_heads)


def fused_seq_eligible(s: int) -> bool:
    """Per-call seq gate: the 8/16/32 buckets; the full-77 bucket stays on
    the module tower."""
    return s % 8 == 0


def fused_batch_eligible(b: int, s: int) -> bool:
    """Per-call batch gate shared by both towers: wide enough for the
    fused path."""
    return b * s >= MIN_TOKENS


def _ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float, out_dtype) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(out_dtype)


def _const(value: float, dtype) -> float:
    """A scalar rounded to ``dtype``, as JAX rounds a weakly typed Python
    constant to the array's dtype."""
    return torch.tensor(value, dtype=dtype).item()


def _dot(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``T(a @ w) + b`` with an f32 matmul (``w`` is ``[in, out]``)."""
    return (a.float() @ w.float()).to(a.dtype) + b


def _layer_operands(block, dtype) -> LayerOps:
    """Concatenated weight operands of one encoder block
    (models/clip/model.py:EncoderBlock): ``(ln [4, D] f32, wqkv [D, 3D],
    bqkv [3D], wout [D, D], bout, wfc1 [D, F], bfc1, wfc2 [F, D], bfc2)``,
    every matrix ``[in, out]`` row-major as the TPU kernel takes them."""
    attn, mlp = block.attn, block.mlp
    wqkv = torch.cat([attn.q_proj.weight, attn.k_proj.weight,
                      attn.v_proj.weight], dim=0).t()
    bqkv = torch.cat([attn.q_proj.bias, attn.k_proj.bias,
                      attn.v_proj.bias])
    ln = torch.stack([block.layer_norm1.weight, block.layer_norm1.bias,
                      block.layer_norm2.weight, block.layer_norm2.bias])

    def c(t):
        return t.detach().to(dtype).contiguous()

    return (ln.detach().float().contiguous(), c(wqkv), c(bqkv),
            c(attn.out_proj.weight.t()), c(attn.out_proj.bias),
            c(mlp.fc1.weight.t()), c(mlp.fc1.bias),
            c(mlp.fc2.weight.t()), c(mlp.fc2.bias))


def attn_half_ref(x2: torch.Tensor, ops: LayerOps, *, s: int, heads: int,
                  eps: float, causal: bool) -> torch.Tensor:
    """Plain PyTorch version of B5 over ``[B·S, D]`` tokens (item-major):
    LN1 → QKV → per-item attention → out-proj → residual."""
    ln, wqkv, bqkv, wout, bout = ops[:5]
    t, d = x2.shape
    y = _ln_f32(x2, ln[0], ln[1], eps, x2.dtype)
    qkv = _dot(y, wqkv, bqkv).reshape(t // s, s, 3 * d)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    attn = attention_ref(q, k, v, num_heads=heads, valid_len=s,
                         causal=causal, scale=(d // heads) ** -0.5)
    return x2 + _dot(attn.reshape(t, d), wout, bout)


def _act_code(act: str) -> int:
    try:
        return ACT_CODES[act]
    except KeyError:
        raise ValueError(f"unsupported fused-layer activation {act!r}; "
                         f"known: {sorted(ACT_CODES)}") from None


def gelu_kernel_form(h: torch.Tensor, act: str) -> torch.Tensor:
    """The TPU kernel's activation (``_mlp_math``) in ``h``'s dtype, every
    operation rounded to it: quick-GELU ``h / (1 + exp(-1.702 h))``, or
    tanh-GELU as ``h · σ(2u)``, ``u = c1·(h + c2·((h·h)·h))``."""
    _act_code(act)
    dt = h.dtype
    if act == "quick_gelu":
        return h * (1.0 / (1.0 + torch.exp(_const(-1.702, dt) * h)))
    u = _const(GELU_TANH_C1, dt) * (h + _const(GELU_TANH_C2, dt)
                                    * (h * h * h))
    return h * (1.0 / (1.0 + torch.exp(-2.0 * u)))


def mlp_half_ref(x3: torch.Tensor, ops: LayerOps, *, eps: float,
                 act: str = "quick_gelu") -> torch.Tensor:
    """Plain PyTorch version of B6: LN2 → fc1 → GELU (``act``) → fc2 →
    residual."""
    ln, wfc1, bfc1, wfc2, bfc2 = ops[0], *ops[5:]
    z = _ln_f32(x3, ln[2], ln[3], eps, x3.dtype)
    h1 = gelu_kernel_form(_dot(z, wfc1, bfc1), act)
    return x3 + _dot(h1, wfc2, bfc2)


def fused_layer_ref(x2: torch.Tensor, ops: LayerOps, *, s: int, heads: int,
                    eps: float, act: str = "quick_gelu") -> torch.Tensor:
    """Plain PyTorch version of B2: one causal text block."""
    x3 = attn_half_ref(x2, ops, s=s, heads=heads, eps=eps, causal=True)
    return mlp_half_ref(x3, ops, eps=eps, act=act)


def _check_operands(x2: torch.Tensor, ops: LayerOps, *, s: int = 1,
                    heads: int = 0) -> torch.device:
    """The kernels' operand rules: one CUDA device, contiguous, ln f32
    [4, D], the rest in the activation dtype, tileable widths, whole
    items, 16-byte aligned starts; ``heads`` 0 skips the attention
    checks. Returns the device."""
    ln, wqkv, bqkv, wout, bout, wfc1, bfc1, wfc2, bfc2 = ops
    dev = kernels.require_cuda(x2, *ops)
    t, d = x2.shape
    f = wfc1.shape[1]
    if ln.dtype != torch.float32 or ln.shape != (4, d) \
            or any(w.dtype != x2.dtype for w in ops[1:]):
        raise ValueError("fused layer operands: ln f32 [4, D], the rest in "
                         "the activation dtype")
    if wqkv.shape != (d, 3 * d) or wout.shape != (d, d) \
            or wfc1.shape != (d, f) or wfc2.shape != (f, d) \
            or (heads and d != heads * HEAD_DIM) or d % 64 or f % 64 \
            or t % s or any(o.data_ptr() % 16 for o in (x2, *ops)) \
            or (x2.dtype == torch.bfloat16 and d > BF16_MAX_WIDTH):
        raise ValueError(f"unsupported fused layer shape: T={t} D={d} "
                         f"F={f} heads={heads} S={s} (operands must start "
                         f"16-byte aligned; bf16 D <= {BF16_MAX_WIDTH})")
    return dev


def attn_half(x2: torch.Tensor, ops: LayerOps, *, s: int, heads: int,
              eps: float, causal: bool) -> torch.Tensor:
    """First half of an encoder block over flat ``[B·S, D]`` tokens:
    kernel B5 on a CUDA tensor, :func:`attn_half_ref` on a CPU tensor."""
    if x2.device.type == "cpu":
        return attn_half_ref(x2, ops, s=s, heads=heads, eps=eps,
                             causal=causal)
    dev = _check_operands(x2, ops, s=s, heads=heads)
    ln, wqkv, bqkv, wout, bout = ops[:5]
    t, d = x2.shape
    out = torch.empty_like(x2)
    qkv = torch.empty((t, 3 * d), dtype=x2.dtype, device=dev)
    attn = torch.empty_like(x2)
    p = kernels.ptr
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().vqt_attn_half(
            p(x2), p(out), p(qkv), p(attn), p(ln), p(wqkv), p(bqkv),
            p(wout), p(bout), t, s, d, heads, float(eps), int(causal),
            kernels.dtype_code(x2), kernels.stream(dev)), "attention half")
    kernels.count_launch(attn_half)
    return out


attn_half.launches = 0


def mlp_half(x3: torch.Tensor, ops: LayerOps, *, eps: float,
             act: str = "quick_gelu") -> torch.Tensor:
    """Second half of an encoder block: kernel B6 on a CUDA tensor,
    :func:`mlp_half_ref` on a CPU tensor. ``act``: ``"quick_gelu"``
    (CLIP) or ``"gelu_tanh"`` (SigLIP)."""
    if x3.device.type == "cpu":
        return mlp_half_ref(x3, ops, eps=eps, act=act)
    code = _act_code(act)
    dev = _check_operands(x3, ops)
    ln, wfc1, bfc1, wfc2, bfc2 = ops[0], *ops[5:]
    t, d = x3.shape
    f = wfc1.shape[1]
    out = torch.empty_like(x3)
    h = torch.empty((t, f), dtype=x3.dtype, device=dev)
    p = kernels.ptr
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().vqt_mlp_half(
            p(x3), p(out), p(h), p(ln), p(wfc1), p(bfc1), p(wfc2), p(bfc2),
            t, d, f, float(eps), code, kernels.dtype_code(x3),
            kernels.stream(dev)), "MLP half")
    kernels.count_launch(mlp_half)
    return out


mlp_half.launches = 0


def fused_layer(x2: torch.Tensor, ops: LayerOps, *, s: int, heads: int,
                eps: float, act: str = "quick_gelu") -> torch.Tensor:
    """One causal text block over flat ``[B·S, D]`` tokens: kernel B2 (B5
    then B6 in one C call) on a CUDA tensor, :func:`fused_layer_ref` on a
    CPU tensor."""
    if x2.device.type == "cpu":
        return fused_layer_ref(x2, ops, s=s, heads=heads, eps=eps, act=act)
    code = _act_code(act)
    dev = _check_operands(x2, ops, s=s, heads=heads)
    ln, wqkv, bqkv, wout, bout, wfc1, bfc1, wfc2, bfc2 = ops
    t, d = x2.shape
    f = wfc1.shape[1]
    out = torch.empty_like(x2)
    qkv = torch.empty((t, 3 * d), dtype=x2.dtype, device=dev)
    attn = torch.empty_like(x2)
    x3 = torch.empty_like(x2)
    h = torch.empty((t, f), dtype=x2.dtype, device=dev)
    p = kernels.ptr
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().vqt_text_layer(
            p(x2), p(out), p(qkv), p(attn), p(x3), p(h), p(ln), p(wqkv),
            p(bqkv), p(wout), p(bout), p(wfc1), p(bfc1), p(wfc2), p(bfc2),
            t, s, d, heads, f, float(eps), code, kernels.dtype_code(x2),
            kernels.stream(dev)), "fused text layer")
    kernels.count_launch(fused_layer)
    return out


fused_layer.launches = 0


def interleave_gate_up(wg: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """``[D, F]`` gate and up matrices (``[in, out]``) → ``[D, 2F]``:
    columns ``16 i .. 16 i + 7`` are gate features ``8 i .. 8 i + 7``,
    the next 8 the same up features."""
    d, f = wg.shape
    g = GATE_GROUP
    return torch.stack([wg.reshape(d, f // g, g), wu.reshape(d, f // g, g)],
                       dim=2).reshape(d, 2 * f)


def split_gate_up(wgu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse of :func:`interleave_gate_up`: ``(wg, wu)``."""
    d, f2 = wgu.shape
    w = wgu.reshape(d, f2 // (2 * GATE_GROUP), 2, GATE_GROUP)
    return w[:, :, 0].reshape(d, f2 // 2), w[:, :, 1].reshape(d, f2 // 2)


def gated_tower_eligible(d: int, f: int, heads: int) -> bool:
    """Static eligibility of an AIMv2 tower for the gated halves: whole
    heads of a width B3 has an instance for, GEMM-tileable widths (F in
    whole 32-feature output tiles) and the bf16 norm pass's width."""
    return (d % heads == 0 and d // heads in HEAD_DIMS and d % 64 == 0
            and f % 32 == 0 and d <= BF16_MAX_WIDTH)


def rms_f32(x: torch.Tensor, scale: torch.Tensor, eps: float,
            out_dtype) -> torch.Tensor:
    """RMSNorm over the last axis with f32 statistics:
    ``T(x · rsqrt(mean(x²) + eps) · scale)``."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(out_dtype)


def _dot_nb(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``T(a @ w)`` with an f32 matmul, no bias (``w`` is ``[in, out]``)."""
    return (a.float() @ w.float()).to(a.dtype)


def silu_gate_kernel_form(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The gated epilogue in ``g``'s dtype, every operation rounded to it:
    ``g · (1 / (1 + exp(-g))) · u``."""
    return g * (1.0 / (1.0 + torch.exp(-g))) * u


def rms_attn_half_ref(x2: torch.Tensor, ops: GatedOps, *, s: int,
                      heads: int, eps: float, causal: bool) -> torch.Tensor:
    """Plain PyTorch version of AIMv2's B5 over ``[B·S, D]`` tokens:
    RMSNorm-1 → QKV → per-item attention → out-proj → residual, no
    biases."""
    rms, wqkv, wout = ops[:3]
    t, d = x2.shape
    y = rms_f32(x2, rms[0], eps, x2.dtype)
    qkv = _dot_nb(y, wqkv).reshape(t // s, s, 3 * d)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    attn = attention_ref(q, k, v, num_heads=heads, valid_len=s,
                         causal=causal, scale=(d // heads) ** -0.5)
    return x2 + _dot_nb(attn.reshape(t, d), wout)


def gated_mlp_half_ref(x3: torch.Tensor, ops: GatedOps, *,
                       eps: float) -> torch.Tensor:
    """Plain PyTorch version of AIMv2's B6: RMSNorm-2 → gate and up →
    ``silu(g) · u`` → down → residual, no biases."""
    rms, wgu, wdown = ops[0], ops[3], ops[4]
    z = rms_f32(x3, rms[1], eps, x3.dtype)
    wg, wu = split_gate_up(wgu)
    h = silu_gate_kernel_form(_dot_nb(z, wg), _dot_nb(z, wu))
    return x3 + _dot_nb(h, wdown)


def _check_gated_operands(x2: torch.Tensor, ops: GatedOps, *, s: int = 1,
                          heads: int = 0) -> torch.device:
    """:func:`_check_operands` for AIMv2's operands; ``heads`` 0 skips
    the attention checks."""
    rms, wqkv, wout, wgu, wdown = ops
    dev = kernels.require_cuda(x2, *ops)
    t, d = x2.shape
    f = wdown.shape[0]
    if rms.dtype != torch.float32 or rms.shape != (2, d) \
            or any(w.dtype != x2.dtype for w in ops[1:]):
        raise ValueError("gated layer operands: rms f32 [2, D], the rest in "
                         "the activation dtype")
    if wqkv.shape != (d, 3 * d) or wout.shape != (d, d) \
            or wgu.shape != (d, 2 * f) or wdown.shape != (f, d) \
            or (heads and (d % heads or d // heads not in HEAD_DIMS)) \
            or d % 64 or f % 32 or t % s \
            or any(o.data_ptr() % 16 for o in (x2, *ops)) \
            or (x2.dtype == torch.bfloat16 and d > BF16_MAX_WIDTH):
        raise ValueError(f"unsupported gated layer shape: T={t} D={d} "
                         f"F={f} heads={heads} S={s} (operands must start "
                         f"16-byte aligned; bf16 D <= {BF16_MAX_WIDTH})")
    return dev


def rms_attn_half(x2: torch.Tensor, ops: GatedOps, *, s: int, heads: int,
                  eps: float, causal: bool) -> torch.Tensor:
    """AIMv2's first block half over flat ``[B·S, D]`` tokens: kernel B5
    with RMSNorm and bias-free projections on a CUDA tensor (B3 at head
    width 128 inside), :func:`rms_attn_half_ref` on a CPU tensor."""
    if x2.device.type == "cpu":
        return rms_attn_half_ref(x2, ops, s=s, heads=heads, eps=eps,
                                 causal=causal)
    dev = _check_gated_operands(x2, ops, s=s, heads=heads)
    rms, wqkv, wout = ops[:3]
    t, d = x2.shape
    out = torch.empty_like(x2)
    qkv = torch.empty((t, 3 * d), dtype=x2.dtype, device=dev)
    attn = torch.empty_like(x2)
    p = kernels.ptr
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().vqt_rms_attn_half(
            p(x2), p(out), p(qkv), p(attn), p(rms), p(wqkv), p(wout), t, s,
            d, heads, float(eps), int(causal), kernels.dtype_code(x2),
            kernels.stream(dev)), "RMSNorm attention half")
    kernels.count_launch(rms_attn_half)
    return out


rms_attn_half.launches = 0


def gated_mlp_half(x3: torch.Tensor, ops: GatedOps, *,
                   eps: float) -> torch.Tensor:
    """AIMv2's second block half: kernel B6 with RMSNorm and the SiLU-gated
    epilogue on a CUDA tensor, :func:`gated_mlp_half_ref` on a CPU
    tensor."""
    if x3.device.type == "cpu":
        return gated_mlp_half_ref(x3, ops, eps=eps)
    dev = _check_gated_operands(x3, ops)
    rms, wgu, wdown = ops[0], ops[3], ops[4]
    t, d = x3.shape
    f = wdown.shape[0]
    out = torch.empty_like(x3)
    h = torch.empty((t, f), dtype=x3.dtype, device=dev)
    p = kernels.ptr
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().vqt_gated_mlp_half(
            p(x3), p(out), p(h), p(rms[1]), p(wgu), p(wdown), t, d, f,
            float(eps), kernels.dtype_code(x3), kernels.stream(dev)),
            "gated MLP half")
    kernels.count_launch(gated_mlp_half)
    return out


gated_mlp_half.launches = 0


def _normalize_out(feats: torch.Tensor, dtype) -> torch.Tensor:
    """Round the projection output to the tower dtype, then L2 normalise
    in f32."""
    feats = feats.to(dtype).float()
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def fused_text_encode(model, input_ids: torch.Tensor,
                      layer_ops: List[LayerOps],
                      layer=fused_layer) -> torch.Tensor:
    """Full CLIP text encode through :func:`fused_layer`.

    ``model`` is the port's ``CLIP`` module (its embeddings, final LN and
    projection are read here); ``layer_ops`` the per-block operands from
    :func:`_layer_operands`; ``layer`` is :func:`fused_layer_ref` where a
    caller compares the kernel with the plain version on the card. Output
    ``[B, proj]`` f32 unit rows."""
    c = model.cfg.text
    tower = model.text
    dtype = tower.token_embedding.weight.dtype
    b, s = input_ids.shape
    x = tower.token_embedding.weight[input_ids] \
        + tower.position_embedding[:s][None]
    x2 = x.reshape(b * s, -1).contiguous()
    for ops in layer_ops:
        x2 = layer(x2, ops, s=s, heads=c.num_heads, eps=c.layer_norm_eps)
    # pool BEFORE the final LN (LayerNorm is per token), as the reference
    eot = torch.argmax(input_ids, dim=-1)
    pooled = x2[torch.arange(b, device=x2.device) * s + eot]
    fl = tower.final_layer_norm
    pooled = _ln_f32(pooled, fl.weight, fl.bias, c.layer_norm_eps, dtype)
    feats = pooled.float() @ model.text_projection.weight.float().t()
    return _normalize_out(feats, dtype)


def vision_embed(model, pixels: torch.Tensor) -> torch.Tensor:
    """The fused vision encode's prologue: normalised NHWC pixels →
    pre-LN tokens, flat ``[B·S, D]`` (the module tower's own embedding:
    patchify, class token, positions, pre-LN)."""
    x = model.vision.embed(pixels)
    return x.reshape(-1, x.shape[-1]).contiguous()


def vision_head(model, x2: torch.Tensor, b: int) -> torch.Tensor:
    """The fused vision encode's epilogue: CLS pooling → post-LN →
    projection → f32 L2 normalise, ``[B, proj]``."""
    c = model.cfg.vision
    post = model.vision.post_layernorm
    dtype = x2.dtype
    pooled = x2.reshape(b, -1, x2.shape[-1])[:, 0]
    pooled = _ln_f32(pooled, post.weight, post.bias, c.layer_norm_eps, dtype)
    feats = pooled.float() @ model.visual_projection.weight.float().t()
    return _normalize_out(feats, dtype)


def fused_vision_encode(model, pixels: torch.Tensor,
                        layer_ops: List[LayerOps], attn=attn_half,
                        mlp=mlp_half) -> torch.Tensor:
    """Full CLIP image encode through :func:`attn_half` and
    :func:`mlp_half` (non-causal, S = the tower's patches + 1).

    ``model`` is the port's ``CLIP`` module; ``pixels`` normalised NHWC
    ``[B, H, W, 3]`` in the tower dtype; ``layer_ops`` the per-block
    operands of ``model.vision.layers`` from :func:`_layer_operands`;
    ``attn``/``mlp`` are :func:`attn_half_ref`/:func:`mlp_half_ref` where a
    caller compares the kernels with the plain versions on the card.
    Output ``[B, proj]`` f32 unit rows."""
    c = model.cfg.vision
    b = pixels.shape[0]
    x2 = vision_embed(model, pixels)
    for ops in layer_ops:
        x2 = attn(x2, ops, s=c.seq_len, heads=c.num_heads,
                  eps=c.layer_norm_eps, causal=False)
        x2 = mlp(x2, ops, eps=c.layer_norm_eps)
    return vision_head(model, x2, b)


def fused_encode_shards(encode, replicas: Sequence, mesh,
                        x: torch.Tensor) -> torch.Tensor:
    """The data mesh's encode (JAX ``fused_encode_shard_map``): ``x``
    (``[b, ...]``, on any device) split into equal parts over the mesh's
    ``data`` axis, part ``i`` moved to ``mesh.data_devices[i]`` and
    encoded there by ``encode(replicas[i], part)`` (``[b / n, D]``, the
    replica's device), the rows gathered onto the first data device in
    order. Every part is enqueued before any is gathered, so parts on
    distinct cards overlap. Callers gate on ``b % n == 0`` (and each
    part's fused eligibility)."""
    devs = mesh.data_devices
    n = len(devs)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{n} data shards")
    step = x.shape[0] // n
    outs = [encode(replicas[i], x[i * step:(i + 1) * step].to(
        dev, non_blocking=True)) for i, dev in enumerate(devs)]
    return torch.cat([o.to(devs[0], non_blocking=True) for o in outs])
