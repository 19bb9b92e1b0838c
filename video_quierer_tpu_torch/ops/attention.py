"""Multi-head attention for the CLIP, SigLIP and AIMv2 towers
(counterpart of ``video_quierer_tpu/ops/attention.py``).

:func:`attention` takes ``q, k, v`` in the towers' h-minor projection
layout ``[B, S, H*hd]`` and returns ``[B, S, H*hd]``. On a CUDA tensor it
launches kernel B3 (``csrc/attention.cu``; head width 64, CLIP and
SigLIP, or 128, AIMv2: one compiled instance each, the second counted on
``attention.launches_hd128`` besides ``attention.launches``); on a CPU
tensor it runs the plain version :func:`attention_ref`. Both follow the
TPU kernel's contract:

- q is pre-scaled by ``hd**-0.5`` in f32, then rounded back to its dtype
  (on the card the kernel does it as it loads q);
- logits accumulate in f32; keys at positions ``>= valid_len`` are masked,
  and keys after the query for causal (text) attention;
- bf16: the clamped unstabilised softmax, each step rounded to bf16 —
  ``e = exp(bf16(min(l, 60)))``, ``w = e * (1 / sum(e))``; f32: the
  stabilised softmax;
- output rows at ``s >= valid_len`` are garbage by contract.

Gradients (JAX ``_attn``'s ``custom_vjp``, ``:198-221``): when grad mode
is on and an input requires a gradient, :func:`attention` runs through
:class:`AttentionFunction`, whose forward is the same kernel (or plain
version) and which saves only ``(q, k, v)``; its backward is the VJP of
:func:`einsum_attention` (JAX ``_einsum_attention``), recomputed from
those three tensors with batched matmuls and a softmax. The TPU package
has no backward kernel, so neither does the port. The forward's q is
pre-scaled and rounded while the recompute scales the f32 logits, and in
bf16 the forward's softmax is the clamped unstabilised one: the gradient
is the stabilised einsum path's, as in JAX. Under
``torch.inference_mode()`` (every embedder) nothing of this runs.
"""

from __future__ import annotations

import torch

from video_quierer_tpu_torch.ops import kernels

HEAD_DIM = 64       # the CLIP and SigLIP towers' head width
HEAD_DIM_WIDE = 128     # the AIMv2 towers' head width
# the longest S of each instance: one head's K (and V at hd 64) in f32,
# and Q, K and V of one head in bf16 at hd 128, must fit one SM's 227 KB
MAX_SEQ = {HEAD_DIM: 400, HEAD_DIM_WIDE: 272}
HEAD_DIMS = tuple(MAX_SEQ)


def kernel_takes(s: int, hd: int) -> bool:
    """Whether B3 has an instance for head width ``hd`` at length ``s``."""
    return hd in MAX_SEQ and 0 < s <= MAX_SEQ[hd]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  num_heads: int, valid_len: int, causal: bool,
                  scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch attention under the kernel's contract; ``q`` must
    already carry the ``hd**-0.5`` pre-scale (``scale`` multiplies the f32
    logits instead, the fused layer's form)."""
    b, s, d = q.shape
    hd = d // num_heads
    fast = q.dtype == torch.bfloat16

    def heads(t):
        return t.reshape(b, s, num_heads, hd).permute(0, 2, 1, 3).float()

    logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    col = torch.arange(s, device=q.device)
    mask = (col < valid_len)[None, :].expand(s, s)
    if causal:
        mask = mask & (col[:, None] >= col[None, :])
    logits = logits.masked_fill(~mask, float("-inf"))
    if fast:
        e = torch.exp(torch.clamp(logits, max=60.0).to(torch.bfloat16))
        den = e.sum(dim=-1, keepdim=True)
        w = e * (1.0 / den)
    else:
        w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(w.float(), heads(v))               # [B, H, S, hd]
    return out.permute(0, 2, 1, 3).reshape(b, s, d).to(q.dtype)


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *, num_heads: int, valid_len: int,
                     causal: bool) -> torch.Tensor:
    """The differentiable reference (JAX ``_einsum_attention``): f32
    logits of the unscaled q and k, times ``hd**-0.5``, masked, a
    stabilised f32 softmax, the weights cast to ``q.dtype``, then
    ``weights @ v`` in that dtype."""
    b, s, d = q.shape
    hd = d // num_heads

    def heads(t):
        return t.reshape(b, s, num_heads, hd).transpose(1, 2)

    logits = torch.matmul(heads(q).float(),
                          heads(k).float().transpose(-1, -2)) * hd ** -0.5
    col = torch.arange(s, device=q.device)
    mask = (col < valid_len)[None, :].expand(s, s)
    if causal:
        mask = mask & (col[:, None] >= col[None, :])
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(w, heads(v))                        # [B, H, S, hd]
    return out.transpose(1, 2).reshape(b, s, d)


class AttentionFunction(torch.autograd.Function):
    """Kernel B3 (or its plain version on the CPU) forward, the VJP of
    :func:`einsum_attention` backward, recomputed from ``(q, k, v)``."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, valid_len: int,
                causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.attn = dict(num_heads=num_heads, valid_len=valid_len,
                        causal=causal)
        return _forward(q, k, v, **ctx.attn)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = einsum_attention(*leaves, **ctx.attn)
            grads = torch.autograd.grad(out, leaves, grad)
        return (*grads, None, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              num_heads: int, valid_len: int | None = None,
              causal: bool = False) -> torch.Tensor:
    """Full (non-streamed) multi-head attention, ``[B, S, D]`` in and
    out (``fused_attention``'s interface); differentiable through
    :class:`AttentionFunction` when grad mode is on and an input requires
    a gradient."""
    if valid_len is None:
        valid_len = q.shape[1]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return AttentionFunction.apply(q, k, v, num_heads, valid_len,
                                       causal)
    return _forward(q, k, v, num_heads=num_heads, valid_len=valid_len,
                    causal=causal)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             num_heads: int, valid_len: int, causal: bool) -> torch.Tensor:
    """Kernel B3 on a CUDA tensor, :func:`attention_ref` on a CPU one."""
    b, s, d = q.shape
    hd = d // num_heads
    if q.device.type == "cpu":
        q = (q.float() * hd ** -0.5).to(q.dtype)
        return attention_ref(q, k, v, num_heads=num_heads,
                             valid_len=valid_len, causal=causal)
    dev = kernels.require_cuda(q, k, v)
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("q, k, v must share shape and dtype")
    if d != num_heads * hd or not kernel_takes(s, hd):
        raise ValueError(f"attention kernel takes head_dim and S in "
                         f"{MAX_SEQ} (S at most), got D={d}, "
                         f"H={num_heads}, S={s}")
    if q.dtype == torch.bfloat16 \
            and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 attention kernel loads 16-byte vectors: "
                         "q, k, v must start 16-byte aligned")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        kernels.check(kernels.lib().vqt_attention(
            kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
            kernels.ptr(out), b, s, num_heads, hd, d, d,
            int(valid_len), int(causal), hd ** -0.5, 1.0,
            kernels.dtype_code(q), kernels.stream(dev)), "attention")
    kernels.count_launch(attention)
    if hd == HEAD_DIM_WIDE:
        kernels.count_launch(attention, "launches_hd128")
    return out


attention.launches = 0
attention.launches_hd128 = 0
