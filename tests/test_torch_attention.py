"""Port attention (video_quierer_tpu_torch/ops/attention.py) vs the JAX
package's ``fused_attention`` with its Pallas kernel in interpret mode.

On the CPU the port runs the plain version (kernel B3 is held against it
on the card by tests/test_torch_kernels.py). Tolerances: f32 ``atol 1e-5`` (same math,
other summation order); bf16 ``atol 2e-2`` (bf16 rounding of q, the
exponentials and the weights at other points). Rows at ``s >= valid_len``
are garbage by contract and are not compared.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_quierer_tpu.ops.attention import fused_attention
from video_quierer_tpu_torch.ops.attention import attention

ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [(8, True, 8), (8, False, 5), (50, False, 50), (50, True, 33),
         (77, True, 77), (77, False, 60)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")


def _qkv(seed, b, s, d):
    # unit-scale logits, outputs within (-2, 2) where a bf16 ulp is < 1e-2
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal((b, s, d))).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,causal,valid", CASES)
def test_attention_matches_jax(dtype, s, causal, valid):
    q, k, v = _qkv(s, 2, s, 128)
    want = np.asarray(fused_attention(
        *(jnp.asarray(t, getattr(jnp, dtype)) for t in (q, k, v)),
        num_heads=2, valid_len=valid, causal=causal).astype(jnp.float32))
    got = attention(*(torch.from_numpy(t).to(getattr(torch, dtype))
                      for t in (q, k, v)),
                    num_heads=2, valid_len=valid, causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, s, 128)
    np.testing.assert_allclose(got.float().numpy()[:, :valid],
                               want[:, :valid], atol=ATOL[dtype], rtol=0)


def test_attention_counts_no_launch_on_cpu():
    before = attention.launches
    q, k, v = (torch.from_numpy(t) for t in _qkv(0, 1, 8, 128))
    attention(q, k, v, num_heads=2, causal=True)
    assert attention.launches == before
