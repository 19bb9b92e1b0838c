"""Port quantizers (video_quierer_tpu_torch/ops/quantize.py) vs the JAX
package's: int8 and int4 codes and scales bit-identical (no tolerance) to
``quantize_rows``, ``quantize_rows_int4``, the host twins and the int8
host quantizer of the JAX index, on rows that include all-zero rows and
values exactly halfway between two codes; and the query quantizer of the
quantized scans on queries whose scale ``qabs / 127`` rounds differently
as a true divide than as XLA's reciprocal multiply.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import reciprocal_case_queries
from video_quierer_tpu.index.device_index import \
    DeviceVideoIndex as JaxIndex
from video_quierer_tpu.ops import quantize as jax_q
from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu_torch.ops import quantize as torch_q
from video_quierer_tpu_torch.ops import topk as torch_topk


def _rows(seed, n=300, d=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[3] = 0.0                                  # zero row: scale 0
    # exact halves: absmax 127 (int8 scale 1.0), 7 (int4 scale 1.0)
    x[5] = 0.0
    x[5, :4] = [127.0, 0.5, 2.5, -3.5]
    x[6] = 0.0
    x[6, :4] = [7.0, 0.5, -1.5, 2.5]
    return x


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_codes_and_scales_bit_identical(tier):
    x = _rows(0)
    jax_fn, torch_fn, host_fn = {
        "int8": (jax_q.quantize_rows, torch_q.quantize_rows,
                 torch_q.quantize_rows_np),
        "int4": (jax_q.quantize_rows_int4, torch_q.quantize_rows_int4,
                 torch_q.quantize_rows_int4_np),
    }[tier]
    jc, js = (np.asarray(a) for a in jax_fn(jnp.asarray(x)))
    tc, ts = torch_fn(torch.from_numpy(x))
    hc, hs = host_fn(x)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert hc.dtype == np.int8 and hs.dtype == np.float32
    for c, s in ((tc.numpy(), ts.numpy()), (hc, hs)):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(_bits(s), _bits(js))
    assert js[3, 0] == 0 and not jc[3].any()
    # round half to even at the exact halves
    if tier == "int8":
        assert jc[5, :4].tolist() == [127, 0, 2, -4]
    else:
        np.testing.assert_array_equal(
            torch_q.unpack_int4_np(hc)[6, :4], [7, 0, -2, 2])


def test_host_twins_match_jax_host_paths():
    x = _rows(1)
    idx = JaxIndex(dim=64, device_dtype="int8")
    jc, js = idx._quantize_host(x)
    hc, hs = torch_q.quantize_rows_np(x)
    np.testing.assert_array_equal(hc, jc)
    np.testing.assert_array_equal(_bits(hs), _bits(js))
    jc4, js4 = jax_q.quantize_rows_int4_np(x)
    hc4, hs4 = torch_q.quantize_rows_int4_np(x)
    np.testing.assert_array_equal(hc4, jc4)
    np.testing.assert_array_equal(_bits(hs4), _bits(js4))
    np.testing.assert_array_equal(torch_q.unpack_int4_np(hc4),
                                  jax_q.unpack_int4_np(jc4))


def test_query_quantization_uses_the_reciprocal_multiply():
    q = reciprocal_case_queries(16, 64)
    m = np.abs(q).max(axis=1, keepdims=True)
    assert (m / np.float32(127) != m * np.float32(1 / 127)).sum() >= 8
    codes, scale = torch_q.quantize_rows(torch.from_numpy(q))

    # the JAX scans' query quantization, as written there and compiled
    # (XLA turns the divide by the constant into a reciprocal multiply
    # under jit; run op by op it would be a true divide)
    @jax.jit
    def jax_quantize(queries):
        qabs = jnp.max(jnp.abs(queries), axis=-1, keepdims=True)
        qscale = (qabs / 127.0).astype(jnp.float32)
        qsafe = jnp.where(qscale > 0, qscale, 1.0)
        return (jnp.clip(jnp.round(queries / qsafe), -127,
                         127).astype(jnp.int8), qscale)

    want_codes, want_scale = (np.asarray(a)
                              for a in jax_quantize(jnp.asarray(q)))
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(want_scale))
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    # and the tiny-corpus int8 scan scores (raw * qscale * row scale)
    emb_c, emb_s = jax_q.quantize_rows(jnp.asarray(_rows(3, n=40)))
    jv, _ = jax_topk._approx_scan_int8(
        emb_c, emb_s, jnp.asarray(q), jnp.int32(40), k=40, recall=0.99,
        native=True)
    tv, _ = torch_topk._approx_scan_int8(
        torch.from_numpy(np.array(emb_c)), torch.from_numpy(
            np.array(emb_s)), torch.from_numpy(q), 40, k=40, perm=None)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(np.asarray(jv)))
