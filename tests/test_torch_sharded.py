"""Corpus-sharded scans (video_quierer_tpu_torch/index/sharded.py) vs the
JAX package's ``sharded_cosine_topk`` / ``_int8`` and the ``multislice_*``
twins: the port's eight shards on the CPU (``corpus_mesh(8, devices=
["cpu"] * 8)``, its plain versions) against the JAX mesh over the eight
virtual CPU devices of ``tests/conftest.py`` (its Pallas kernels in
interpret mode), ``CAND_BUCKET`` 128 in both.

Every impl: ``"exact"`` (B8 over f32 and bf16 shards, B9 over int8 ones)
and the candidate stages (B10, B11) with and without the perm column. The
inputs make every score exact (rows multiples of 1/64; queries multiples
of 1/4096, or ``c / 1024`` with int8 codes and power-of-two scales), so
no tolerance: the merged lists are identical, ties broken alike (equal
rows on several shards). Shards without a live row are included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_quierer_tpu.index import sharded as jax_sh
from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu.parallel import mesh as jax_mesh
from video_quierer_tpu_torch.index import sharded as port_sh
from video_quierer_tpu_torch.ops import topk as torch_topk
from video_quierer_tpu_torch.parallel import mesh as port_mesh

SHARDS, SHARD_ROWS, D = 8, 4096, 128
N_PAD = SHARDS * SHARD_ROWS
CPU8 = ["cpu"] * SHARDS


@pytest.fixture
def bucket128(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_topk, "CAND_BUCKET", 128)
    monkeypatch.setattr(torch_topk, "CAND_BUCKET", 128)


def _meshes(slices):
    assert jax.device_count() >= SHARDS
    if slices == 1:
        return (jax_mesh.corpus_mesh(SHARDS),
                port_mesh.corpus_mesh(SHARDS, devices=CPU8))
    return (jax_mesh.multislice_corpus_mesh(slices, SHARDS),
            port_mesh.multislice_corpus_mesh(slices, SHARDS, devices=CPU8))


def _rows(seed):
    """Multiples of 1/64 in [-1/8, 1/8]; rows repeated on three shards."""
    rng = np.random.default_rng(seed)
    rows = (rng.integers(-8, 9, (N_PAD, D)) / 64).astype(np.float32)
    for s in (3, 6):
        rows[s * SHARD_ROWS + 10: s * SHARD_ROWS + 60] = rows[10:60]
    return rows


def _queries(seed, b):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1024, 1025, (b, D)) / 4096).astype(np.float32)


def _int8_case(seed, b):
    """int8 codes with power-of-two scales and queries ``c / 1024`` (their
    codes ``c``, scale ``2^-10``): exact scores in every contract."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (N_PAD, D)).astype(np.int8)
    codes[5 * SHARD_ROWS: 5 * SHARD_ROWS + 50] = codes[:50]
    scales = (2.0 ** -rng.integers(7, 9, (N_PAD, 1))).astype(np.float32)
    c = rng.integers(-126, 127, (b, D))
    c[:, 0] = 127
    return codes, scales, (c / 1024).astype(np.float32)


def _perm(seed, valid, dead_shard):
    """Full-capacity permutation; with ``dead_shard`` the last shard holds
    only host rows >= valid."""
    rng = np.random.default_rng(seed)
    if not dead_shard:
        return rng.permutation(N_PAD).astype(np.int32)
    head = N_PAD - SHARD_ROWS
    assert valid <= head
    return np.concatenate([rng.permutation(head),
                           head + rng.permutation(SHARD_ROWS)]).astype(
                               np.int32)


def _run(int8, operands, q, valid, k, impl, perm, slices, bf16=False):
    """Both packages' scan over the same shards; the merged lists must be
    identical. ``bf16``: the float rows go in as bf16."""
    jm, pm = _meshes(slices)
    jfn = {(False, 1): jax_sh.sharded_cosine_topk,
           (False, 2): jax_sh.multislice_cosine_topk,
           (True, 1): jax_sh.sharded_cosine_topk_int8,
           (True, 2): jax_sh.multislice_cosine_topk_int8}[int8, slices]
    pfn = {(False, 1): port_sh.sharded_cosine_topk,
           (False, 2): port_sh.multislice_cosine_topk,
           (True, 1): port_sh.sharded_cosine_topk_int8,
           (True, 2): port_sh.multislice_cosine_topk_int8}[int8, slices]
    jops = [jax_sh.shard_corpus(
        jnp.asarray(o, jnp.bfloat16 if bf16 else None), jm)
        for o in operands]
    pops = [port_sh.shard_corpus(torch.from_numpy(o), pm,
                                 torch.bfloat16 if bf16 else None)
            for o in operands]
    jperm = pperm = None
    if perm is not None:
        jperm = jax_sh.shard_corpus_vec(jnp.asarray(perm), jm)
        pperm = port_sh.shard_corpus_vec(torch.from_numpy(perm), pm)
    jv, ji = jfn(*jops, jnp.asarray(q), valid, k=k, mesh=jm, impl=impl,
                 perm=jperm)
    pv, pi = pfn(*pops, torch.from_numpy(q), valid, k=k, mesh=pm,
                 impl=impl, perm=pperm)
    assert pv.shape == pi.shape == (q.shape[0], k)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    return pv.numpy(), pi.numpy()


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [N_PAD - 321, 3 * SHARD_ROWS + 100])
def test_exact_matches_jax(bucket128, dtype, valid, slices):
    """Identity layout: shard-local valid counts (the second ``valid``
    leaves shards 4-7 without a live row), offsets back to global rows."""
    q = _queries(2, 3)
    pv, pi = _run(False, [_rows(1)], q, valid, 40, "exact", None, slices,
                  bf16=dtype == "bfloat16")
    live = np.isfinite(pv)
    assert (pi[live] < valid).all()


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("perm_kind", ["none", "perm", "dead_shard"])
def test_cand_bf16_matches_jax(bucket128, perm_kind, slices):
    """B10 per shard: with the perm column (liveness ``perm < valid``
    against the global count, host rows out; one shard all dead) and
    without it (identity perm, shard-local valid)."""
    valid = 20000
    perm = None if perm_kind == "none" else _perm(3, valid,
                                                  perm_kind == "dead_shard")
    pv, pi = _run(False, [_rows(4)], _queries(5, 4), valid, 40, "cand", perm,
                  slices, bf16=True)
    assert (pi[np.isfinite(pv)] < valid).all()


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("impl,perm_kind", [("exact", "none"),
                                            ("cand", "none"),
                                            ("cand", "perm"),
                                            ("cand", "dead_shard")])
def test_int8_matches_jax(bucket128, impl, perm_kind, slices):
    """B9 (exact) and B11 (cand) per shard."""
    valid = 20000
    codes, scales, q = _int8_case(6, 3)
    perm = None if perm_kind == "none" else _perm(7, valid,
                                                  perm_kind == "dead_shard")
    _run(True, [codes, scales], q, valid, 40, impl, perm, slices)


def test_exact_ties_break_to_the_lowest_global_row():
    """Equal best rows on shards 0, 3 and 7 come back in global row order,
    and the first device receives the merged lists."""
    mesh = port_mesh.corpus_mesh(SHARDS, devices=CPU8)
    emb = np.zeros((SHARDS * 1024, D), np.float32)
    for r in (5, 3 * 1024 + 1, 7 * 1024 + 9):
        emb[r, 0] = 1.0
    q = np.zeros((1, D), np.float32)
    q[0, 0] = 1.0
    vals, idxs = port_sh.sharded_cosine_topk(
        port_sh.shard_corpus(torch.from_numpy(emb), mesh),
        torch.from_numpy(q), emb.shape[0], k=3, mesh=mesh)
    assert idxs[0].tolist() == [5, 3 * 1024 + 1, 7 * 1024 + 9]
    assert vals.device == mesh.devices[0]


def test_errors():
    mesh = port_mesh.corpus_mesh(SHARDS, devices=CPU8)
    emb = port_sh.shard_corpus(torch.zeros(SHARDS * 1024, D), mesh)
    q = torch.zeros(1, D)
    with pytest.raises(ValueError, match="divisible"):
        port_sh.shard_corpus(torch.zeros(1001, D), mesh)
    with pytest.raises(ValueError, match="k must be"):
        port_sh.sharded_cosine_topk(emb, q, 10, k=65, mesh=mesh)
    with pytest.raises(ValueError, match="identity-layout"):
        port_sh.sharded_cosine_topk(emb, q, 10, k=5, mesh=mesh,
                                    perm=[torch.zeros(1024, dtype=torch.int32)]
                                    * SHARDS)
    with pytest.raises(ValueError, match="shards"):
        port_sh.sharded_cosine_topk(emb[:4], q, 10, k=5, mesh=mesh)
