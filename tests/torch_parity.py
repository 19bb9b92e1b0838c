"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The same numpy-seeded inputs go through the JAX package and the PyTorch
port; weights cross with ``params_from_jax``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from video_quierer_tpu.models.clip import config as jax_cfg
from video_quierer_tpu_torch.models.clip import config as torch_cfg
from video_quierer_tpu_torch.models.clip.bridge import params_from_jax

# tiny towers: text 2 layers, width 128, 2 heads of 64; vision 32 px
# frames in 8 px patches (S = 17), width 128, 2 heads of 64, 2 layers
TINY = "torch-parity-tiny"
# same widths with the full CLIP vocab / context (HashTokenizer ids)
TINY_FULL_VOCAB = "torch-parity-tiny-vocab"
# same widths on the ingest pipeline's 224 px frames: 56 px patches, S = 17
TINY_224 = "torch-parity-tiny-224"
# TINY_224 with the full CLIP vocab: ingest and text search in one engine
TINY_224_FULL_VOCAB = "torch-parity-tiny-224-vocab"


# Switch-MoE towers (tests/test_torch_moe.py): 4 vision layers, 4 experts
# in layers 1 and 3 (moe_every 2), capacity factor 1.25
TINY_MOE = "torch-parity-tiny-moe"
TINY_MOE_224 = "torch-parity-tiny-moe-224-vocab"
# TINY_FULL_VOCAB with 4 experts in its layer 1: what ``finetune
# --moe-experts 4`` trains from TINY_FULL_VOCAB
TINY_MOE_VOCAB = "torch-parity-tiny-moe-vocab"
# a 4-layer dense tower for the pipelined image tower (1, 2 or 4 stages)
TINY_PP_224 = "torch-parity-tiny-pp-224-vocab"


def _tiny(vocab: int, context: int, image: int = 32, patch: int = 8,
          layers: int = 2, **moe):
    def factory():
        return jax_cfg.CLIPConfig(
            name=TINY, projection_dim=64,
            vision=jax_cfg.CLIPVisionConfig(image_size=image,
                                            patch_size=patch,
                                            hidden_size=128,
                                            num_layers=layers,
                                            num_heads=2, **moe),
            text=jax_cfg.CLIPTextConfig(vocab_size=vocab,
                                        context_length=context,
                                        hidden_size=128, num_layers=2,
                                        num_heads=2))
    return factory


def _as_torch_cfg(factory):
    def torch_factory():
        c = factory()
        return torch_cfg.CLIPConfig(
            name=c.name, projection_dim=c.projection_dim,
            vision=torch_cfg.CLIPVisionConfig(**vars(c.vision)),
            text=torch_cfg.CLIPTextConfig(**vars(c.text)))
    return torch_factory


for _name, _factory in ((TINY, _tiny(1000, 77)),
                       (TINY_FULL_VOCAB, _tiny(49408, 77)),
                       (TINY_224, _tiny(1000, 77, image=224, patch=56)),
                       (TINY_224_FULL_VOCAB,
                        _tiny(49408, 77, image=224, patch=56)),
                       (TINY_MOE, _tiny(1000, 77, layers=4, moe_experts=4)),
                       (TINY_MOE_VOCAB, _tiny(49408, 77, moe_experts=4)),
                       (TINY_MOE_224, _tiny(49408, 77, image=224, patch=56,
                                            layers=4, moe_experts=4)),
                       (TINY_PP_224, _tiny(49408, 77, image=224, patch=56,
                                           layers=4))):
    jax_cfg.register_config(_name, _factory)
    torch_cfg.register_config(_name, _as_torch_cfg(_factory))


@contextlib.contextmanager
def one_torch_thread():
    """torch's CPU ops on one thread (tiny tensors gain nothing from
    more, and the parallel test workers share the cores), restored on
    exit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def jax_init(model, image: int, context: int):
    """A flax tower's ``params`` at seed 0, its init jitted (the eager
    init traces op by op, ~2x slower)."""
    return jax.jit(lambda key: model.init(
        key, jnp.zeros((1, image, image, 3)),
        jnp.zeros((1, context), jnp.int32))["params"])(jax.random.PRNGKey(0))


def numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def port_state_dict(jax_params, name: str = TINY):
    return params_from_jax(numpy_tree(jax_params),
                           torch_cfg.get_config(name))


def token_ids(rng, b: int, s: int, vocab: int) -> np.ndarray:
    """Ids with the max (EOT) at a random position per row, zero after."""
    ids = rng.integers(1, vocab - 2, size=(b, s))
    eot = rng.integers(s // 2, s, size=b)
    for i in range(b):
        ids[i, eot[i]] = vocab - 1
        ids[i, eot[i] + 1:] = 0
    return ids.astype(np.int32)


def row_cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return np.sum(a * b, axis=-1)


def unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def reciprocal_case_queries(n: int, d: int, seed: int = 2) -> np.ndarray:
    """Unit queries, every other one chosen so that its scale ``max |q| /
    127`` as a true divide differs from the reciprocal multiply ``max |q|
    * float32(1/127)`` that XLA compiles the quantized scans' divide to."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        q = unit_rows(rng, 1, d)[0]
        m = np.abs(q).max()
        if len(out) % 2 or m / np.float32(127) != m * np.float32(1 / 127):
            out.append(q)
    return np.stack(out)


def jax_kmeans_init(n: int, n_clusters: int, seed: int = 0) -> np.ndarray:
    """The seed rows the JAX package's ``_kmeans`` draws
    (``video_quierer_tpu/index/ivf.py:208-209``), for the port's
    ``_kmeans`` and ``init_indices``."""
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), n,
                                      (n_clusters,), replace=False))


def ivf_state(ivf) -> dict:
    """A built JAX ``IVFIndex`` as the numpy arguments of the port's
    ``IVFIndex.load_built``."""
    return {"centroids": np.asarray(ivf._centroids_np),
            "tiled": np.asarray(ivf._tiled),
            "row_ids": np.asarray(ivf._row_ids),
            "tile_start": np.asarray(ivf._tile_start_np),
            "tile_counts": np.asarray(ivf._tile_counts_np),
            "n_built": ivf._n_built, "nlist": ivf.nlist,
            "nprobe": ivf.nprobe, "fresh": ivf._fresh}
