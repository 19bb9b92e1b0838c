"""The embedder's data-mesh serving (``CLIPEmbedder(mesh=...)``,
``VideoSearchEngine(mesh=...)``) vs the JAX package's on its 8 virtual CPU
devices, on the same weights (moved with ``params_from_jax``): the port's
``data_mesh(devices=["cpu"] * 8)`` against JAX's ``data_mesh(8)``, the JAX
Pallas kernels in interpret mode, ``MIN_TOKENS`` lowered to 1 in both
packages (as ``tests/test_fused_layer.py:332`` lowers it) so an 8-way
split of a test-sized batch stays on the fused encodes.

- Text (32 queries: bucket 32, parts of 4 through the fused text encode,
  B2's plain version), frames (40: bucket 128, parts of 16 through the
  fused vision encode, B5 + B6's) and ``embed_frames_device``: f32 rows at
  cosine >= 1 - 1e-5 and within 2e-4, bf16 at cosine >= 0.999
  (``tests/test_torch_vision.py``'s bars). The per-part path is shown
  taken by spies on the embedder's fused encodes (the wrappers' launch
  counters count only launches on the card); a bucket that does not
  divide the axis (a single query's bucket of 1) takes the module tower
  whole, and at the default ``MIN_TOKENS`` the parts take the module
  tower, split the same way.
- The engine: both engines build their CLIP embedder on a data mesh from
  their configs, ingest a video, and serve ``search_ex``,
  ``search_batch`` and ``search_videos``: the same rows, scores within
  rtol 1e-5.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_synthetic_video
from tests.torch_parity import (
    TINY_224_FULL_VOCAB,
    TINY_FULL_VOCAB,
    port_state_dict,
    row_cosine,
)
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxEmbedder
from video_quierer_tpu.ops import fused_layer as jax_fl
from video_quierer_tpu.parallel import mesh as jax_mesh
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.models.clip import embedder as emb_mod
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
from video_quierer_tpu_torch.ops import fused_layer as torch_fl
from video_quierer_tpu_torch.parallel import mesh as port_mesh

N = 8
MIN_COS = {"float32": 1 - 1e-5, "bfloat16": 0.999}
F32_TOL = 2e-4
TEXTS = [f"a cat on a skateboard number {i}" for i in range(32)]


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("VQT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax_fl, "MIN_TOKENS", 1)
    monkeypatch.setattr(torch_fl, "MIN_TOKENS", 1)


@pytest.fixture
def spies(monkeypatch):
    """The batch sizes each fused encode of the port's embedder saw."""
    calls = {"vision": [], "text": []}
    for name, tag in (("fused_vision_encode", "vision"),
                      ("fused_text_encode", "text")):
        real = getattr(emb_mod, name)

        def spy(model, x, *a, _real=real, _tag=tag, **kw):
            calls[_tag].append(x.shape[0])
            return _real(model, x, *a, **kw)
        monkeypatch.setattr(emb_mod, name, spy)
    return calls


def _pair(dtype: str, name: str = TINY_FULL_VOCAB):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jax_emb = JaxEmbedder(name, dtype=jdt, mesh=jax_mesh.data_mesh(N))
    f32 = JaxEmbedder(name, dtype=jnp.float32)
    port = CLIPEmbedder(name, dtype=tdt, device="cpu",
                        state_dict=port_state_dict(f32.params, name),
                        mesh=port_mesh.data_mesh(devices=["cpu"] * N))
    return jax_emb, port


def _close(got, want, dtype):
    assert got.shape == want.shape
    assert row_cosine(got, want).min() >= MIN_COS[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_matches_jax(spies, dtype):
    jax_emb, port = _pair(dtype)
    assert port.mesh.shape == {"data": N, "model": 1}
    assert len(port._replicas) == N
    _close(port.embed_texts(TEXTS), jax_emb.embed_texts(TEXTS), dtype)
    assert spies["text"] == [32 // N] * N
    # the single query's bucket of 1 does not divide the axis: the module
    # tower, whole, on the embedder's device
    _close(port.embed_texts(TEXTS[:1]), jax_emb.embed_texts(TEXTS[:1]),
           dtype)
    assert spies["text"] == [32 // N] * N


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frames_match_jax(spies, dtype):
    jax_emb, port = _pair(dtype)
    frames = np.random.default_rng(4).integers(0, 256, (40, 32, 32, 3),
                                               dtype=np.uint8)
    feats_dev, got = port.embed_frames_device(frames)
    assert spies["vision"] == [128 // N] * N
    assert feats_dev.shape == (128, 64) and feats_dev.device == port.device
    assert torch.equal(feats_dev[:40], torch.from_numpy(got))
    _close(got, jax_emb.embed_frames(frames), dtype)
    assert np.array_equal(port.embed_frames(frames), got)


def test_parts_take_the_module_tower_below_the_gate(monkeypatch, spies):
    """At the default ``MIN_TOKENS`` a part of 4 queries (32 tokens) is
    below the fused gate: each part runs the module tower on its device,
    the rows still JAX's."""
    monkeypatch.setattr(jax_fl, "MIN_TOKENS", 256)
    monkeypatch.setattr(torch_fl, "MIN_TOKENS", 256)
    jax_emb, port = _pair("float32")
    split = []
    real = emb_mod.fused_encode_shards

    def spy(encode, replicas, mesh, x):
        split.append(x.shape[0])
        return real(encode, replicas, mesh, x)
    monkeypatch.setattr(emb_mod, "fused_encode_shards", spy)
    assert not port._fused_shard_ok(32, 16)
    _close(port.embed_texts(TEXTS), jax_emb.embed_texts(TEXTS), "float32")
    assert split == [32] and spies["text"] == []


def test_pp_with_a_data_mesh_raises():
    with pytest.raises(ValueError, match="data mesh"):
        CLIPEmbedder(TINY_FULL_VOCAB, dtype=torch.float32, device="cpu",
                     parallel="pp", mesh=port_mesh.data_mesh(
                         devices=["cpu"] * 2))


def test_fused_encode_shards_gathers_in_order():
    mesh = port_mesh.data_mesh(devices=["cpu"] * 4)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    out = torch_fl.fused_encode_shards(lambda r, part: part * r, [1, 2, 3, 4],
                                       mesh, x)
    want = x * torch.tensor([1, 2, 3, 4]).repeat_interleave(2)[:, None]
    assert torch.equal(out, want)
    with pytest.raises(ValueError, match="split"):
        torch_fl.fused_encode_shards(lambda r, p: p, [1] * 4, mesh, x[:6])


# -- the engine --------------------------------------------------------------


def _engine_config(mod, videos):
    cfg = mod.EngineConfig(videos_dir=str(videos),
                           api=mod.ApiConfig(max_frames=12))
    cfg.index.embed_dim = 64
    cfg.model.name = TINY_224_FULL_VOCAB
    cfg.model.dtype = "float32"
    return cfg


def test_engine_with_a_data_mesh_matches_jax(tmp_path, monkeypatch, spies):
    """Both engines build their embedder with the mesh they were given;
    the port's seeded init is swapped for JAX's weights so both serve the
    same tower."""
    f32 = JaxEmbedder(TINY_224_FULL_VOCAB, dtype=jnp.float32)
    sd = port_state_dict(f32.params, TINY_224_FULL_VOCAB)
    monkeypatch.setattr(emb_mod, "init_params", lambda cfg, gen: dict(sd))
    monkeypatch.setattr(emb_mod.convert_mod, "find_local_checkpoint",
                        lambda name: None)
    video = make_synthetic_video(tmp_path / "clip.mp4", n_frames=90)
    engines = []
    for tag, mod, cls, kw in (
            ("jax", jax_config, JaxEngine, {"mesh": jax_mesh.data_mesh(N)}),
            ("port", torch_config, VideoSearchEngine,
             {"device": "cpu",
              "mesh": port_mesh.data_mesh(devices=["cpu"] * N)})):
        d = tmp_path / tag
        d.mkdir()
        shutil.copy2(video, d / video.name)
        engine = cls(str(d), config=_engine_config(mod, d), **kw)
        engine.startup()
        engines.append(engine)
    jeng, peng = engines
    assert peng._embedder.mesh is peng.mesh
    assert len(peng.index) == len(jeng.index) == 12
    assert spies["vision"] == [32 // N] * N      # bucket 32 of 12 frames
    for q in ("a dog in the park", "night city " * 30):
        got = peng.search_ex(q, k=5, use_cache=False)[0]
        want = jeng.search(q, k=5, use_cache=False)
        assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got],
                                   [r["score"] for r in want], rtol=1e-5)
    batch = [f"batch query {i}" for i in range(8)]
    for g, w in zip(peng.search_batch(batch, k=4),
                    jeng.search_batch(batch, k=4)):
        assert [r["frame_id"] for r in g] == [r["frame_id"] for r in w]
        np.testing.assert_allclose([r["score"] for r in g],
                                   [r["score"] for r in w], rtol=1e-5)
    gv = peng.search_videos("a dog", k=1)
    wv = jeng.search_videos("a dog", k=1)
    assert [r["video_name"] for r in gv] == [r["video_name"] for r in wv]
    np.testing.assert_allclose([r["score"] for r in gv],
                               [r["score"] for r in wv], rtol=1e-5)
