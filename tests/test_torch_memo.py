"""The frame-embedding memo (``models/clip/embedder.py:MemoizedEmbedder``,
``cache.frame_memo_size > 0``) against the JAX package's, on the CPU:

- over the same frame batches through the same deterministic inner
  embedder, the two memos give the same rows and count the same hits and
  misses, and keep the same keys in the same order (least recently used
  first) as entries are evicted past ``max_size``; an inner embedder
  without ``embed_dim`` is probed from its output; the device path passes
  through unmemoized; text passes through;
- engines with ``ingest.stream_mirror = false`` and the memo on (each
  engine builds its tower, the parity towers of ``test_torch_ingest``,
  and wraps it): a ``rebuild`` of the same videos is all hits, embeds
  nothing and gives rows bit for bit equal to the first ingest's, with
  the JAX engine's hit and miss counts and rows.
"""

import numpy as np
import pytest

from tests.test_torch_ingest import (
    F32_TOL,
    jax_embedder,  # noqa: F401  (a fixture)
    port_embedder,  # noqa: F401  (a fixture)
    videos,  # noqa: F401  (a fixture)
)
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.models.clip import embedder as jax_embedder_mod
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.models.clip import embedder as port_embedder_mod

D = 16


class Inner:
    """A deterministic embedder: per-channel means and a few pixels."""

    def __init__(self, with_dim=True):
        if with_dim:
            self.embed_dim = D
        self.calls = []

    def embed_frames(self, frames):
        self.calls.append(len(frames))
        f = np.asarray(frames, np.float32)
        out = np.concatenate([f.mean(axis=(1, 2)),
                              f[:, ::50, ::50, 0].reshape(len(f), 4)],
                             axis=1)[:, :D]
        out = np.pad(out, ((0, 0), (0, D - out.shape[1])))
        return (out / (np.linalg.norm(out, axis=1, keepdims=True) + 1e-6)
                ).astype(np.float32)

    def embed_frames_device(self, frames):
        return "device", self.embed_frames(frames)

    def embed_text(self, text):
        return np.full(D, len(text), np.float32)

    def embed_texts(self, texts):
        return np.stack([self.embed_text(t) for t in texts])


def _frames(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                 dtype=np.uint8)


@pytest.mark.parametrize("with_dim", [True, False])
def test_memo_matches_jax(with_dim):
    pool = _frames(0, 12)
    batches = [pool[:5], pool[3:9], pool[[0, 1, 2]], pool[8:12],
               pool[[5, 5, 11, 0]], pool[:0], pool[6:12], pool[[2, 7]]]
    memos = [mod.MemoizedEmbedder(Inner(with_dim), max_size=7)
             for mod in (port_embedder_mod, jax_embedder_mod)]
    for batch in batches:
        got, want = (m.embed_frames(batch) for m in memos)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, Inner().embed_frames(batch))
        port, jax = memos
        assert (port.hits, port.misses) == (jax.hits, jax.misses)
        assert list(port._memo) == list(jax._memo)
        assert port.inner.calls == jax.inner.calls
    assert memos[0].hits > 0 and len(memos[0]._memo) == 7


def test_memo_passes_the_device_path_and_text_through():
    memo = port_embedder_mod.MemoizedEmbedder(Inner(), max_size=4)
    frames = _frames(1, 3)
    dev, host = memo.embed_frames_device(frames)
    assert dev == "device" and (memo.hits, memo.misses) == (0, 0)
    np.testing.assert_array_equal(host, Inner().embed_frames(frames))
    assert memo.embed_text("abc")[0] == 3
    assert memo.embed_texts(["a", "bb"]).shape == (2, D)
    assert memo.pretrained is False

    class HostOnly:
        embed_frames = Inner().embed_frames

    memo = port_embedder_mod.MemoizedEmbedder(HostOnly(), max_size=4)
    dev, host = memo.embed_frames_device(frames)
    assert dev is None and memo.misses == 3


def test_memo_engine_rebuild_is_all_hits(tmp_path, videos,  # noqa: F811
                                         jax_embedder, port_embedder,
                                         monkeypatch):
    monkeypatch.setattr(jax_embedder_mod, "CLIPEmbedder",
                        lambda **_kw: jax_embedder)
    monkeypatch.setattr(port_embedder_mod, "CLIPEmbedder",
                        lambda **_kw: port_embedder)
    engines = []
    for name, mod, cls in (("jax", jax_config, JaxEngine),
                           ("port", torch_config, VideoSearchEngine)):
        d = tmp_path / name
        d.mkdir()
        for clip in videos[:2]:
            (d / clip.name).write_bytes(clip.read_bytes())
        cfg = mod.EngineConfig(videos_dir=str(d),
                               api=mod.ApiConfig(max_frames=12))
        cfg.index.embed_dim = 64
        cfg.ingest.batch_size = 16
        cfg.ingest.stream_mirror = False
        cfg.cache.frame_memo_size = 64
        kw = {"device": "cpu"} if cls is VideoSearchEngine else {}
        engine = cls(d, config=cfg, **kw)
        engine.startup()
        engines.append(engine)
    jax_engine, port = engines
    memo = port._get_embedder()
    assert isinstance(memo, port_embedder_mod.MemoizedEmbedder)
    n = len(port.index)
    assert n > 0 and (memo.hits, memo.misses) == (0, n)
    first = port.index._emb[:n].copy()
    calls = {}
    real = port_embedder.embed_frames

    def counting(frames):
        calls["n"] = calls.get("n", 0) + len(frames)
        return real(frames)

    monkeypatch.setattr(port_embedder, "embed_frames", counting)
    assert port.rebuild() == n and jax_engine.rebuild() == n
    assert (memo.hits, memo.misses) == (n, n) and "n" not in calls
    jmemo = jax_engine._get_embedder()
    assert (jmemo.hits, jmemo.misses) == (memo.hits, memo.misses)
    np.testing.assert_array_equal(port.index._emb[:n], first)
    np.testing.assert_allclose(port.index._emb[:n], jax_engine.index._emb[:n],
                               rtol=F32_TOL, atol=F32_TOL)
    # the fused text paths drive the tower inside the memo
    assert port._tower() is port_embedder
    port.close()
