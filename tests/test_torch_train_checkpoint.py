"""The port's training checkpoints (video_quierer_tpu_torch/train/
checkpoint.py) and the train → serve loop (``model.orbax_checkpoint``),
on the CPU at the tiny widths:

- save and restore in the four EMA cases (an EMA on disk or not, into a
  trainer that tracks one or not): parameters, moments, count and step
  bit for bit, the EMA as the JAX package restores it; ``latest_step``;
  the write is atomic (a save that fails leaves no ``step_<N>`` and no
  temporary directory) and refuses to overwrite;
- both embedders and the engine serve a saved checkpoint: ``pretrained``
  true, the ``params`` tree (not the EMA) bit for bit, and vectors that
  equal the trainer's own towers' (per-row cosine >= 1 - 1e-5 in f32:
  the embedder's fused image encode sums in another order), the engine's
  search rows the host exact top-5 of the trainer's text vector;
- JAX and the port, trained the same two steps from the same parameters
  and each served by its own embedder from its own checkpoint, give
  vectors within per-row cosine 1 - 1e-4 (the two steps' Adam updates may
  differ by up to ``lr`` where a gradient is near 0);
- an orbax checkpoint written by the JAX package is not read: the port
  raises ``ValueError`` saying so (a divergence, ROADMAP C);
- ``python -m video_quierer_tpu_torch.train.finetune --device cpu`` on
  synthetic videos writes a checkpoint the embedder serves, and its
  mesh and MoE flags are refused (ROADMAP A11b).
"""

import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.helpers import make_synthetic_video
from tests.test_torch_siglip import tiny_configs
from tests.torch_parity import (
    TINY,
    TINY_224_FULL_VOCAB,
    TINY_FULL_VOCAB,
    jax_init,
    numpy_tree,
    one_torch_thread,
    row_cosine,
    token_ids,
)
from video_quierer_tpu.models.clip import config as jax_cfg
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxCLIPEmbedder
from video_quierer_tpu.models.clip.model import CLIP as JaxCLIP
from video_quierer_tpu.train import checkpoint as jax_ckpt
from video_quierer_tpu.train.trainer import CLIPTrainer as JaxTrainer
from video_quierer_tpu_torch.engine.config import EngineConfig
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.models.clip import bridge
from video_quierer_tpu_torch.models.clip import config as torch_cfg
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
from video_quierer_tpu_torch.models.siglip import embedder as semb
from video_quierer_tpu_torch.models.siglip import model as sm
from video_quierer_tpu_torch.ops.preprocess import (
    SIGLIP_MEAN,
    SIGLIP_STD,
    normalize_images,
)
from video_quierer_tpu_torch.train import checkpoint as ckpt
from video_quierer_tpu_torch.train import finetune
from video_quierer_tpu_torch.train.trainer import CLIPTrainer

ROOT = Path(__file__).resolve().parents[1]
COS = 1 - 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def no_discovery(monkeypatch, tmp_path):
    """No HF checkpoint found by discovery: ``HOME`` and the working
    directory empty, no ``VQT_CLIP_CHECKPOINT``."""
    monkeypatch.delenv("VQT_CLIP_CHECKPOINT", raising=False)
    monkeypatch.delenv("VQT_SIGLIP_SPIECE", raising=False)
    for sub in ("home", "cwd"):
        (tmp_path / sub).mkdir()
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path / "cwd")


def clip_batch(seed: int, b: int = 4, vocab: int = 49408):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
            token_ids(rng, b, 77, vocab))


def frames_u8(seed: int, b: int = 3, image: int = 32):
    return np.random.default_rng(seed).integers(
        0, 256, (b, image, image, 3), dtype=np.uint8)


def train_and_save(root: Path, family: str, ema: bool = True,
                   steps: int = 2, clip: str = TINY_FULL_VOCAB):
    """A tiny trainer of ``family`` ("clip": ``clip``, by default the tiny
    tower with the hash tokenizer's vocab, which serving needs; "siglip":
    the tiny SigLIP), ``steps`` steps on a seeded batch, saved under
    ``root``; returns (trainer, checkpoint path)."""
    kw = dict(learning_rate=1e-2, device="cpu",
              ema_decay=0.5 if ema else None)
    if family == "clip":
        cfg = torch_cfg.get_config(clip)
        trainer = CLIPTrainer(cfg, **kw)
        images, ids = clip_batch(0, vocab=cfg.text.vocab_size)
    else:
        trainer = CLIPTrainer(model=sm.SigLIP(tiny_configs()[1]), **kw)
        rng = np.random.default_rng(0)
        images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
        ids = rng.integers(1, 1000, (4, 16)).astype(np.int32)
    for _ in range(steps):
        trainer.step(images, ids)
    return trainer, ckpt.save_checkpoint(root, trainer,
                                         trainer.state.step)


def served_by(family: str, path: Path, dtype=torch.float32):
    if family == "clip":
        return CLIPEmbedder(TINY_FULL_VOCAB, orbax_checkpoint=path,
                            dtype=dtype, device="cpu")
    return semb.SigLIPEmbedder(tiny_configs()[1], orbax_checkpoint=path,
                               dtype=dtype, device="cpu")


def assert_serves_trainer(tower, trainer, family: str) -> None:
    """``tower`` holds the trainer's live parameters, bit for bit, and its
    vectors equal the trainer's towers'."""
    assert tower.pretrained is True
    live = trainer.state.params
    got = tower.params.state_dict()
    assert got.keys() == live.keys()
    assert all(torch.equal(got[k], live[k].detach()) for k in live)
    frames = frames_u8(5)
    texts = ["a dog on the beach", "two cats"]
    mean, std = ((SIGLIP_MEAN, SIGLIP_STD) if family == "siglip"
                 else ((0.48145466, 0.4578275, 0.40821073),
                       (0.26862954, 0.26130258, 0.27577711)))
    model = trainer.model
    with torch.no_grad():
        img = model.encode_image(normalize_images(
            torch.from_numpy(frames), mean=mean, std=std)).numpy()
        ids = tower.prepare_text_ids(tower.tokenizer(texts))
        txt = model.encode_text(torch.from_numpy(
            np.ascontiguousarray(ids, np.int64))).numpy()
    assert row_cosine(tower.embed_frames(frames), img).min() >= COS
    assert row_cosine(tower.embed_texts(texts), txt).min() >= COS


# -- save and restore ----------------------------------------------------------

@pytest.mark.parametrize("disk_ema", [True, False])
@pytest.mark.parametrize("trainer_ema", [True, False])
def test_round_trip_in_the_four_ema_cases(tmp_path, disk_ema, trainer_ema):
    src, path = train_and_save(tmp_path / "ck", "clip", ema=disk_ema,
                               clip=TINY)
    dst = CLIPTrainer(torch_cfg.get_config(TINY), seed=9, device="cpu",
                      ema_decay=0.5 if trainer_ema else None)
    assert ckpt.restore_checkpoint(tmp_path / "ck", dst) == 2
    assert path.name == "step_2"
    a, b = src.state, dst.state
    assert b.step == 2 and b.opt_state["count"] == a.opt_state["count"] == 2
    for got, want in ((b.params, a.params), (b.opt_state["mu"],
                                             a.opt_state["mu"]),
                      (b.opt_state["nu"], a.opt_state["nu"])):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    if not trainer_ema:
        assert b.ema_params is None       # an EMA on disk is dropped
        return
    want = a.ema_params if disk_ema else a.params   # or seeded from params
    assert all(torch.equal(b.ema_params[k], want[k]) for k in want)
    assert all(b.ema_params[k] is not b.params[k] for k in want)
    # the restored trainer steps on from where the saved one stopped
    images, ids = clip_batch(1, vocab=1000)
    assert np.isfinite(dst.step(images, ids)) and b.step == 3


def test_latest_step_and_the_atomic_write(tmp_path, monkeypatch):
    root = tmp_path / "ck"
    assert ckpt.latest_step(root) is None
    trainer, _ = train_and_save(root, "clip", steps=1, clip=TINY)
    ckpt.save_checkpoint(root, trainer, 7)
    (root / "step_x").mkdir()
    (root / "notes").mkdir()
    assert ckpt.latest_step(root) == 7
    with pytest.raises(FileExistsError):
        ckpt.save_checkpoint(root, trainer, 7)
    calls = []

    def failing_save(obj, f):
        calls.append(f)
        if len(calls) == 2:
            raise OSError("disk full")
        torch.save(obj, f)

    monkeypatch.setattr(ckpt.torch, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(root, trainer, 9)
    monkeypatch.undo()
    # no step_9 and no temporary directory left behind
    assert sorted(p.name for p in root.iterdir()) == \
        ["notes", "step_1", "step_7", "step_x"]
    assert ckpt.latest_step(root) == 7
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "empty", trainer)


def test_a_directory_that_is_not_a_port_checkpoint_raises(tmp_path):
    """An orbax checkpoint of the JAX package (written here by its own
    ``save_checkpoint``), an empty directory and a foreign manifest all
    raise the port's ``ValueError``, in the reader, the restore and both
    embedders."""
    fake = types.SimpleNamespace(state=types.SimpleNamespace(
        params={"w": jnp.ones((2, 3))}, opt_state={"count": jnp.zeros(())},
        ema_params=None))
    orbax_dir = jax_ckpt.save_checkpoint(tmp_path / "orbax", fake, 1)
    (tmp_path / "empty").mkdir()
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / ckpt.MANIFEST).write_text('{"format": "other/1"}')
    trainer = CLIPTrainer(torch_cfg.get_config(TINY), device="cpu")
    for d, match in ((orbax_dir, "not a checkpoint of the port"),
                     (tmp_path / "empty", "not a checkpoint of the port"),
                     (foreign, "not the port's")):
        with pytest.raises(ValueError, match=match):
            ckpt.load_params(d)
        with pytest.raises(ValueError, match=match):
            ckpt.read_manifest(d)
        for family in ("clip", "siglip"):
            with pytest.raises(ValueError, match=match):
                served_by(family, d)
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        ckpt.restore_checkpoint(tmp_path / "orbax", trainer, step=1)


# -- train → serve ---------------------------------------------------------------

@pytest.mark.parametrize("family", ["clip", "siglip"])
def test_embedders_serve_a_trained_checkpoint(tmp_path, family):
    """The ``params`` tree is served (not the EMA, as the reference reads
    it), with ``pretrained`` true; bf16 serving casts the same weights."""
    trainer, path = train_and_save(tmp_path / "ck", family)
    assert_serves_trainer(served_by(family, path), trainer, family)
    bf16 = served_by(family, path, torch.bfloat16)
    assert bf16.pretrained is True
    assert all(torch.equal(v, trainer.state.params[k].detach().bfloat16())
               for k, v in bf16.params.state_dict().items())
    assert bf16.load_seconds.keys() >= {"read_trained", "load", "device"}


def write_cache(path: Path, rows: np.ndarray) -> None:
    idx = DeviceVideoIndex(dim=rows.shape[1], device="cpu")
    idx.add_batch(rows, "v.mp4", [0.5 * t for t in range(len(rows))])
    assert idx.save_to_disk(path)


def test_engine_serves_a_trained_checkpoint(tmp_path):
    """``model.orbax_checkpoint`` through the engine's config: the tower
    it builds serves the checkpoint, and a text search returns the host
    exact top-5 of the trainer's own text vector (f32 tier)."""
    trainer, path = train_and_save(tmp_path / "ck", "clip")
    videos = tmp_path / "videos"
    videos.mkdir()
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((300, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    write_cache(videos / "video_search_cache.pkl", rows)
    cfg = EngineConfig(videos_dir=str(videos))
    cfg.model.name, cfg.model.dtype = TINY_FULL_VOCAB, "float32"
    cfg.model.orbax_checkpoint = str(path)
    cfg.index.embed_dim, cfg.index.device_dtype = 64, "float32"
    engine = VideoSearchEngine(videos, config=cfg, device="cpu")
    try:
        engine.startup()
        tower = engine._tower()
        assert engine.stats()["pretrained"] is True
        assert_serves_trainer(tower, trainer, "clip")
        ids = tower.prepare_text_ids(tower.tokenizer(["a red car"]))
        with torch.no_grad():
            q = trainer.model.encode_text(torch.from_numpy(
                np.ascontiguousarray(ids, np.int64)))[0].numpy()
        got = engine.search("a red car", k=5, use_cache=False)
        want = np.argsort(-(rows @ q), kind="stable")[:5]
        assert [r["frame_id"] for r in got] == want.tolist()
    finally:
        engine.close()


def test_jax_and_port_trained_alike_serve_alike(tmp_path):
    """Both packages train two steps from the same parameters on the same
    batch, save, and serve from their own checkpoints (JAX: orbax, the
    Pallas attention in interpret mode)."""
    images, ids = clip_batch(2)
    frames, texts = frames_u8(6), ["a dog on the beach", "two cats"]
    kw = dict(learning_rate=1e-3, max_grad_norm=1.0, ema_decay=0.9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VQT_PALLAS_INTERPRET", "1")
        params = jax_init(JaxCLIP(jax_cfg.get_config(TINY_FULL_VOCAB)), 32,
                          77)
        tcfg = torch_cfg.get_config(TINY_FULL_VOCAB)
        # the JAX step donates its state, params included: bridge first
        sd = bridge.params_from_jax(numpy_tree(params), tcfg)
        ref = JaxTrainer(jax_cfg.get_config(TINY_FULL_VOCAB), params=params,
                         **kw)
        want_losses = [ref.step(images, ids) for _ in range(2)]
        jpath = jax_ckpt.save_checkpoint(tmp_path / "jax", ref, 2)
        served = JaxCLIPEmbedder(TINY_FULL_VOCAB, orbax_checkpoint=jpath,
                                 dtype=jnp.float32)
        want = (served.embed_frames(frames), served.embed_texts(texts))
    port = CLIPTrainer(tcfg, params=sd, device="cpu", **kw)
    losses = [port.step(images, ids) for _ in range(2)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    tower = CLIPEmbedder(TINY_FULL_VOCAB, orbax_checkpoint=ckpt.
                         save_checkpoint(tmp_path / "port", port, 2),
                         dtype=torch.float32, device="cpu")
    assert tower.pretrained is True and served.pretrained is True
    for got, exp in zip((tower.embed_frames(frames),
                         tower.embed_texts(texts)), want):
        assert row_cosine(got, exp).min() >= 1 - 1e-4


# -- the fine-tuning CLI -----------------------------------------------------

def test_finetune_cli_writes_a_servable_checkpoint(tmp_path):
    videos = tmp_path / "videos"
    videos.mkdir()
    for name in ("a_red_car.mp4", "blue-sky.mp4"):
        make_synthetic_video(videos / name, n_frames=30, size=(64, 48))
    out = tmp_path / "out"
    assert finetune.main([
        "--videos-dir", str(videos), "--out", str(out),
        "--model", TINY_224_FULL_VOCAB, "--device", "cpu", "--batch", "4",
        "--max-frames-per-video", "8", "--lr", "1e-3", "--schedule",
        "cosine", "--warmup-steps", "1", "--total-steps", "4",
        "--max-grad-norm", "1.0", "--ema-decay", "0.9"]) == 0
    # 5 frames a video by the "medium" interval: two whole batches of 4
    assert ckpt.latest_step(out) == 2
    tower = CLIPEmbedder(TINY_224_FULL_VOCAB, orbax_checkpoint=out / "step_2",
                         dtype=torch.float32, device="cpu")
    assert tower.pretrained is True
    vecs = tower.embed_frames(frames_u8(7, image=224))
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=-1), 1.0,
                               rtol=1e-5)
    assert (out / "step_2" / "ema_params.pt").exists()


def test_finetune_cli_refuses_meshes_and_moe(tmp_path):
    """``python -m ...finetune --dp 2 --device cpu`` builds its mesh and
    runs up to the missing videos; so do the other axes and
    ``--moe-experts`` with ``--ep`` (in process; the mesh runs:
    ``tests/test_torch_train_mesh.py``); ``--moe-experts`` at ``--ep 1``
    trains (its run: ``tests/test_torch_moe.py``), here up to the missing
    videos. JAX's refusals stay: ``--tp`` with ``--ep``, and a mesh larger
    than the cards there are."""
    proc = subprocess.run(
        [sys.executable, "-m", "video_quierer_tpu_torch.train.finetune",
         "--videos-dir", str(tmp_path), "--out", str(tmp_path / "o"),
         "--dp", "2", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0 and "no videos" in proc.stderr
    assert "A11b" not in proc.stderr
    assert not (tmp_path / "o").exists()
    base = ["--videos-dir", str(tmp_path), "--out", str(tmp_path / "o")]
    for flags in (["--tp", "2"], ["--ep", "4"],
                  ["--moe-experts", "8", "--ep", "2"]):
        with pytest.raises(SystemExit, match="no videos"):
            finetune.main(base + ["--device", "cpu", "--model",
                                  TINY_FULL_VOCAB] + flags)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        finetune.main(base + ["--tp", "2", "--ep", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="mesh needs 2 devices"):
            finetune.main(base + ["--dp", "2"])
    for flags in ([], ["--moe-experts", "8"]):
        with pytest.raises(SystemExit, match="no videos"):
            finetune.main(base + ["--device", "cpu", "--model",
                                  TINY_FULL_VOCAB] + flags)