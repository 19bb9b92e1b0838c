"""Checkpoint loading of the port (``models/clip/convert.py``,
``models/siglip/convert.py``, the embedders' and the engine's checkpoint
routes) against the JAX package's, on HF-layout checkpoint directories the
tests write themselves (nothing is downloaded):

- (a) the port's safetensors reader against ``safetensors.numpy.load_file``,
  array for array and dtype for dtype (F32, F16, I64, every integer and
  float dtype numpy has, a scalar, an empty tensor, a ``__metadata__``
  header); both raise on ``BF16`` (``TypeError``) and on a header that
  does not cover the file;
- (b) ``convert_hf_checkpoint`` and ``convert_siglip_checkpoint`` against
  the JAX converters, bit for bit, from ``model.safetensors`` and from
  ``pytorch_model.bin``, with the ``position_ids`` buffers of older HF
  checkpoints in the file (read by neither);
- (c) the embedders loaded from a directory against the JAX embedders
  loaded from the same directory (per-row cosine >= 1 - 1e-5 in f32, >=
  0.999 in bf16) and against ``transformers``' own ``get_text_features``/
  ``get_image_features`` (f32);
- (d) the BPE ids from ``vocab.json``/``merges.txt`` and the SentencePiece
  ids from a ``spiece.model`` beside the checkpoint against the JAX
  tokenizers';
- (e) discovery (ROADMAP C8): with ``HOME`` and the working directory moved
  to ``tmp_path``, both engines agree on ``stats()["pretrained"]`` and on
  search rows with the checkpoint under ``$VQT_CLIP_CHECKPOINT`` (through
  each package's ``VQT_*`` overrides, the operator's route),
  ``./checkpoints/<short name>``, the hub cache's ``snapshots/``, and
  nowhere (the port's seeded draw replaced by the JAX engine's seeded tree,
  bridged, so that the rows can be compared);
- (f) the reference's edge cases: a configured directory without weights
  raises ``FileNotFoundError``; a SigLIP directory holding only
  ``pytorch_model.bin`` serves seeded; ``orbax_checkpoint``, a checkpoint
  of the port's trainer, is served by both embedders and the engine;
- (g) ViT-L/14 widths (vision 1,024 wide, 16 heads, patch 14 at 224 px, S =
  257; text 768 wide, 12 heads; rows 768 wide) at 2 layers a tower and a
  1,000-token vocab: the converter fills every parameter of the port's
  ``CLIP`` under ``load_state_dict(strict=True)``, and the port's vectors
  match JAX's and HF's on 2 images and 2 texts.
"""

import dataclasses
import json
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
import transformers
from safetensors.numpy import load_file, save_file

import jax.numpy as jnp

from tests.test_real_checkpoint import (
    TINY_HF,
    _hf_state_dict,
    _tiny_cfg,
    _write_tokenizer_files,
)
from tests.test_siglip_spm import BASE_PIECES, make_spiece
from tests.test_torch_siglip import tiny_configs
from tests.test_torch_train_checkpoint import (
    assert_serves_trainer,
    served_by,
    train_and_save,
)
from tests.torch_parity import (
    TINY_FULL_VOCAB,
    _as_torch_cfg,
    numpy_tree,
    row_cosine,
)
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.models.clip import config as jax_cfg
from video_quierer_tpu.models.clip import convert as jax_convert
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxCLIPEmbedder
from video_quierer_tpu.models.clip.model import CLIP as JaxCLIP
from video_quierer_tpu.models.clip.model import init_params as jax_init
from video_quierer_tpu.models.clip.tokenizer import \
    load_tokenizer as jax_load_tokenizer
from video_quierer_tpu.models.siglip import embedder as jax_semb
from video_quierer_tpu.models.siglip.convert import \
    convert_siglip_checkpoint as jax_convert_siglip
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.models.clip import config as torch_cfg
from video_quierer_tpu_torch.models.clip import convert
from video_quierer_tpu_torch.models.clip import embedder as emb_mod
from video_quierer_tpu_torch.models.clip.bridge import params_from_jax
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.models.clip.tokenizer import (
    CLIPBPETokenizer,
    HashTokenizer,
    load_tokenizer,
)
from video_quierer_tpu_torch.models.siglip import embedder as semb
from video_quierer_tpu_torch.models.siglip.convert import \
    convert_siglip_checkpoint
from video_quierer_tpu_torch.models.siglip.spm import SigLIPSPTokenizer
from video_quierer_tpu_torch.ops.preprocess import (
    SIGLIP_MEAN,
    SIGLIP_STD,
    normalize_images,
)

MIN_COS = {"float32": 1 - 1e-5, "bfloat16": 0.999}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SCORE_ATOL = 1e-5
TEXTS = ["dog", "a dog do", "god dog", "zebra"]
SIGLIP_TEXTS = ["hello the cat", "the cat sat on", "unk"]

torch_cfg.register_config(TINY_HF, _as_torch_cfg(_tiny_cfg))

# ViT-L/14's widths (models/clip/config.py:vit_l_14) at 2 layers a tower
# and a 1,000-token vocab
L14_2L = "torch-ckpt-vit-l-14-2-layers"


def _l14_2_layers():
    full = jax_cfg.vit_l_14()
    return dataclasses.replace(
        full, name=L14_2L,
        vision=dataclasses.replace(full.vision, num_layers=2),
        text=dataclasses.replace(full.text, num_layers=2, vocab_size=1000,
                                 eot_token_id=999))


jax_cfg.register_config(L14_2L, _l14_2_layers)
torch_cfg.register_config(L14_2L, _as_torch_cfg(_l14_2_layers))


# -- checkpoint writers ----------------------------------------------------

def with_position_ids(sd: dict, n_pos: int, ctx: int) -> dict:
    """The ``position_ids`` buffers older HF checkpoints carry (int64; no
    converter reads them)."""
    sd = dict(sd)
    sd["vision_model.embeddings.position_ids"] = \
        np.arange(n_pos, dtype=np.int64)[None]
    sd["text_model.embeddings.position_ids"] = \
        np.arange(ctx, dtype=np.int64)[None]
    return sd


def write_checkpoint(d, sd: dict, fmt: str = "safetensors"):
    """``sd`` (HF names, numpy) as ``model.safetensors`` or
    ``pytorch_model.bin`` in ``d``."""
    d.mkdir(parents=True, exist_ok=True)
    sd = {k: np.ascontiguousarray(v) for k, v in sd.items()}
    if fmt == "safetensors":
        save_file(sd, str(d / "model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   d / "pytorch_model.bin")
    return d


def tiny_clip_dir(d, fmt: str = "safetensors", seed: int = 0):
    """TINY_HF's checkpoint (the JAX tests' fixture state dict, with the
    position-id buffers) and its BPE vocab pair in ``d``."""
    sd = with_position_ids(_hf_state_dict(np.random.default_rng(seed)),
                           5, 77)
    write_checkpoint(d, sd, fmt)
    _write_tokenizer_files(d)
    return d


def hf_clip_config(cfg) -> "transformers.CLIPConfig":
    v, t = cfg.vision, cfg.text
    return transformers.CLIPConfig(
        projection_dim=cfg.projection_dim,
        vision_config=dict(
            image_size=v.image_size, patch_size=v.patch_size,
            hidden_size=v.hidden_size, num_hidden_layers=v.num_layers,
            num_attention_heads=v.num_heads,
            intermediate_size=v.hidden_size * v.mlp_ratio,
            hidden_act="quick_gelu", layer_norm_eps=v.layer_norm_eps),
        # eos_token_id 2: HF pools at the highest id, as both packages do
        text_config=dict(
            vocab_size=t.vocab_size, max_position_embeddings=t.context_length,
            hidden_size=t.hidden_size, num_hidden_layers=t.num_layers,
            num_attention_heads=t.num_heads,
            intermediate_size=t.hidden_size * t.mlp_ratio,
            hidden_act="quick_gelu", layer_norm_eps=t.layer_norm_eps,
            eos_token_id=2))


def hf_clip(cfg, sd=None):
    """``transformers.CLIPModel`` at ``cfg`` (seeded HF init, or ``sd``)."""
    torch.manual_seed(0)
    model = transformers.CLIPModel(hf_clip_config(cfg)).eval()
    if sd is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()
                               if not k.endswith("position_ids")})
    return model


def hf_state(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def siglip_configs():
    return tiny_configs()


def hf_siglip(tcfg) -> "transformers.SiglipModel":
    v, t = tcfg.vision, tcfg.text
    torch.manual_seed(0)
    return transformers.SiglipModel(transformers.SiglipConfig(
        vision_config=dict(
            image_size=v.image_size, patch_size=v.patch_size,
            hidden_size=v.hidden_size, num_hidden_layers=v.num_layers,
            num_attention_heads=v.num_heads,
            intermediate_size=v.hidden_size * v.mlp_ratio,
            hidden_act="gelu_pytorch_tanh", layer_norm_eps=v.layer_norm_eps),
        text_config=dict(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size,
            num_hidden_layers=t.num_layers, num_attention_heads=t.num_heads,
            intermediate_size=t.hidden_size * t.mlp_ratio,
            max_position_embeddings=t.context_length,
            hidden_act="gelu_pytorch_tanh",
            layer_norm_eps=t.layer_norm_eps))).eval()


def siglip_dir(d, fmt: str = "safetensors", spiece: bool = True):
    """A tiny HF SigLIP checkpoint (with position-id buffers) in ``d``, and
    a ``spiece.model`` beside it; returns (d, the HF model)."""
    _, tcfg = siglip_configs()
    model = hf_siglip(tcfg)
    n_pos = tcfg.vision.num_patches
    write_checkpoint(d, with_position_ids(hf_state(model), n_pos,
                                          tcfg.text.context_length), fmt)
    if spiece:
        (d / "spiece.model").write_bytes(make_spiece(BASE_PIECES))
    return d, model


@pytest.fixture(autouse=True)
def no_discovery(monkeypatch, tmp_path):
    """No checkpoint found by accident: no ``VQT_CLIP_CHECKPOINT`` or
    ``VQT_SIGLIP_SPIECE``, ``HOME`` and the working directory empty."""
    monkeypatch.delenv("VQT_CLIP_CHECKPOINT", raising=False)
    monkeypatch.delenv("VQT_SIGLIP_SPIECE", raising=False)
    for sub in ("home", "cwd"):
        (tmp_path / sub).mkdir()
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.chdir(tmp_path / "cwd")


@pytest.fixture
def jax_tiny_siglip(monkeypatch):
    """The JAX SigLIP embedder builds the tiny config (it always builds
    ``siglip_base_patch16()``)."""
    jcfg, tcfg = siglip_configs()
    monkeypatch.setattr(jax_semb, "siglip_base_patch16", lambda: jcfg)
    return jcfg, tcfg


def assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert np.array_equal(got, want), path


# -- (a) the safetensors reader ---------------------------------------------

def _arrays(case: str) -> dict:
    rng = np.random.default_rng(7)
    if case == "f32":
        return {"w": rng.standard_normal((3, 5)).astype(np.float32),
                "b": rng.standard_normal(5).astype(np.float32)}
    if case == "f16":
        return {"h": rng.standard_normal((4, 2)).astype(np.float16)}
    if case == "i64":
        return {"ids": np.arange(77, dtype=np.int64)[None]}
    if case == "scalar":
        return {"logit_scale": np.array(2.6592, np.float32),
                "empty": np.zeros((0, 3), np.float32)}
    return {f"t{i}": rng.integers(-100, 100, (2, 3)).astype(dt)
            for i, dt in enumerate((np.uint8, np.int8, np.int16, np.uint16,
                                    np.int32, np.uint32, np.uint64,
                                    np.float64, np.bool_, np.complex64))}


@pytest.mark.parametrize("case", ["f32", "f16", "i64", "scalar", "metadata",
                                  "every_dtype"])
def test_safetensors_reader_matches_load_file(tmp_path, case):
    arrays = _arrays("f32" if case == "metadata" else case)
    path = tmp_path / "x.safetensors"
    save_file(arrays, str(path),
              metadata={"format": "pt"} if case == "metadata" else None)
    got, want = convert.load_safetensors(path), load_file(str(path))
    assert set(got) == set(want) == set(arrays)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
        assert got[k].flags.writeable


def _raw_file(path, header: dict, data: bytes):
    h = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(h)) + h + data)


def test_safetensors_reader_raises_where_load_file_raises(tmp_path):
    bf16 = tmp_path / "bf16.safetensors"
    _raw_file(bf16, {"x": {"dtype": "BF16", "shape": [2],
                           "data_offsets": [0, 4]}}, bytes(4))
    with pytest.raises(TypeError):
        convert.load_safetensors(bf16)
    # load_file raises where numpy has no bfloat16: in a fresh interpreter
    # (jax, imported here, registers one through ml_dtypes)
    out = subprocess.run(
        [sys.executable, "-c", "import sys\n"
         "from safetensors.numpy import load_file\n"
         "try:\n    load_file(sys.argv[1])\n"
         "except TypeError:\n    print('TypeError')\n", str(bf16)],
        capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "TypeError"
    # a trailing byte no tensor covers, and a gap before the first tensor
    for name, header, data in (
            ("tail", {"x": {"dtype": "F32", "shape": [1],
                            "data_offsets": [0, 4]}}, bytes(5)),
            ("gap", {"x": {"dtype": "F32", "shape": [1],
                           "data_offsets": [4, 8]}}, bytes(8))):
        path = tmp_path / f"{name}.safetensors"
        _raw_file(path, header, data)
        for read in (convert.load_safetensors, lambda p: load_file(str(p))):
            with pytest.raises(Exception):
                read(path)


# -- (b) the converters -----------------------------------------------------

@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_clip_converter_tree_matches_jax(tmp_path, fmt):
    d = tiny_clip_dir(tmp_path / "ckpt", fmt)
    assert "text_model.embeddings.position_ids" in \
        convert._load_state_dict(d)
    assert_same_tree(convert.convert_hf_checkpoint(d, torch_cfg.get_config(
        TINY_HF)), jax_convert.convert_hf_checkpoint(d, _tiny_cfg()))


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_clip_converter_tree_matches_jax_on_hf_weights(tmp_path, fmt):
    """The same on ``transformers.CLIPModel``'s own state dict."""
    sd = with_position_ids(hf_state(hf_clip(_tiny_cfg())), 5, 77)
    d = write_checkpoint(tmp_path / "ckpt", sd, fmt)
    assert_same_tree(convert.convert_hf_checkpoint(d, torch_cfg.get_config(
        TINY_HF)), jax_convert.convert_hf_checkpoint(d, _tiny_cfg()))


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_siglip_converter_tree_matches_jax(tmp_path, fmt):
    jcfg, tcfg = siglip_configs()
    d, _ = siglip_dir(tmp_path / "ckpt", fmt, spiece=False)
    assert_same_tree(convert_siglip_checkpoint(d, tcfg),
                     jax_convert_siglip(d, jcfg))


# -- (c) the embedders from a directory -------------------------------------

FRAMES = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3), np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_embedder_from_dir_matches_jax(tmp_path, dtype):
    d = tiny_clip_dir(tmp_path / "ckpt")
    tdt, jdt = DTYPES[dtype]
    port = emb_mod.CLIPEmbedder(TINY_HF, checkpoint_dir=d, dtype=tdt,
                                device="cpu")
    ref = JaxCLIPEmbedder(TINY_HF, checkpoint_dir=d, dtype=jdt)
    assert port.pretrained is True and ref.pretrained is True
    assert isinstance(port.tokenizer, CLIPBPETokenizer)
    assert set(port.load_seconds) == {"read_convert", "bridge", "load",
                                      "device"}
    for got, want in ((port.embed_frames(FRAMES), ref.embed_frames(FRAMES)),
                      (port.embed_texts(TEXTS), ref.embed_texts(TEXTS))):
        assert got.shape == want.shape
        assert row_cosine(got, want).min() >= MIN_COS[dtype]


def test_clip_embedder_from_dir_matches_hf(tmp_path):
    """The checkpoint's own model: HF's features of the same pixels and of
    the checkpoint tokenizer's ids."""
    d = tiny_clip_dir(tmp_path / "ckpt")
    hf = hf_clip(_tiny_cfg(), load_file(str(d / "model.safetensors")))
    port = emb_mod.CLIPEmbedder(TINY_HF, checkpoint_dir=d,
                                dtype=torch.float32, device="cpu")
    pixels = normalize_images(torch.from_numpy(FRAMES), dtype=torch.float32)
    ids = torch.from_numpy(np.asarray(port.tokenizer(TEXTS), np.int64))
    with torch.no_grad():
        img = hf.get_image_features(pixel_values=pixels.permute(0, 3, 1, 2))
        txt = hf.get_text_features(input_ids=ids)
    assert row_cosine(port.embed_frames(FRAMES), img.numpy()).min() >= \
        MIN_COS["float32"]
    assert row_cosine(port.embed_texts(TEXTS), txt.numpy()).min() >= \
        MIN_COS["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_siglip_embedder_from_dir_matches_jax_and_hf(tmp_path,
                                                     jax_tiny_siglip, dtype):
    _, tcfg = jax_tiny_siglip
    d, hf = siglip_dir(tmp_path / "ckpt")
    tdt, jdt = DTYPES[dtype]
    port = semb.SigLIPEmbedder(tcfg, checkpoint_dir=d, dtype=tdt,
                               device="cpu")
    ref = jax_semb.SigLIPEmbedder(checkpoint_dir=d, dtype=jdt)
    assert port.pretrained is True and ref.pretrained is True
    assert isinstance(port.tokenizer, SigLIPSPTokenizer)
    got_img, got_txt = (port.embed_frames(FRAMES),
                        port.embed_texts(SIGLIP_TEXTS))
    assert row_cosine(got_img, ref.embed_frames(FRAMES)).min() >= \
        MIN_COS[dtype]
    assert row_cosine(got_txt, ref.embed_texts(SIGLIP_TEXTS)).min() >= \
        MIN_COS[dtype]
    if dtype == "float32":
        pixels = normalize_images(torch.from_numpy(FRAMES),
                                  dtype=torch.float32, mean=SIGLIP_MEAN,
                                  std=SIGLIP_STD)
        ids = torch.from_numpy(np.asarray(port.tokenizer(SIGLIP_TEXTS),
                                          np.int64))
        with torch.no_grad():
            img = hf.get_image_features(
                pixel_values=pixels.permute(0, 3, 1, 2))
            txt = hf.get_text_features(input_ids=ids)
        assert row_cosine(got_img, img.numpy()).min() >= MIN_COS[dtype]
        assert row_cosine(got_txt, txt.numpy()).min() >= MIN_COS[dtype]


# -- (d) the tokenizers from the directory ----------------------------------

def test_bpe_ids_from_dir_match_jax(tmp_path):
    _write_tokenizer_files(tmp_path)
    got, want = load_tokenizer(tmp_path), jax_load_tokenizer(tmp_path)
    assert isinstance(got, CLIPBPETokenizer)
    assert np.array_equal(got(TEXTS), want(TEXTS))
    assert got.encoder["dog</w>"] in got(["dog"])[0].tolist()


def test_spiece_ids_beside_checkpoint_match_jax(tmp_path, jax_tiny_siglip):
    jcfg, tcfg = jax_tiny_siglip
    (tmp_path / "spiece.model").write_bytes(make_spiece(BASE_PIECES))
    got = semb.siglip_tokenizer(tcfg, tmp_path)
    want = jax_semb.siglip_tokenizer(jcfg, tmp_path)
    assert isinstance(got, SigLIPSPTokenizer)
    assert np.array_equal(got(SIGLIP_TEXTS), want(SIGLIP_TEXTS))


# -- (e) discovery: the two engines agree (C8) ------------------------------

CORPUS_ROWS = 64


def write_cache(path, dim: int):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((CORPUS_ROWS, dim)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=-1, keepdims=True)
    idx = DeviceVideoIndex(dim=dim, device="cpu")
    idx.add_batch(rows, "v.mp4", [0.5 * t for t in range(CORPUS_ROWS)])
    assert idx.save_to_disk(path)


def discovery_engines(root, overrides: bool, model: str):
    """The JAX and the port engine on ``model`` (f32), each over its own dir
    with the same seeded cache, started; ``overrides``: each config through
    its package's ``VQT_*`` overrides."""
    dim = torch_cfg.get_config(model).projection_dim
    out = []
    for name, mod, cls in (("jax", jax_config, JaxEngine),
                           ("port", torch_config, VideoSearchEngine)):
        d = root / name
        d.mkdir()
        write_cache(d / "video_search_cache.pkl", dim)
        cfg = mod.EngineConfig(videos_dir=str(d))
        if overrides:
            cfg = mod.apply_env_overrides(cfg)
        cfg.index.embed_dim = dim
        cfg.model.name = model
        cfg.model.dtype = "float32"
        kw = {"device": "cpu"} if cls is VideoSearchEngine else {}
        engine = cls(d, config=cfg, **kw)
        engine.startup()
        out.append(engine)
    return out


@pytest.mark.parametrize("where", ["env", "checkpoints", "hub", "none"])
def test_discovery_engines_agree(tmp_path, monkeypatch, where):
    home, cwd = tmp_path / "home", tmp_path / "cwd"
    model = TINY_HF
    if where == "env":
        d = tiny_clip_dir(tmp_path / "operator" / "clip")
        monkeypatch.setenv("VQT_CLIP_CHECKPOINT", str(d))
    elif where == "checkpoints":
        tiny_clip_dir(cwd / "checkpoints" / TINY_HF)
    elif where == "hub":
        snaps = (home / ".cache" / "huggingface" / "hub"
                 / f"models--{TINY_HF}" / "snapshots")
        tiny_clip_dir(snaps / "0123abcd")
    else:
        # no checkpoint: both serve seeded weights, the JAX engine's draw
        # on both sides so the rows compare; the hash tokenizer's ids need
        # the full CLIP vocab
        model = TINY_FULL_VOCAB
        sd = params_from_jax(numpy_tree(jax_init(
            JaxCLIP(jax_cfg.get_config(model)), seed=0)),
            torch_cfg.get_config(model))
        monkeypatch.setattr(emb_mod, "init_params", lambda cfg, gen: sd)
    ref, port = discovery_engines(tmp_path, where == "env", model)
    try:
        for q in TEXTS:
            got = port.search(q, k=5, use_cache=False)
            exp = ref.search(q, k=5, use_cache=False)
            assert [r["frame_id"] for r in got] == \
                [r["frame_id"] for r in exp]
            np.testing.assert_allclose([r["score"] for r in got],
                                       [r["score"] for r in exp], rtol=0,
                                       atol=SCORE_ATOL)
        # the towers are built by the first search
        want = where != "none"
        assert ref.stats()["pretrained"] is want
        assert port.stats()["pretrained"] is want
        tok = CLIPBPETokenizer if want else HashTokenizer
        assert isinstance(port._tower().tokenizer, tok)
    finally:
        port.close()


# -- (f) the reference's edge cases -----------------------------------------

def test_configured_dir_without_weights_raises(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        JaxCLIPEmbedder(TINY_HF, checkpoint_dir=empty)
    with pytest.raises(FileNotFoundError):
        emb_mod.CLIPEmbedder(TINY_HF, checkpoint_dir=empty, device="cpu")
    cfg = torch_config.EngineConfig(videos_dir=str(tmp_path / "v"))
    cfg.model.name, cfg.model.checkpoint_dir = TINY_HF, str(empty)
    engine = VideoSearchEngine(tmp_path / "v", config=cfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        engine._get_embedder()


def test_siglip_bin_only_serves_seeded(tmp_path, jax_tiny_siglip):
    _, tcfg = jax_tiny_siglip
    d, _ = siglip_dir(tmp_path / "ckpt", "bin")
    port = semb.SigLIPEmbedder(tcfg, checkpoint_dir=d, dtype=torch.float32,
                               device="cpu")
    ref = jax_semb.SigLIPEmbedder(checkpoint_dir=d, dtype=jnp.float32)
    assert port.pretrained is False and ref.pretrained is False
    assert port.load_seconds.keys() == {"load", "device"}
    # the tokenizer beside it is still read, as the reference reads it
    assert isinstance(port.tokenizer, SigLIPSPTokenizer)


@pytest.mark.parametrize("family", ["clip", "siglip"])
def test_orbax_checkpoint_not_ported(tmp_path, family, monkeypatch):
    """``orbax_checkpoint`` names a checkpoint of the port's trainer
    (``train/checkpoint.py``): each family's embedder and the engine serve
    it, ``pretrained`` true, the saved ``params`` bit for bit and the
    trainer's vectors (the name is kept from when the field was refused;
    an orbax directory of the JAX package is still not read:
    ``tests/test_torch_train_checkpoint.py``)."""
    trainer, path = train_and_save(tmp_path / "ck", family)
    assert_serves_trainer(served_by(family, path), trainer, family)
    cfg = torch_config.EngineConfig(videos_dir=str(tmp_path / "v"))
    cfg.model.family, cfg.model.orbax_checkpoint = family, str(path)
    cfg.model.dtype = "float32"
    if family == "clip":
        cfg.model.name = TINY_FULL_VOCAB
    else:
        # the engine builds siglip_base_patch16(): the tiny config instead
        monkeypatch.setattr(semb, "siglip_base_patch16",
                            lambda: siglip_configs()[1])
    engine = VideoSearchEngine(tmp_path / "v", config=cfg, device="cpu")
    tower = engine._get_embedder()
    assert engine.stats()["pretrained"] is True
    assert_serves_trainer(tower, trainer, family)


# -- (g) ViT-L/14 widths ----------------------------------------------------

@pytest.fixture(scope="module")
def l14_dir(tmp_path_factory):
    """A 2-layer ViT-L/14-wide checkpoint from ``transformers.CLIPModel``
    (with position-id buffers), and the HF model."""
    hf = hf_clip(_l14_2_layers())
    d = write_checkpoint(tmp_path_factory.mktemp("l14"), with_position_ids(
        hf_state(hf), 257, 77))
    return d, hf


def test_l14_converter_fills_every_parameter(l14_dir):
    d, _ = l14_dir
    cfg = torch_cfg.get_config(L14_2L)
    sd = params_from_jax(convert.convert_hf_checkpoint(d, cfg), cfg)
    model = CLIP(cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    assert model.vision.patch_embedding.weight.shape == (1024, 14 * 14 * 3)
    assert model.cfg.vision.seq_len == 257


def test_l14_vectors_match_jax_and_hf(l14_dir):
    d, hf = l14_dir
    cfg = torch_cfg.get_config(L14_2L)
    model = CLIP(cfg).eval()
    model.load_state_dict(params_from_jax(
        convert.convert_hf_checkpoint(d, cfg), cfg), strict=True)
    jparams = jax_convert.convert_hf_checkpoint(d, _l14_2_layers())
    jmodel = JaxCLIP(_l14_2_layers())
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (2, 224, 224, 3), np.uint8)
    pixels = normalize_images(torch.from_numpy(frames), dtype=torch.float32)
    ids = np.zeros((2, 77), np.int64)
    ids[0, :6] = [998, 5, 17, 301, 42, 999]
    ids[1, :3] = [998, 777, 999]
    with torch.no_grad():
        got_img = model.encode_image(pixels).numpy()
        got_txt = model.encode_text(torch.from_numpy(ids)).numpy()
        hf_img = hf.get_image_features(
            pixel_values=pixels.permute(0, 3, 1, 2)).numpy()
        hf_txt = hf.get_text_features(input_ids=torch.from_numpy(ids)).numpy()
    want_img = np.asarray(jmodel.apply({"params": jparams},
                                       jnp.asarray(pixels.numpy()),
                                       method=JaxCLIP.encode_image))
    want_txt = np.asarray(jmodel.apply({"params": jparams},
                                       jnp.asarray(ids.astype(np.int32)),
                                       method=JaxCLIP.encode_text))
    assert got_img.shape == (2, 768) and got_txt.shape == (2, 768)
    for got, want in ((got_img, want_img), (got_txt, want_txt),
                      (got_img, hf_img), (got_txt, hf_txt)):
        assert row_cosine(got, want).min() >= MIN_COS["float32"]
