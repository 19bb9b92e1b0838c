"""AIMv2 (``models/aimv2``, ``model.family = "aimv2"``) on the CPU at a
tiny size: 2 layers, width 256, 2 heads of width 128, 224 px frames in
56 px patches (S = 16), a 16-token context, projection 64.

- ``models/aimv2/reference.py`` against ``transformers.Aimv2Model`` in
  f32 on seeded random weights (every RMSNorm scale and bias drawn, not
  left at its init): vision and text features, the projections, and the
  unit rows (the text tower given an all-ones attention mask, under which
  ``transformers`` makes it causal);
- the port's module towers, and its fused encodes through the gated
  halves' plain versions (``rms_attn_half_ref``, ``gated_mlp_half_ref``,
  which the halves take on a CPU tensor), against the reference;
- ``convert.py`` from ``Aimv2Model``'s names: the patch kernel's layout,
  the dropped buffers, refusals;
- the AIMv2 embedder holds every attribute of a CLIP embedder's state;
- the engine with ``model.family = "aimv2"``: ingest through
  ``_ingest_batches`` and ``batched_frames``, then searches whose top 10
  are the reference's exact top 10, and batched and coalesced searches
  (the fused text encode) that return what single searches return.

Tolerances, each against f32 sums of at most 512 products taken in
another order: unit rows and features atol 2e-5 (a tenth of what one
bf16 rounding of the weights alone moves them, which
``test_tolerance_fails_in_bf16`` shows: the bf16 tower misses it by more
than a factor of 10); search scores atol 1e-5 (dot products of those
rows).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from transformers import Aimv2Config, Aimv2Model

from video_quierer_tpu_torch.engine.config import EngineConfig
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.ingest.pipeline import batched_frames
from video_quierer_tpu_torch.models.aimv2 import config as ac
from video_quierer_tpu_torch.models.aimv2 import reference as ref
from video_quierer_tpu_torch.models.aimv2.convert import (
    PATCH,
    convert_hf_state_dict,
    init_hf_state_dict,
)
from video_quierer_tpu_torch.models.aimv2.embedder import AIMv2Embedder
from video_quierer_tpu_torch.models.aimv2.fused import (
    fused_aimv2_text_encode,
    fused_aimv2_vision_encode,
    gated_operands,
)
from video_quierer_tpu_torch.models.aimv2.model import AIMv2
from video_quierer_tpu_torch.models.clip import config as clip_config
from video_quierer_tpu_torch.models.clip.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
from video_quierer_tpu_torch.ops import fused_layer as fl
from video_quierer_tpu_torch.ops.attention import kernel_takes
from video_quierer_tpu_torch.ops.preprocess import normalize_images

TINY = "aimv2-tiny"
ATOL = 2e-5
EOS = 49407
HF = dict(
    projection_dim=64,
    text_config=dict(hidden_size=256, intermediate_size=512,
                     num_hidden_layers=2, num_attention_heads=2,
                     max_position_embeddings=16),
    vision_config=dict(hidden_size=256, intermediate_size=512,
                       num_hidden_layers=2, num_attention_heads=2,
                       image_size=224, patch_size=56))


def tiny_config() -> ac.AIMv2Config:
    return ac.from_hf(dict(HF, name=TINY))


@pytest.fixture(scope="module", autouse=True)
def registered():
    ac.register_config(TINY, tiny_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def weights():
    """``Aimv2Model``'s state dict, seeded, and the model holding it."""
    sd = init_hf_state_dict(tiny_config(), torch.Generator().manual_seed(3))
    model = Aimv2Model(Aimv2Config(**HF)).eval()
    model.config._attn_implementation = "eager"
    model.load_state_dict(sd)
    return sd, model


def _pixels(n, seed=0):
    return torch.randn(n, 224, 224, 3, generator=torch.Generator()
                       .manual_seed(seed))


def _ids(n, s=16, seed=1):
    """Token ids below SOT, an EOS at a varying position, EOS padding."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, 49406, (n, s), generator=g)
    eos = torch.randint(2, s, (n,), generator=g)
    pos = torch.arange(s)[None]
    return torch.where(pos >= eos[:, None], EOS, ids)


def _port(weights, dtype=torch.float32):
    sd, _ = weights
    model = AIMv2(tiny_config())
    model.load_state_dict(convert_hf_state_dict(sd, tiny_config()))
    return model.to(dtype).eval()


def test_reference_matches_transformers(weights):
    sd, hf = weights
    cfg = tiny_config()
    px, ids = _pixels(4), _ids(5)
    with torch.no_grad():
        img = hf.get_image_features(pixel_values=px.permute(0, 3, 1, 2))
        txt = hf.get_text_features(input_ids=ids,
                                   attention_mask=torch.ones_like(ids))
        out = hf(input_ids=ids, pixel_values=px.permute(0, 3, 1, 2),
                 attention_mask=torch.ones_like(ids))
        r_img = ref.linear(ref.vision_features(sd, cfg, px),
                           sd["visual_projection.weight"])
        r_txt = ref.linear(ref.text_features(sd, cfg, ids),
                           sd["text_projection.weight"])
        vis = hf.vision_model(pixel_values=px.permute(0, 3, 1, 2))
    torch.testing.assert_close(ref.vision_features(sd, cfg, px),
                               vis.pooler_output, atol=ATOL, rtol=0)
    torch.testing.assert_close(r_img, img, atol=ATOL, rtol=0)
    torch.testing.assert_close(r_txt, txt, atol=ATOL, rtol=0)
    torch.testing.assert_close(ref.encode_image(sd, cfg, px),
                               out.image_embeds, atol=ATOL, rtol=0)
    torch.testing.assert_close(ref.encode_text(sd, cfg, ids),
                               out.text_embeds, atol=ATOL, rtol=0)


def test_text_tower_is_causal_and_pools_the_first_eos(weights):
    """A token after the first EOS moves no row, in the reference as in
    ``transformers`` under the processor's mask."""
    sd, hf = weights
    ids = _ids(3)
    late = ids.clone()
    late[:, -1] = 5
    late[:, 2] = EOS
    late[:, 3:] = ids[:, 3:]
    ids[:, 2] = EOS
    with torch.no_grad():
        a = ref.encode_text(sd, tiny_config(), ids)
        b = ref.encode_text(sd, tiny_config(), late)
        c = hf.get_text_features(input_ids=late,
                                 attention_mask=torch.ones_like(late))
    assert torch.equal(a, b)
    torch.testing.assert_close(ref.linear(ref.text_features(
        sd, tiny_config(), late), sd["text_projection.weight"]), c,
        atol=ATOL, rtol=0)


def test_module_towers_match_the_reference(weights):
    sd, _ = weights
    model = _port(weights)
    px, ids = _pixels(3, 4), _ids(4, seed=5)
    with torch.no_grad():
        torch.testing.assert_close(model.encode_image(px),
                                   ref.encode_image(sd, tiny_config(), px),
                                   atol=ATOL, rtol=0)
        torch.testing.assert_close(model.encode_text(ids),
                                   ref.encode_text(sd, tiny_config(), ids),
                                   atol=ATOL, rtol=0)


def test_fused_encodes_match_the_reference(weights, monkeypatch):
    """The gated halves on CPU tensors take their plain versions (spied:
    one call of each a block)."""
    sd, _ = weights
    model = _port(weights)
    calls = []
    for name in ("rms_attn_half_ref", "gated_mlp_half_ref"):
        real = getattr(fl, name)
        monkeypatch.setattr(fl, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    px, ids = _pixels(3, 6), _ids(4, seed=7)
    with torch.no_grad():
        vis = fused_aimv2_vision_encode(model, px, [
            gated_operands(b, torch.float32)
            for b in model.vision_model.encoder.layers])
        txt = fused_aimv2_text_encode(model, ids, [
            gated_operands(b, torch.float32)
            for b in model.text_model.encoder.layers])
    assert calls.count("rms_attn_half_ref") == 4
    assert calls.count("gated_mlp_half_ref") == 4
    torch.testing.assert_close(vis, ref.encode_image(sd, tiny_config(), px),
                               atol=ATOL, rtol=0)
    torch.testing.assert_close(txt, ref.encode_text(sd, tiny_config(), ids),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("tower", ["vision", "text"])
def test_tolerance_fails_in_bf16(weights, tower):
    """The bf16 module tower misses the f32 reference by more than ten
    times ``ATOL``: the tolerance tells the two precisions apart."""
    sd, _ = weights
    model = _port(weights, torch.bfloat16)
    with torch.no_grad():
        if tower == "vision":
            px = _pixels(3, 8)
            got = model.encode_image(px.bfloat16())
            want = ref.encode_image(sd, tiny_config(), px)
        else:
            ids = _ids(4, seed=9)
            got = model.encode_text(ids)
            want = ref.encode_text(sd, tiny_config(), ids)
    assert (got - want).abs().max().item() > 10 * ATOL


def test_convert_from_hf_names(weights):
    sd, hf = weights
    cfg = tiny_config()
    hf_sd = dict(hf.state_dict())
    hf_sd["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    port = convert_hf_state_dict(hf_sd, cfg)
    assert "text_model.embeddings.position_ids" not in port
    conv = hf_sd[PATCH]                                  # [D, 3, p, p]
    assert port[PATCH].shape == (256, 56 * 56 * 3)
    # row r, column c, channel k of a patch: column (r * p + c) * 3 + k
    assert torch.equal(port[PATCH][:, (5 * 56 + 7) * 3 + 2],
                       conv[:, 2, 5, 7])
    for name, t in port.items():
        if name != PATCH:
            assert torch.equal(t, hf_sd[name]), name
    with pytest.raises(ValueError, match="unknown"):
        convert_hf_state_dict(dict(hf_sd, extra=torch.zeros(1)), cfg)
    with pytest.raises(ValueError, match="missing"):
        convert_hf_state_dict({k: v for k, v in hf_sd.items()
                               if "head.cls_token" not in k}, cfg)
    with pytest.raises(ValueError, match="shapes"):
        convert_hf_state_dict(dict(hf_sd, logit_scale=torch.zeros(2)), cfg)


def test_config_reads_hf_keys_and_refuses_what_is_not_ported():
    c = ac.get_config("aimv2-l14-lit")
    assert c == ac.get_config("apple/aimv2-large-patch14-224-lit")
    assert (c.vision.seq_len, c.vision.hidden_size // c.vision.num_heads,
            c.text.hidden_size // c.text.num_heads, c.projection_dim) == \
        (256, 128, 128, 512)
    assert ac.from_hf(Aimv2Config().to_dict()) == ac.AIMv2Config(
        name=Aimv2Config().to_dict().get("name", ac.AIMv2Config.name))
    for key, value in (("qkv_bias", True), ("mlp_bias", True),
                       ("hidden_act", "gelu"), ("is_native", True)):
        with pytest.raises(ValueError, match=key):
            ac.from_hf({"vision_config": {key: value}})


def test_kernel_widths():
    """B3's instances: head widths 64 and 128 only, each up to its
    longest S (the wrappers send every other shape elsewhere or
    refuse it)."""
    assert kernel_takes(256, 128) and kernel_takes(77, 128)
    assert kernel_takes(257, 64) and kernel_takes(400, 64)
    assert not kernel_takes(273, 128) and not kernel_takes(401, 64)
    assert not any(kernel_takes(16, hd) for hd in (32, 96, 256))
    assert fl.gated_tower_eligible(1024, 2816, 8)
    assert fl.gated_tower_eligible(768, 2048, 6)
    assert not fl.gated_tower_eligible(768, 2048, 8)        # 96-wide heads
    assert not fl.gated_tower_eligible(1024, 2800, 8)       # F % 32


# -- the engine ---------------------------------------------------------------

FPV = 12


def _extract(path):
    v = int(str(path).rsplit("_", 1)[1].split(".")[0])
    frames = np.random.default_rng(v).integers(0, 256, (FPV, 224, 224, 3),
                                               dtype=np.uint8)
    return frames, [0.5 * i for i in range(FPV)]


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    videos = tmp_path_factory.mktemp("aimv2_videos")
    cfg = EngineConfig(videos_dir=str(videos))
    cfg.model.family = "aimv2"
    cfg.model.name = TINY
    cfg.model.dtype = "float32"
    cfg.index.device_dtype = "float32"
    eng = VideoSearchEngine(videos, config=cfg, device="cpu")
    names = [f"v_{i}.mp4" for i in range(5)]
    with eng.lock:
        added = eng._ingest_batches(names, batched_frames(
            names, batch_size=32, num_workers=2, extract_fn=_extract))
    assert added == 5 * FPV
    yield eng
    eng.close()


def test_engine_builds_the_aimv2_embedder(engine):
    emb = engine._tower()
    assert isinstance(emb, AIMv2Embedder)
    assert engine.config.index.embed_dim == 64 and engine.index.dim == 64


def test_embedder_holds_the_clip_embedders_serving_state(engine):
    """Every attribute a CLIP embedder's ``__init__`` sets, which the
    inherited methods read, is set on the AIMv2 embedder too (both take
    the family-independent state from ``CLIPEmbedder._begin`` and
    ``_serve``)."""
    clip_config.register_config("clip-state-tiny", lambda: CLIPConfig(
        vision=CLIPVisionConfig(image_size=64, patch_size=32, hidden_size=64,
                                num_layers=1, num_heads=1),
        text=CLIPTextConfig(context_length=16, hidden_size=64, num_layers=1,
                            num_heads=1),
        projection_dim=32))
    clip = CLIPEmbedder(model_name="clip-state-tiny", dtype=torch.float32,
                        device="cpu", seed=0)
    emb = engine._tower()
    assert set(vars(clip)) <= set(vars(emb))
    assert emb._replicas == [emb.params] and emb.mesh is None
    assert emb._pipe_stages is None
    assert emb.text_encode_fn == emb._encode_text_fn


def test_engine_searches_the_references_top_k(engine):
    emb = engine._tower()
    sd = init_hf_state_dict(tiny_config(), torch.Generator().manual_seed(0))
    frames = np.concatenate([_extract(f"v_{i}.mp4")[0] for i in range(5)])
    with torch.no_grad():
        rows = ref.encode_image(sd, tiny_config(), normalize_images(
            torch.from_numpy(frames), dtype=torch.float32))
    for q in ("a dog on a beach", "city at night", "x"):
        ids = torch.from_numpy(emb.prepare_text_ids(emb.tokenizer([q])))
        with torch.no_grad():
            qv = ref.encode_text(sd, tiny_config(), ids)[0]
        scores = rows @ qv
        top = torch.argsort(-scores, stable=True)[:10]
        got, _ = engine.search_ex(q, k=10, use_cache=False)
        assert [(r["video_name"], r["frame_id"]) for r in got] == \
            [(f"v_{int(i) // FPV}.mp4", int(i)) for i in top]
        np.testing.assert_allclose([r["score"] for r in got],
                                   scores[top].numpy(), atol=1e-5)


def test_engine_batch_and_coalesced_searches_take_the_fused_text_encode(
        engine, monkeypatch):
    from video_quierer_tpu_torch.models.aimv2 import embedder as emb_mod
    calls = []
    real = emb_mod.fused_aimv2_text_encode
    monkeypatch.setattr(emb_mod, "fused_aimv2_text_encode",
                        lambda *a, **kw: calls.append(a[1].shape)
                        or real(*a, **kw))
    queries = [f"query number {i}" for i in range(32)]
    batch = engine.search_batch(queries, k=5)
    assert calls and calls[0][0] == 32
    with ThreadPoolExecutor(32) as pool:
        coalesced = list(pool.map(
            lambda q: engine.search_coalesced_ex(q, 5, False)[0], queries))
    for q, rows, co in zip(queries, batch, coalesced):
        single, _ = engine.search_ex(q, k=5, use_cache=False)
        for got in (rows, co):
            assert [r["frame_id"] for r in got] == \
                [r["frame_id"] for r in single]
            np.testing.assert_allclose([r["score"] for r in got],
                                       [r["score"] for r in single],
                                       atol=1e-5)
