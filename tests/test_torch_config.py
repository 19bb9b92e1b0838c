"""The port's ``config.json`` tier vs the JAX package's pydantic model.

``ApiConfig`` takes pydantic v2's lax coercion, written by hand in the
port (``engine/config.py:lax_int``/``lax_bool``/``lax_str``): each value
of the table goes through the JAX ``ApiConfig`` and the port's, which
must accept it as the same value of the same type, or both refuse it
with the same pydantic error type. The same holds for a whole
``config.json`` (``load_api_config``: a coercible file is read, not
dropped to the defaults) and for the ``api`` section of the nested
engine config (``_apply_nested``). ``cache.frame_memo_size > 0``
validates in both packages, and the engine wraps the tower it builds in
the frame memo (``MemoizedEmbedder``), as the JAX engine does.
"""

import json

import pytest
from pydantic import ValidationError

from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu_torch.engine import config as torch_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine

VALUES = [
    5, -3, 0, 1, 2, 10 ** 20, 5.0, -0.0, 5.5, 1e20, 9.2e18, float("inf"),
    float("nan"), True, False, None, [5], {"a": 1}, "5", " 7 ", "+5", "-5",
    "05", "5_000", "5__0", "_5", "5.0", "1.000", "1_0.0", "5.", ".5", "5.5",
    "1e3", "0x5", "", "abc", "٥", "true", "True", "TRUE", "false",
    "1", "0", "yes", "No", "on", "OFF", "t", "F", "y", "n", " true", "tru",
    "1.0", 0.5, 1.0, 0.0, 2.0,
]
FIELDS = {"int": "max_frames", "bool": "use_clip", "str": "log_level"}


def _jax(field, value):
    try:
        return "ok", getattr(jax_config.ApiConfig(**{field: value}), field)
    except ValidationError as e:
        return "refused", e.errors()[0]["type"]


def _port(field, value):
    try:
        return "ok", getattr(torch_config.ApiConfig(**{field: value}), field)
    except torch_config.FieldError as e:
        return "refused", e.type


@pytest.mark.parametrize("kind", sorted(FIELDS))
@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_api_config_coerces_as_pydantic(kind, value):
    field = FIELDS[kind]
    want, got = _jax(field, value), _port(field, value)
    assert got == want
    assert type(got[1]) is type(want[1])


def test_load_api_config_coerces_instead_of_dropping_the_file(tmp_path):
    path = tmp_path / "config.json"
    data = {"sampling_mode": "low", "max_frames": "500", "use_clip": "true",
            "enhanced_mode": 0, "default_results": 20.0,
            "cache_search": "off", "search_timeout": " 45 "}
    path.write_text(json.dumps(data))
    want = jax_config.load_api_config(path).model_dump()
    got = torch_config.load_api_config(path).to_dict()
    assert got == want
    assert (got["sampling_mode"], got["max_frames"], got["use_clip"]) == \
        ("low", 500, True)
    # a refused value still drops the whole file to the defaults in both
    path.write_text(json.dumps({**data, "max_frames": "5.5"}))
    assert torch_config.load_api_config(path).to_dict() == \
        jax_config.load_api_config(path).model_dump() == \
        torch_config.ApiConfig().to_dict()


@pytest.mark.parametrize("section,ok", [
    ({"max_frames": "120", "auto_save": "no", "log_level": "DEBUG"}, True),
    ({"default_results": 7.0, "use_clip": 1}, True),
    ({"max_frames": 1.5}, False),
    ({"log_level": 10}, False),
])
def test_api_override_path_matches(section, ok):
    jcfg, pcfg = jax_config.EngineConfig(), torch_config.EngineConfig()
    if not ok:
        with pytest.raises(ValidationError):
            jax_config._apply_nested(jcfg, {"api": section})
        with pytest.raises(ValueError):
            torch_config._apply_nested(pcfg, {"api": section})
        return
    jax_config._apply_nested(jcfg, {"api": section})
    torch_config._apply_nested(pcfg, {"api": section})
    assert pcfg.api.to_dict() == jcfg.api.model_dump()


def test_frame_memo_validates_and_builds_the_wrapper(tmp_path):
    from video_quierer_tpu_torch.models.clip.embedder import (
        CLIPEmbedder,
        MemoizedEmbedder,
    )
    from tests.torch_parity import TINY
    cfg = torch_config.EngineConfig(videos_dir=str(tmp_path))
    cfg.cache.frame_memo_size = 64
    cfg.model.name = TINY
    cfg.model.dtype = "float32"
    cfg.validate()
    jcfg = jax_config.EngineConfig()
    jcfg.cache.frame_memo_size = 64
    jcfg.validate()
    engine = VideoSearchEngine(tmp_path, config=cfg, device="cpu")
    emb = engine._get_embedder()
    assert isinstance(emb, MemoizedEmbedder) and emb.max_size == 64
    assert isinstance(emb.inner, CLIPEmbedder) and engine._tower() is emb.inner
    assert engine._get_embedder() is emb
    # an injected tower is served as given (the JAX engine wraps only the
    # tower it builds)
    injected = VideoSearchEngine(tmp_path, config=cfg, embedder=emb.inner,
                                 device="cpu")
    assert injected._get_embedder() is emb.inner
    cfg.cache.frame_memo_size = 0
    assert not isinstance(VideoSearchEngine(tmp_path, config=cfg,
                                            device="cpu")._get_embedder(),
                          MemoizedEmbedder)
