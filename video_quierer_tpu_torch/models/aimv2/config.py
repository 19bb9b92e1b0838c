"""AIMv2 configurations, read from the keys of ``transformers``'
``Aimv2Config`` (``configuration_aimv2.py``).

``apple/aimv2-large-patch14-224-lit`` (alias ``aimv2-l14-lit``):

- vision: 224 px frames in 14 x 14 patches (256 positions, no class
  token), 24 blocks of width 1024, 8 heads of width 128, SiLU-gated MLP of
  width 2,816, RMSNorm (eps 1e-5), no biases in the blocks, an
  attention-pooling head;
- text: 12 causal blocks of width 768, 6 heads of width 128, MLP width
  2,048, vocabulary 49,408, 77 positions, pooled at the first EOS
  (49,407);
- ``projection_dim`` 512: ``Aimv2Config``'s default, which its docstring
  ties to this checkpoint (the checkpoint's own ``config.json`` is not
  read here).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class AIMv2VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 2816
    num_layers: int = 24
    num_heads: int = 8
    rms_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches           # no class token


@dataclasses.dataclass(frozen=True)
class AIMv2TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    hidden_size: int = 768
    intermediate_size: int = 2048
    num_layers: int = 12
    num_heads: int = 6
    rms_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class AIMv2Config:
    name: str = "aimv2-large-patch14-224-lit"
    projection_dim: int = 512
    vision: AIMv2VisionConfig = dataclasses.field(
        default_factory=AIMv2VisionConfig)
    text: AIMv2TextConfig = dataclasses.field(
        default_factory=AIMv2TextConfig)
    logit_scale_init: float = 2.6592


def aimv2_large_patch14_224_lit() -> AIMv2Config:
    return AIMv2Config()


# what the port implements of Aimv2Config: anything else is refused
_FIXED = {"hidden_act": "silu", "qkv_bias": False, "mlp_bias": False,
          "use_head": True, "is_native": False, "num_channels": 3}


def from_hf(d: Mapping) -> AIMv2Config:
    """An ``Aimv2Config`` as a dict (a ``config.json``'s, or the
    benchmark's configuration file) → :class:`AIMv2Config`; raises
    ``ValueError`` on a feature the port does not implement (biases, the
    native-resolution tower, another activation)."""
    v, t = d.get("vision_config", {}), d.get("text_config", {})
    for tower, keys in (("vision_config", v), ("text_config", t)):
        for key, want in _FIXED.items():
            if key in keys and keys[key] != want:
                raise ValueError(f"AIMv2 {tower}.{key}={keys[key]!r}: the "
                                 f"port implements {want!r} only")
    dv, dt = AIMv2VisionConfig(), AIMv2TextConfig()
    return AIMv2Config(
        name=d.get("name", AIMv2Config.name),
        projection_dim=d.get("projection_dim", 512),
        vision=AIMv2VisionConfig(
            image_size=v.get("image_size", dv.image_size),
            patch_size=v.get("patch_size", dv.patch_size),
            hidden_size=v.get("hidden_size", dv.hidden_size),
            intermediate_size=v.get("intermediate_size",
                                    dv.intermediate_size),
            num_layers=v.get("num_hidden_layers", dv.num_layers),
            num_heads=v.get("num_attention_heads", dv.num_heads),
            rms_norm_eps=v.get("rms_norm_eps", dv.rms_norm_eps)),
        text=AIMv2TextConfig(
            vocab_size=t.get("vocab_size", dt.vocab_size),
            context_length=t.get("max_position_embeddings",
                                 dt.context_length),
            hidden_size=t.get("hidden_size", dt.hidden_size),
            intermediate_size=t.get("intermediate_size",
                                    dt.intermediate_size),
            num_layers=t.get("num_hidden_layers", dt.num_layers),
            num_heads=t.get("num_attention_heads", dt.num_heads),
            rms_norm_eps=t.get("rms_norm_eps", dt.rms_norm_eps),
            eos_token_id=t.get("eos_token_id", dt.eos_token_id)))


DEFAULT_NAME = "apple/aimv2-large-patch14-224-lit"
CONFIGS = {
    "aimv2-l14-lit": aimv2_large_patch14_224_lit,
    DEFAULT_NAME: aimv2_large_patch14_224_lit,
}


def get_config(name: str) -> AIMv2Config:
    try:
        return CONFIGS[name]()
    except KeyError:
        raise ValueError(f"unknown AIMv2 config {name!r}; "
                         f"known: {sorted(CONFIGS)}") from None


def register_config(name: str, factory) -> None:
    """Register a tower config under ``name`` (tests register tiny
    towers)."""
    CONFIGS[name] = factory
