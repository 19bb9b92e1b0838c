"""CLIP architecture configurations.

Copy of ``video_quierer_tpu/models/clip/config.py`` for the PyTorch
port, which cannot import the JAX package (its ``__init__`` imports
jax); keep the two in step.

The reference hard-codes ``openai/clip-vit-base-patch32``
(video_search_overhaul.py:127-130); we make the family configurable so larger
towers can be served with tensor parallelism (parallel/mesh.py MODEL_AXIS).
Dimensions follow the published OpenAI CLIP architecture table.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-5
    # Mixture-of-experts tower (parallel/moe.py SwitchMoEMLP): every
    # ``moe_every``-th encoder block swaps its dense MLP for a Switch
    # top-1 MoE with this many experts. 0 = dense tower (default; the
    # OpenAI checkpoints are dense). Train with
    # train/finetune.py --moe-experts; EP shards the expert stacks over
    # an ``expert`` mesh axis.
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity: float = 1.25

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + class token


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-5
    eot_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str = "vit-b-32"
    projection_dim: int = 512
    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=CLIPVisionConfig)
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    # logit scale init (ln(1/0.07)) — used by the training objective.
    logit_scale_init: float = 2.6592


def vit_b_32() -> CLIPConfig:
    return CLIPConfig()


def vit_b_16() -> CLIPConfig:
    return CLIPConfig(
        name="vit-b-16",
        vision=CLIPVisionConfig(patch_size=16),
    )


def vit_l_14() -> CLIPConfig:
    return CLIPConfig(
        name="vit-l-14",
        projection_dim=768,
        vision=CLIPVisionConfig(patch_size=14, hidden_size=1024,
                                num_layers=24, num_heads=16),
        text=CLIPTextConfig(hidden_size=768, num_heads=12),
    )


CONFIGS = {
    "vit-b-32": vit_b_32,
    "vit-b-16": vit_b_16,
    "vit-l-14": vit_l_14,
    # aliases matching HF model ids used by the reference
    "openai/clip-vit-base-patch32": vit_b_32,
    "openai/clip-vit-base-patch16": vit_b_16,
    "openai/clip-vit-large-patch14": vit_l_14,
}


def get_config(name: str) -> CLIPConfig:
    try:
        return CONFIGS[name]()
    except KeyError:
        raise ValueError(f"unknown CLIP config {name!r}; "
                         f"known: {sorted(CONFIGS)}") from None


def register_config(name: str, factory) -> None:
    """Register a custom tower config under ``name`` so `model.name` in
    the engine config (and CLIPEmbedder) can select it — deployment
    hook for non-OpenAI tower shapes; tests register tiny towers."""
    CONFIGS[name] = factory
