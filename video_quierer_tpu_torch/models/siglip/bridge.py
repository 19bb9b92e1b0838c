"""SigLIP weights across the two packages, and the port's seeded init.

- :func:`params_from_jax` maps the JAX package's flax SigLIP tree (as
  numpy arrays) onto the port's ``SigLIP`` state dict, with the CLIP
  bridge's rules (``models/clip/bridge.py``): a Dense ``kernel [in, out]``
  becomes ``weight [out, in]``; the patch conv's HWIO ``kernel [p, p, 3,
  D]`` becomes ``weight [D, p*p*3]``, its bias kept; embeddings,
  positions, the MAP head's probe and LayerNorm vectors are copied as
  they are; ``logit_scale`` and ``logit_bias`` are the tree's, else the
  config's init constants (as the CLIP bridge's ``logit_scale``).
- :func:`init_params` draws a fresh state dict from an explicit
  ``torch.Generator`` in the distributions of flax's defaults (the JAX
  package's ``siglip_init_params``): Dense and conv kernels LeCun-normal,
  biases zero, the token embedding normal with std ``1/sqrt(hidden)``,
  both position tables normal(0.02), the probe normal(1), LayerNorm scale
  1 and bias 0, the logit scale and bias the config's constants (no
  draw). The text tower is drawn first, then the vision tower. The
  numbers differ from jax.random's; the parity tests move weights with
  :func:`params_from_jax` instead.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from video_quierer_tpu_torch.models.clip.bridge import (
    _blocks_from_jax,
    _init_blocks,
    _lecun,
    _t,
)
from video_quierer_tpu_torch.models.siglip.model import SigLIPConfig

_HEAD_DENSE = ("q_proj", "k_proj", "v_proj", "out_proj")


def _dense(sd: dict, name: str, p: Mapping) -> None:
    sd[name + ".weight"] = _t(p["kernel"]).t().contiguous()
    sd[name + ".bias"] = _t(p["bias"])


def _ln(sd: dict, name: str, p: Mapping) -> None:
    sd[name + ".weight"] = _t(p["scale"])
    sd[name + ".bias"] = _t(p["bias"])


def params_from_jax(params: Mapping, cfg: SigLIPConfig
                    ) -> Dict[str, torch.Tensor]:
    """flax SigLIP params (``{"vision", "text", "logit_scale",
    "logit_bias"}``, leaves numpy-convertible) → the port's ``SigLIP``
    state dict (f32)."""
    tp, vp = params["text"], params["vision"]
    d = cfg.vision.hidden_size
    head = vp["head"]
    sd = {
        "text.token_embedding.weight": _t(tp["token_embedding"]["embedding"]),
        "text.position_embedding": _t(tp["position_embedding"]),
        "vision.patch_embedding.weight":
            _t(vp["patch_embedding"]["kernel"]).reshape(-1, d).t()
            .contiguous(),
        "vision.patch_embedding.bias": _t(vp["patch_embedding"]["bias"]),
        "vision.position_embedding": _t(vp["position_embedding"]),
        "vision.head.probe": _t(head["probe"]),
        "logit_scale": _t(params.get("logit_scale", cfg.logit_scale_init)),
        "logit_bias": _t(params.get("logit_bias", cfg.logit_bias_init)),
    }
    _ln(sd, "text.final_layer_norm", tp["final_layer_norm"])
    _dense(sd, "text.head", tp["head"])
    _ln(sd, "vision.post_layernorm", vp["post_layernorm"])
    for name in _HEAD_DENSE:
        _dense(sd, f"vision.head.{name}", head[name])
    _ln(sd, "vision.head.layernorm", head["layernorm"])
    for fc in ("fc1", "fc2"):
        _dense(sd, f"vision.head.mlp.{fc}", head["mlp"][fc])
    sd.update(_blocks_from_jax(tp["encoder"], "text", cfg.text.num_layers))
    sd.update(_blocks_from_jax(vp["encoder"], "vision",
                               cfg.vision.num_layers))
    return sd


def init_params(cfg: SigLIPConfig, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """Seeded f32 state dict for the port's ``SigLIP`` module."""
    g = generator
    c = cfg.text
    d = c.hidden_size
    sd = {
        "text.token_embedding.weight":
            torch.randn(c.vocab_size, d, generator=g) / math.sqrt(d),
        "text.position_embedding":
            torch.randn(c.context_length, d, generator=g) * 0.02,
        "text.final_layer_norm.weight": torch.ones(d),
        "text.final_layer_norm.bias": torch.zeros(d),
        "text.head.weight": _lecun(d, d, g),
        "text.head.bias": torch.zeros(d),
    }
    sd.update(_init_blocks("text", c.num_layers, d, d * c.mlp_ratio, g))
    v = cfg.vision
    dv, p, f = v.hidden_size, v.patch_size, v.hidden_size * v.mlp_ratio
    sd.update({
        "vision.patch_embedding.weight": _lecun(dv, p * p * 3, g),
        "vision.patch_embedding.bias": torch.zeros(dv),
        "vision.position_embedding":
            torch.randn(v.num_patches, dv, generator=g) * 0.02,
        "vision.post_layernorm.weight": torch.ones(dv),
        "vision.post_layernorm.bias": torch.zeros(dv),
    })
    sd.update(_init_blocks("vision", v.num_layers, dv, f, g))
    sd["vision.head.probe"] = torch.randn(1, 1, dv, generator=g)
    for name in _HEAD_DENSE:
        sd[f"vision.head.{name}.weight"] = _lecun(dv, dv, g)
        sd[f"vision.head.{name}.bias"] = torch.zeros(dv)
    sd["vision.head.layernorm.weight"] = torch.ones(dv)
    sd["vision.head.layernorm.bias"] = torch.zeros(dv)
    sd["vision.head.mlp.fc1.weight"] = _lecun(f, dv, g)
    sd["vision.head.mlp.fc1.bias"] = torch.zeros(f)
    sd["vision.head.mlp.fc2.weight"] = _lecun(dv, f, g)
    sd["vision.head.mlp.fc2.bias"] = torch.zeros(dv)
    sd["logit_scale"] = _t(cfg.logit_scale_init)
    sd["logit_bias"] = _t(cfg.logit_bias_init)
    return sd
