"""Weights across the two packages, and the port's own seeded init.

- :func:`params_from_jax` maps the JAX package's flax parameter tree
  (as numpy arrays) onto the port's ``CLIP`` state dict: a Dense
  ``kernel [in, out]`` becomes ``weight [out, in]``; the patch conv's
  HWIO ``kernel [p, p, 3, D]`` becomes ``weight [D, p*p*3]`` over patches
  flattened in (row, column, channel) order; embeddings, positions and
  LayerNorm vectors are copied as they are; ``logit_scale`` is the tree's
  when it has one (the trainer's and HF checkpoints' trees do), else the
  config's ``logit_scale_init``, the constant flax's init gives it, so
  every state dict of the port's loads strictly into any ``CLIP``, a
  serving module included. A Switch-MoE layer's ``moe`` subtree maps
  its ``router`` Dense as any other and its expert stacks ``w1 [E, d,
  h]``, ``b1``, ``w2 [E, h, d]``, ``b2`` as they are (the port keeps the
  flax layout for ``torch.bmm``). Optimizer moments are trees shaped like
  the parameters: optax's AdamW ``mu`` and ``nu`` map the same way.
- :func:`init_params` draws a fresh state dict from an explicit
  ``torch.Generator`` in the distributions of flax's defaults (the JAX
  package's ``init_params``): Dense and conv kernels LeCun-normal
  (truncated normal, variance 1/fan_in), biases zero, the token embedding
  normal with std ``1/sqrt(hidden)``, text positions normal(0.01), the
  class embedding and vision positions normal(0.02), LayerNorm scale 1
  and bias 0, ``logit_scale`` the config's constant (no draw). An expert
  stack ``[E, in, out]`` is LeCun-normal with ``fan_in = E · in``: flax's
  ``lecun_normal`` counts the leading expert axis as a receptive field.
  The text tower is drawn first, then the vision tower. The
  numbers differ from jax.random's; the parity tests move weights with
  :func:`params_from_jax` instead.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from video_quierer_tpu_torch.models.clip.config import CLIPConfig
from video_quierer_tpu_torch.models.clip.model import is_moe_layer

_DENSE = {"attn/q_proj": "attn.q_proj", "attn/k_proj": "attn.k_proj",
          "attn/v_proj": "attn.v_proj", "attn/out_proj": "attn.out_proj",
          "mlp/fc1": "mlp.fc1", "mlp/fc2": "mlp.fc2"}
_LN = ("layer_norm1", "layer_norm2")

# std of a unit truncated normal on [-2, 2] (flax's lecun_normal rescale)
_TRUNC_STD = 0.87962566103423978


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _blocks_from_jax(encoder: Mapping, prefix: str, num_layers: int
                     ) -> Dict[str, torch.Tensor]:
    sd = {}
    for i in range(num_layers):
        lp = encoder[f"layers_{i}"]
        pre = f"{prefix}.layers.{i}."
        if "moe" in lp:
            moe = lp["moe"]
            sd[pre + "moe.router.weight"] = \
                _t(moe["router"]["kernel"]).t().contiguous()
            sd[pre + "moe.router.bias"] = _t(moe["router"]["bias"])
            for leaf in ("w1", "b1", "w2", "b2"):
                sd[pre + "moe." + leaf] = _t(moe[leaf])
        for flax_name, name in _DENSE.items():
            group, leaf = flax_name.split("/")
            if group not in lp:
                continue
            dense = lp[group][leaf]
            sd[pre + name + ".weight"] = _t(dense["kernel"]).t().contiguous()
            sd[pre + name + ".bias"] = _t(dense["bias"])
        for ln in _LN:
            sd[pre + ln + ".weight"] = _t(lp[ln]["scale"])
            sd[pre + ln + ".bias"] = _t(lp[ln]["bias"])
    return sd


def params_from_jax(params: Mapping, cfg: CLIPConfig
                    ) -> Dict[str, torch.Tensor]:
    """flax CLIP params (``{"vision", "text", "visual_projection",
    "text_projection", ...}``, leaves numpy-convertible) → the port's
    ``CLIP`` state dict (f32)."""
    tp, vp = params["text"], params["vision"]
    d = cfg.vision.hidden_size
    sd = {
        "text.token_embedding.weight": _t(tp["token_embedding"]["embedding"]),
        "text.position_embedding": _t(tp["position_embedding"]),
        "text.final_layer_norm.weight": _t(tp["final_layer_norm"]["scale"]),
        "text.final_layer_norm.bias": _t(tp["final_layer_norm"]["bias"]),
        "text_projection.weight":
            _t(params["text_projection"]["kernel"]).t().contiguous(),
        "vision.patch_embedding.weight":
            _t(vp["patch_embedding"]["kernel"]).reshape(-1, d).t()
            .contiguous(),
        "vision.class_embedding": _t(vp["class_embedding"]),
        "vision.position_embedding": _t(vp["position_embedding"]),
        "visual_projection.weight":
            _t(params["visual_projection"]["kernel"]).t().contiguous(),
        "logit_scale": _t(params.get("logit_scale", cfg.logit_scale_init)),
    }
    for tower in ("pre_layernorm", "post_layernorm"):
        sd[f"vision.{tower}.weight"] = _t(vp[tower]["scale"])
        sd[f"vision.{tower}.bias"] = _t(vp[tower]["bias"])
    sd.update(_blocks_from_jax(tp["encoder"], "text", cfg.text.num_layers))
    sd.update(_blocks_from_jax(vp["encoder"], "vision",
                               cfg.vision.num_layers))
    return sd


def _lecun(out_f: int, in_f: int, gen: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / in_f) / _TRUNC_STD
    w = torch.empty(out_f, in_f)
    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                generator=gen)
    return w


def _lecun_stack(e: int, in_f: int, out_f: int, gen: torch.Generator
                 ) -> torch.Tensor:
    """flax's ``lecun_normal`` over an ``[E, in, out]`` expert stack:
    ``fan_in = E · in``."""
    std = math.sqrt(1.0 / (e * in_f)) / _TRUNC_STD
    w = torch.empty(e, in_f, out_f)
    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                generator=gen)
    return w


def _init_moe(pre: str, e: int, d: int, f: int, g: torch.Generator
              ) -> Dict[str, torch.Tensor]:
    return {pre + "moe.router.weight": _lecun(e, d, g),
            pre + "moe.router.bias": torch.zeros(e),
            pre + "moe.w1": _lecun_stack(e, d, f, g),
            pre + "moe.b1": torch.zeros(e, f),
            pre + "moe.w2": _lecun_stack(e, f, d, g),
            pre + "moe.b2": torch.zeros(e, d)}


def _init_blocks(prefix: str, num_layers: int, d: int, f: int,
                 g: torch.Generator, vision=None) -> Dict[str, torch.Tensor]:
    sd = {}
    attn = {"attn.q_proj": (d, d), "attn.k_proj": (d, d),
            "attn.v_proj": (d, d), "attn.out_proj": (d, d)}
    mlp = {"mlp.fc1": (f, d), "mlp.fc2": (d, f)}
    for i in range(num_layers):
        pre = f"{prefix}.layers.{i}."
        moe = vision is not None and is_moe_layer(vision, i)
        for name, (out_f, in_f) in {**attn, **({} if moe else mlp)}.items():
            sd[pre + name + ".weight"] = _lecun(out_f, in_f, g)
            sd[pre + name + ".bias"] = torch.zeros(out_f)
        if moe:
            sd.update(_init_moe(pre, vision.moe_experts, d, f, g))
        for ln in _LN:
            sd[pre + ln + ".weight"] = torch.ones(d)
            sd[pre + ln + ".bias"] = torch.zeros(d)
    return sd


def init_params(cfg: CLIPConfig, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """Seeded f32 state dict for the port's ``CLIP`` module."""
    c = cfg.text
    d, f = c.hidden_size, c.hidden_size * c.mlp_ratio
    g = generator
    sd = {
        "text.token_embedding.weight":
            torch.randn(c.vocab_size, d, generator=g) / math.sqrt(d),
        "text.position_embedding":
            torch.randn(c.context_length, d, generator=g) * 0.01,
        "text.final_layer_norm.weight": torch.ones(d),
        "text.final_layer_norm.bias": torch.zeros(d),
        "text_projection.weight": _lecun(cfg.projection_dim, d, g),
    }
    sd.update(_init_blocks("text", c.num_layers, d, f, g))
    v = cfg.vision
    dv, p = v.hidden_size, v.patch_size
    sd.update({
        "vision.patch_embedding.weight": _lecun(dv, p * p * 3, g),
        "vision.class_embedding": torch.randn(dv, generator=g) * 0.02,
        "vision.position_embedding":
            torch.randn(v.seq_len, dv, generator=g) * 0.02,
    })
    for tower in ("pre_layernorm", "post_layernorm"):
        sd[f"vision.{tower}.weight"] = torch.ones(dv)
        sd[f"vision.{tower}.bias"] = torch.zeros(dv)
    sd.update(_init_blocks("vision", v.num_layers, dv, dv * v.mlp_ratio, g,
                           vision=v))
    sd["visual_projection.weight"] = _lecun(cfg.projection_dim, dv, g)
    sd["logit_scale"] = _t(cfg.logit_scale_init)
    return sd
