"""Seeded AIMv2 weights, made by the benchmark and handed alike to the
program and to the plain reference, under ``Aimv2Model``'s parameter
names and shapes (``transformers/models/aimv2/modeling_aimv2.py``; the
patch projection as its ``[D, 3, p, p]`` conv kernel).

As ``gen.weights``: one ``randn`` call on the device for every leaf, each
a view scaled in place — dense matrices LeCun-normal (std
``1/sqrt(fan_in)``), embeddings, the pooling query and biases std 0.02,
RMSNorm scales ``1 + 0.02 n`` — and ``logit_scale`` at the published
init ``ln(1/0.07)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.gen import generator


def _layers(prefix: str, n: int, d: int, f: int) -> list:
    out = []
    for i in range(n):
        p = f"{prefix}.encoder.layers.{i}."
        out += [(p + f"attention.{x}.weight", (d, d), "dense")
                for x in ("q_proj", "k_proj", "v_proj", "out_proj")]
        out += [(p + "ffn.gate_proj.weight", (f, d), "dense"),
                (p + "ffn.up_proj.weight", (f, d), "dense"),
                (p + "ffn.down_proj.weight", (d, f), "dense"),
                (p + "rms_norm1.weight", (d,), "rms"),
                (p + "rms_norm2.weight", (d,), "rms")]
    return out


def leaf_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter of ``Aimv2Model``."""
    t, v = cfg["text_config"], cfg["vision_config"]
    dt, dv, p = t["hidden_size"], v["hidden_size"], v["patch_size"]
    n = (v["image_size"] // p) ** 2
    vm, tm = "vision_model", "text_model"
    out = [(f"{vm}.embeddings.patch_embed.weight", (dv, 3, p, p), "dense"),
           (f"{vm}.embeddings.patch_embed.bias", (dv,), "bias"),
           (f"{vm}.embeddings.rms_norm.weight", (dv,), "rms"),
           (f"{vm}.embeddings.position_embedding.weight", (n, dv), "embed")]
    out += _layers(vm, v["num_hidden_layers"], dv, v["intermediate_size"])
    out += [(f"{vm}.rms_norm.weight", (dv,), "rms"),
            (f"{vm}.head.k_proj.weight", (dv, dv), "dense"),
            (f"{vm}.head.v_proj.weight", (dv, dv), "dense"),
            (f"{vm}.head.cls_token", (1, 1, dv), "embed"),
            (f"{vm}.head.output_proj.weight", (dv, dv), "dense"),
            (f"{vm}.head.output_proj.bias", (dv,), "bias"),
            (f"{tm}.embeddings.token_embedding.weight",
             (t["vocab_size"], dt), "embed"),
            (f"{tm}.embeddings.position_embedding.weight",
             (t["max_position_embeddings"], dt), "embed")]
    out += _layers(tm, t["num_hidden_layers"], dt, t["intermediate_size"])
    out += [(f"{tm}.rms_norm.weight", (dt,), "rms"),
            ("visual_projection.weight", (cfg["projection_dim"], dv),
             "dense"),
            ("text_projection.weight", (cfg["projection_dim"], dt),
             "dense")]
    return out


def weights(cfg: dict, device, dtype: torch.dtype, seed: int
            ) -> Dict[str, torch.Tensor]:
    """The seeded ``Aimv2Model`` state dict in ``dtype`` on ``device``."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(s) for _, s, _ in specs)
    flat = torch.randn(total, generator=generator(device, seed, "weights"),
                       device=device, dtype=dtype)
    sd, pos = {}, 0
    with torch.no_grad():
        for name, shape, kind in specs:
            n = math.prod(shape)
            leaf = flat[pos:pos + n].view(shape)
            pos += n
            if kind == "dense":
                leaf.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
            else:
                leaf.mul_(0.02)
                if kind == "rms":
                    leaf.add_(1.0)
            sd[name] = leaf
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07), dtype=torch.float32,
                                     device=device)
    return sd
