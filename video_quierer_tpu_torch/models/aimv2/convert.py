"""``Aimv2Model``'s state dict → the port's ``AIMv2`` module.

The port keeps ``Aimv2Model``'s parameter names (``modeling_aimv2.py``).
Two things change on the way:

- ``vision_model.embeddings.patch_embed.weight``, the ``[D, 3, p, p]``
  conv kernel, becomes the ``[D, p·p·3]`` matrix over NHWC patches
  flattened in (row, column, channel) order;
- the non-persistent ``position_ids`` buffers, where a file holds them,
  are dropped.

Every other tensor passes as it is; a name the port does not know, a
missing one or a shape that differs raises ``ValueError``.
:func:`init_hf_state_dict` draws a seeded state dict under
``Aimv2Model``'s names, for a tower served without a checkpoint.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from video_quierer_tpu_torch.models.aimv2.config import AIMv2Config
from video_quierer_tpu_torch.models.aimv2.model import AIMv2
from video_quierer_tpu_torch.models.clip.convert import _load_state_dict

PATCH = "vision_model.embeddings.patch_embed.weight"


def port_shapes(cfg: AIMv2Config) -> Dict[str, tuple]:
    """Every parameter of the port's module, name → shape."""
    with torch.device("meta"):
        model = AIMv2(cfg)
    return {k: tuple(t.shape) for k, t in model.state_dict().items()}


def convert_hf_state_dict(sd: Mapping, cfg: AIMv2Config
                          ) -> Dict[str, torch.Tensor]:
    """``Aimv2Model`` tensors (torch or numpy) → the port's state dict."""
    out = {}
    for name, value in sd.items():
        if name.endswith("position_ids"):
            continue
        t = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value)
        if name == PATCH:
            t = t.permute(0, 2, 3, 1).reshape(t.shape[0], -1)
        out[name] = t
    want = port_shapes(cfg)
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    shapes = {k: (tuple(out[k].shape), want[k]) for k in set(want) & set(out)
              if tuple(out[k].shape) != want[k]}
    if missing or extra or shapes:
        shapes = dict(list(shapes.items())[:5])
        raise ValueError(f"AIMv2 state dict does not match {cfg.name}: "
                         f"missing {missing[:5]}, unknown {extra[:5]}, "
                         f"shapes (have, want) {shapes}")
    return out


def convert_aimv2_checkpoint(ckpt_dir: Path, cfg: AIMv2Config
                             ) -> Dict[str, torch.Tensor]:
    """An HF checkpoint directory (``model.safetensors`` or
    ``pytorch_model.bin``) → the port's state dict."""
    return convert_hf_state_dict(_load_state_dict(Path(ckpt_dir)), cfg)


def init_hf_state_dict(cfg: AIMv2Config, generator: torch.Generator
                       ) -> Dict[str, torch.Tensor]:
    """A seeded f32 state dict under ``Aimv2Model``'s names and shapes:
    dense matrices LeCun-normal (std ``1 / sqrt(fan_in)``), embeddings,
    the pooling query and biases std 0.02, RMSNorm scales ``1 + 0.02 n``,
    the logit scale at its init."""
    g = generator
    p = cfg.vision.patch_size
    out = {}
    for name, shape in port_shapes(cfg).items():
        if name == PATCH:
            shape = (cfg.vision.hidden_size, 3, p, p)
        if name == "logit_scale":
            out[name] = torch.tensor(cfg.logit_scale_init)
            continue
        x = torch.randn(*shape, generator=g)
        if "rms_norm" in name:
            x = 1.0 + 0.02 * x
        elif len(shape) >= 2 and "embedding" not in name \
                and "cls_token" not in name:
            x = x / math.sqrt(math.prod(shape[1:]))
        else:
            x = 0.02 * x
        out[name] = x
    return out
