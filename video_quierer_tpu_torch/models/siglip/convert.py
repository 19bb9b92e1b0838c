"""HF SigLIP checkpoint → parameter tree (counterpart of
``video_quierer_tpu/models/siglip/convert.py``), on the CLIP converter's
reader and layer mappers (``models/clip/convert.py``). Returns the JAX
package's numpy tree; the weights cross into the port's ``SigLIP`` through
``bridge.params_from_jax``. torch's ``MultiheadAttention`` packs the MAP
head's q/k/v as one ``in_proj`` ``[3D, D]``: it is split here."""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from video_quierer_tpu_torch.models.clip.convert import (
    _encoder_layers,
    _layernorm,
    _linear,
    _load_state_dict,
)
from video_quierer_tpu_torch.models.siglip.model import SigLIPConfig


def convert_siglip_checkpoint(ckpt_dir: Path, cfg: SigLIPConfig) -> Dict:
    sd = _load_state_dict(ckpt_dir)
    v, t = cfg.vision, cfg.text
    d = v.hidden_size

    in_w = sd["vision_model.head.attention.in_proj_weight"]
    in_b = sd["vision_model.head.attention.in_proj_bias"]
    head = {
        "probe": sd["vision_model.head.probe"],
        "q_proj": {"kernel": np.ascontiguousarray(in_w[:d].T),
                   "bias": in_b[:d]},
        "k_proj": {"kernel": np.ascontiguousarray(in_w[d:2 * d].T),
                   "bias": in_b[d:2 * d]},
        "v_proj": {"kernel": np.ascontiguousarray(in_w[2 * d:].T),
                   "bias": in_b[2 * d:]},
        "out_proj": _linear(sd, "vision_model.head.attention.out_proj"),
        "layernorm": _layernorm(sd, "vision_model.head.layernorm"),
        "mlp": {
            "fc1": _linear(sd, "vision_model.head.mlp.fc1"),
            "fc2": _linear(sd, "vision_model.head.mlp.fc2"),
        },
    }

    patch = sd["vision_model.embeddings.patch_embedding.weight"]
    return {
        "vision": {
            "patch_embedding": {
                "kernel": np.ascontiguousarray(
                    np.transpose(patch, (2, 3, 1, 0))),
                "bias": sd["vision_model.embeddings.patch_embedding.bias"],
            },
            "position_embedding":
                sd["vision_model.embeddings.position_embedding.weight"],
            "encoder": _encoder_layers(sd, "vision_model.encoder",
                                       v.num_layers),
            "post_layernorm": _layernorm(sd,
                                         "vision_model.post_layernorm"),
            "head": head,
        },
        "text": {
            "token_embedding": {
                "embedding":
                    sd["text_model.embeddings.token_embedding.weight"],
            },
            "position_embedding":
                sd["text_model.embeddings.position_embedding.weight"],
            "encoder": _encoder_layers(sd, "text_model.encoder",
                                       t.num_layers),
            "final_layer_norm":
                _layernorm(sd, "text_model.final_layer_norm"),
            "head": _linear(sd, "text_model.head"),
        },
        "logit_scale": sd["logit_scale"].reshape(()),
        "logit_bias": sd["logit_bias"].reshape(()),
    }
