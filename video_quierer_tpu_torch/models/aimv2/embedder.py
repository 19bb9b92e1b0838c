"""AIMv2 embedder: the CLIP embedder's interface and buckets, so the
engine swaps families through ``model.family = "aimv2"``.

- Frames: the CLIP embedder's chunks, buckets and device path
  (``embed_frames_device``, with its ``embed.fetch`` span), normalised by
  CLIP's mean and standard deviation (AIMv2's processor takes them), then
  :func:`fused_aimv2_vision_encode` (kernels B5 and B6 with RMSNorm, the
  gated epilogue and B3 at head width 128) whenever the tower is eligible
  (``gated_tower_eligible``) and ``B·S >= MIN_TOKENS`` — every image
  bucket at S = 256 —, else the module tower.
- Text: CLIP's tokenizer (the checkpoint's BPE, else the hash tokenizer;
  vocabulary 49,408, 77 positions, EOS 49,407), ids trimmed to a seq
  bucket (exact: the tower is causal and pools the first EOS), padded to
  a batch bucket; ``B·S >= MIN_TOKENS`` with S in the 8/16/32 buckets
  takes :func:`fused_aimv2_text_encode` on the same halves (causal),
  everything else the module tower.
- ``embed_dim`` is ``projection_dim`` (512).

Weights: a state dict handed in (``Aimv2Model``'s names, through
``convert.convert_hf_state_dict``), else ``checkpoint_dir``'s HF
checkpoint read by ``convert.py``, else a seeded init
(``convert.init_hf_state_dict``) with a warning. Fine-tuned checkpoints
and data meshes are not taken: the port's trainer is CLIP's.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import torch

from video_quierer_tpu_torch.models.aimv2.config import (
    DEFAULT_NAME,
    get_config,
)
from video_quierer_tpu_torch.models.aimv2.convert import (
    convert_aimv2_checkpoint,
    convert_hf_state_dict,
    init_hf_state_dict,
)
from video_quierer_tpu_torch.models.aimv2.fused import (
    fused_aimv2_text_encode,
    fused_aimv2_vision_encode,
    gated_operands,
)
from video_quierer_tpu_torch.models.aimv2.model import AIMv2
from video_quierer_tpu_torch.models.clip.embedder import (
    CLIPEmbedder,
    place_module,
)
from video_quierer_tpu_torch.models.clip.tokenizer import load_tokenizer
from video_quierer_tpu_torch.ops.fused_layer import (
    GatedOps,
    fused_batch_eligible,
    fused_seq_eligible,
    gated_tower_eligible,
)
from video_quierer_tpu_torch.ops.preprocess import normalize_images

logger = logging.getLogger(__name__)


def _eligible(c) -> bool:
    return gated_tower_eligible(c.hidden_size, c.intermediate_size,
                                c.num_heads)


class AIMv2Embedder(CLIPEmbedder):
    """AIMv2 image and text encoder with the CLIP embedder's bucketed
    batching on one device."""

    def __init__(self, model_name: str = DEFAULT_NAME,
                 checkpoint_dir: Optional[Path] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda",
                 seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 orbax_checkpoint: Optional[Path] = None):
        """``state_dict``: ``Aimv2Model``'s names and shapes."""
        if orbax_checkpoint is not None:
            raise ValueError("the AIMv2 family serves HF checkpoints only: "
                             "the port's trainer is CLIP's")
        self._begin(get_config(model_name), device, dtype)
        if state_dict is not None:
            state_dict = convert_hf_state_dict(state_dict, self.cfg)
        elif checkpoint_dir is not None:
            logger.info("Loading AIMv2 weights from %s", checkpoint_dir)
            state_dict = convert_aimv2_checkpoint(Path(checkpoint_dir),
                                                  self.cfg)
            self.pretrained = True
        else:
            logger.warning("No AIMv2 checkpoint — seeded init")
            state_dict = convert_hf_state_dict(init_hf_state_dict(
                self.cfg, torch.Generator().manual_seed(seed)), self.cfg)
        params = place_module(AIMv2, self.cfg, state_dict, self.device,
                              dtype, self.load_seconds)
        del state_dict
        self._serve(params, load_tokenizer(checkpoint_dir))
        self._fused_text = _eligible(self.cfg.text)
        self._fused_vision = _eligible(self.cfg.vision)

    def _layer_ops(self, params: AIMv2, tower: str = "text"
                   ) -> List[GatedOps]:
        """Gated-half operands of ``params``' ``tower`` ("text" or
        "vision"), built once."""
        key = (id(params), tower)
        ops = self._ops.get(key)
        if ops is None:
            model = getattr(params, f"{tower}_model")
            ops = self._ops[key] = [gated_operands(layer, self.dtype)
                                    for layer in model.encoder.layers]
        return ops

    def _encode_image_fn(self, params: AIMv2,
                         frames_u8: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` uint8 on the device → ``[B, proj]`` f32 unit
        rows."""
        with torch.inference_mode():
            pixels = normalize_images(frames_u8, dtype=self.dtype)
            if self._fused_vision and fused_batch_eligible(
                    frames_u8.shape[0], self.cfg.vision.seq_len):
                return fused_aimv2_vision_encode(
                    params, pixels, self._layer_ops(params, "vision"))
            return params.encode_image(pixels)

    def _encode_text_fn(self, params: AIMv2,
                        input_ids: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` ids on the device → ``[B, proj]`` f32 unit rows."""
        b, s = input_ids.shape
        with torch.inference_mode():
            if self._fused_text and fused_seq_eligible(s) \
                    and fused_batch_eligible(b, s):
                return fused_aimv2_text_encode(params, input_ids,
                                               self._layer_ops(params))
            return params.encode_text(input_ids)
