"""SigLIP embedder (counterpart of
``video_quierer_tpu/models/siglip/embedder.py``): the CLIP embedder's
interface, so the engine swaps families through ``model.family``.

- Frames: the CLIP embedder's buckets and device path
  (``embed_frames_device``), normalised to SigLIP's ``[-1, 1]`` (mean =
  std = 0.5) and encoded by the module tower (kernel B3 and
  ``torch.matmul``), as the JAX package routes SigLIP vision.
- Text: the ids go in whole (``prepare_text_ids`` is the identity:
  trimming pad columns would change a non-causal tower's output), padded
  to a batch bucket; ``B·S >= MIN_TOKENS`` (from the 8-query bucket up at
  64 tokens) takes :func:`fused_siglip_text_encode` (kernels B5 and B6
  with tanh-GELU), smaller batches the module tower.
- Tokenizer: SentencePiece (``spm.py``) when a ``spiece.model`` is found
  (``VQT_SIGLIP_SPIECE``), else the hash tokenizer at SigLIP's geometry
  (64-token context, 32k vocab).
- ``embed_dim`` is the tower width (768): SigLIP has no projection.

Weights, in the reference's order: ``orbax_checkpoint``, a checkpoint of
the port's trainer, whose ``params`` tree is served (as the CLIP
embedder's; ``pretrained`` True); a state dict handed in (e.g. from
``bridge.params_from_jax``) is used as it is; else ``checkpoint_dir``'s HF
checkpoint, read by ``convert.py`` and bridged, but only when the
directory holds ``model.safetensors`` (a ``pytorch_model.bin`` alone is
not read: the reference's rule, kept for parity); else the port's seeded
init (``bridge.init_params``), with a warning. SigLIP takes no part in
``find_local_checkpoint``'s discovery, as in the reference.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from video_quierer_tpu_torch.models.clip.embedder import (
    CLIPEmbedder,
    place_module,
    read_checkpoint,
    read_trained,
)
from video_quierer_tpu_torch.models.clip.tokenizer import HashTokenizer
from video_quierer_tpu_torch.models.siglip.bridge import (
    init_params,
    params_from_jax,
)
from video_quierer_tpu_torch.models.siglip.convert import (
    convert_siglip_checkpoint,
)
from video_quierer_tpu_torch.models.siglip.fused import (
    fused_siglip_text_encode,
)
from video_quierer_tpu_torch.models.siglip.model import (
    SigLIP,
    SigLIPConfig,
    siglip_base_patch16,
)
from video_quierer_tpu_torch.models.siglip.spm import (
    SigLIPSPTokenizer,
    find_spiece_model,
)
from video_quierer_tpu_torch.ops.fused_layer import (
    fused_batch_eligible,
    fused_text_tower_eligible,
)
from video_quierer_tpu_torch.ops.preprocess import (
    SIGLIP_MEAN,
    SIGLIP_STD,
    normalize_images,
)

logger = logging.getLogger(__name__)


def siglip_tokenizer(cfg: Optional[SigLIPConfig] = None,
                     checkpoint_dir: Optional[Path] = None):
    """SentencePiece when a ``spiece.model`` is found
    (``VQT_SIGLIP_SPIECE`` or beside the checkpoint); otherwise the hash
    tokenizer at SigLIP's text geometry."""
    t = (cfg or siglip_base_patch16()).text
    spiece = find_spiece_model(checkpoint_dir)
    if spiece is not None:
        logger.info("SigLIP text: SentencePiece tokenizer from %s", spiece)
        return SigLIPSPTokenizer(spiece, context_length=t.context_length)
    return HashTokenizer(context_length=t.context_length,
                         vocab_size=t.vocab_size,
                         sot=t.vocab_size - 2, eot=t.vocab_size - 1)


class SigLIPEmbedder(CLIPEmbedder):
    """SigLIP image and text encoder with the CLIP embedder's bucketed
    batching on one device."""

    def __init__(self, cfg: Optional[SigLIPConfig] = None,
                 checkpoint_dir: Optional[Path] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda",
                 seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 orbax_checkpoint: Optional[Path] = None):
        self._begin(cfg or siglip_base_patch16(), device, dtype)
        if orbax_checkpoint is not None:
            logger.info("Loading fine-tuned SigLIP params from %s",
                        orbax_checkpoint)
            state_dict = read_trained(orbax_checkpoint, self.load_seconds)
            self.pretrained = True
        elif state_dict is None:
            if checkpoint_dir is not None and (
                    Path(checkpoint_dir) / "model.safetensors").exists():
                logger.info("Loading SigLIP weights from %s", checkpoint_dir)
                state_dict = read_checkpoint(
                    Path(checkpoint_dir), self.cfg,
                    convert_siglip_checkpoint, params_from_jax,
                    self.load_seconds)
                self.pretrained = True
            else:
                logger.warning("No local SigLIP checkpoint — seeded init")
                state_dict = init_params(self.cfg,
                                         torch.Generator().manual_seed(seed))
        params = place_module(SigLIP, self.cfg, state_dict, self.device,
                              dtype, self.load_seconds)
        del state_dict
        # no data mesh: the JAX SigLIP embedder takes none
        self._serve(params, siglip_tokenizer(self.cfg, checkpoint_dir))
        self._fused_text = fused_text_tower_eligible(self.cfg.text)

    @property
    def embed_dim(self) -> int:
        return self.cfg.vision.hidden_size

    def _encode_image_fn(self, params: SigLIP,
                         frames_u8: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` uint8 on the device → ``[B, hidden]`` f32 unit
        rows, on the module tower."""
        with torch.inference_mode():
            pixels = normalize_images(frames_u8, dtype=self.dtype,
                                      mean=SIGLIP_MEAN, std=SIGLIP_STD)
            return params.encode_image(pixels)

    def _encode_text_fn(self, params: SigLIP,
                        input_ids: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` ids on the device → ``[B, hidden]`` f32 unit rows."""
        with torch.inference_mode():
            if self._fused_text and fused_batch_eligible(*input_ids.shape):
                return fused_siglip_text_encode(params, input_ids,
                                                self._layer_ops(params))
            return params.encode_text(input_ids)

    @staticmethod
    def prepare_text_ids(ids: np.ndarray) -> np.ndarray:
        """The ids as the tokenizer gives them: the tower is non-causal
        and pools the last position, so no pad column may go."""
        return ids
