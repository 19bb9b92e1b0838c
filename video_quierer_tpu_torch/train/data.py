"""Training data: (frame, caption) batches from a videos directory
(counterpart of ``video_quierer_tpu/train/data.py``).

Frames stream through the ingest decode pipeline (``ingest/pipeline.py:
batched_frames``, each video decoded by ``ingest/frames.py:
extract_frames``, looked up at call time) and pair with captions: a
sidecar ``captions.json`` (``{video_filename: caption}``) when present,
else the video's filename (``"my_dog_at_the_beach.mp4"`` → ``"a video of
my dog at the beach"``, an upload's ``<uuid>_`` prefix stripped).
Batches are whole: the ragged tail is dropped. Images are normalised on
the host with the family's mean and std (serving normalises uint8 on the
device instead).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from video_quierer_tpu_torch.ingest import frames
from video_quierer_tpu_torch.ingest.pipeline import batched_frames
from video_quierer_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD


def caption_for(video_path: Path,
                captions: Optional[Dict[str, str]] = None) -> str:
    name = Path(video_path).name
    if captions and name in captions:
        return captions[name]
    stem = Path(name).stem
    # strip upload uuid prefixes ("<uuid>_original_name")
    stem = re.sub(r"^[0-9a-f]{8}-[0-9a-f-]{27}_", "", stem)
    words = re.sub(r"[_\-.]+", " ", stem).strip()
    return f"a video of {words}" if words else "a video"


def load_captions(videos_dir: Path) -> Optional[Dict[str, str]]:
    """``captions.json`` of ``videos_dir`` as ``{filename: caption}``;
    None when it is missing or unreadable."""
    path = Path(videos_dir) / "captions.json"
    if path.exists():
        try:
            with open(path) as f:
                return {str(k): str(v) for k, v in json.load(f).items()}
        except (OSError, ValueError, AttributeError):
            return None
    return None


def frame_caption_batches(video_paths: Sequence[Path], tokenizer,
                          batch_size: int = 64,
                          max_frames_per_video: int = 32,
                          sampling_mode: str = "medium",
                          captions: Optional[Dict[str, str]] = None,
                          image_size: int = 224,
                          mean=CLIP_MEAN, std=CLIP_STD,
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(images f32 [B, S, S, 3] normalised, input_ids int32 [B,
    ctx])``; ``mean``/``std`` must be the trained family's (SigLIP's for
    SigLIP) so that training and serving see the same inputs."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    caption_ids = {i: tokenizer(caption_for(p, captions))[0]
                   for i, p in enumerate(video_paths)}

    def extract(path):
        # the tower's resolution reaches the decode tier
        return frames.extract_frames(path, max_frames=max_frames_per_video,
                                     sampling_mode=sampling_mode,
                                     target_size=image_size)

    for batch in batched_frames(list(video_paths),
                                max_frames=max_frames_per_video,
                                sampling_mode=sampling_mode,
                                batch_size=batch_size,
                                extract_fn=extract):
        if len(batch) < batch_size:
            continue  # the ragged tail: training wants fixed shapes
        images = (batch.frames.astype(np.float32) / 255.0 - mean) / std
        ids = np.stack([caption_ids[v] for v in batch.video_indices])
        yield images, ids.astype(np.int32)


def train_on_videos(trainer, video_paths: Sequence[Path], tokenizer,
                    epochs: int = 1, batch_size: int = 64,
                    max_frames_per_video: int = 32,
                    captions: Optional[Dict[str, str]] = None,
                    image_size: int = 224,
                    mean=CLIP_MEAN, std=CLIP_STD):
    """A plain epoch loop; returns the losses, one a step. Each batch goes
    to the trainer whole: a mesh trainer splits the global batch over its
    data rows itself. ``image_size`` must be the tower's
    (``cfg.vision.image_size``)."""
    losses = []
    for _ in range(epochs):
        for images, ids in frame_caption_batches(
                video_paths, tokenizer, batch_size=batch_size,
                max_frames_per_video=max_frames_per_video,
                captions=captions, image_size=image_size,
                mean=mean, std=std):
            losses.append(trainer.step(images, ids))
    return losses
