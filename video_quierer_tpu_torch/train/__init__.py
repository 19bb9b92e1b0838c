"""Training: contrastive fine-tuning of the towers on one card
(counterpart of ``video_quierer_tpu/train``; meshes are ROADMAP A11b)."""

from video_quierer_tpu_torch.train.trainer import (  # noqa: F401
    CLIPTrainer,
    build_lr_schedule,
    clip_contrastive_loss,
)
from video_quierer_tpu_torch.train.eval import (  # noqa: F401
    evaluate_trainer,
    retrieval_metrics,
)
