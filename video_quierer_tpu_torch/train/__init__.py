"""Training: contrastive fine-tuning of the towers on one card or on a
``(data, model)`` or ``(data, expert)`` mesh (counterpart of
``video_quierer_tpu/train``)."""

from video_quierer_tpu_torch.train.trainer import (  # noqa: F401
    CLIPTrainer,
    build_lr_schedule,
    clip_contrastive_loss,
)
from video_quierer_tpu_torch.train.eval import (  # noqa: F401
    evaluate_trainer,
    retrieval_metrics,
)
