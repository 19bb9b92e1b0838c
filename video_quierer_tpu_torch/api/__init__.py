"""HTTP API of the port (``python -m video_quierer_tpu_torch.api``)."""
