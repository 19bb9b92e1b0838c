"""Device resolution for the port (counterpart of
``video_quierer_tpu/utils/env.py``).

The JAX package picks its backend implicitly and routes to the Pallas
kernels on a TPU and to XLA elsewhere. The port takes an explicit
``torch.device`` from the caller (engine → embedder → index) and holds
no global device state. Asking for CUDA where there is no card raises:
the server never carries on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``) → a
    checked ``torch.device``. CUDA that is not available raises
    ``RuntimeError``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was asked for but "
                "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
