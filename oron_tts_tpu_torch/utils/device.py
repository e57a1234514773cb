"""Device and compute-dtype defaults shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The card unless the caller asks for something else.

    ``None`` means CUDA; a machine without it raises instead of quietly
    running on the CPU. Pass ``device="cpu"`` to run there on purpose.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 compute on the card (the JAX package's serving default), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
