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


def card_name(device: torch.device | str) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``"cpu"``.

    Results measured on the card are recorded beside this line: a card may
    run below its 700 W maximum, and then slower under load.
    """
    if torch.device(device).type != "cuda":
        return "cpu"
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
