"""Device-memory budgeting: choose ``gradient_checkpointing: auto``.

Counterpart of the JAX package's ``utils/memory.py``. ``auto`` trains
without rematerialisation whenever the worst padded batch fits the card, and
recomputes each block in the backward otherwise. A wrong "no-remat" is
an out-of-memory error, a wrong "remat" only costs speed, so the estimate
errs high.

The estimate is the port's own layout (``train/trainer.py``): f32 master
weights, the EMA (f32), AdamW's first moment (bf16 by default) and second
(f32), the working copy the backbone computes in (bf16 on the card) and the
f32 gradients, plus activations linear in the padded frames and in the
block-streams a step holds (a block each for the DiT and the UNetT, two for the
MMDiT). The parameter count and the block-streams are the caller's, as each
backbone states them (``models/f5tts.py`` ``config_param_count``,
``config_activation_depth``). The activation constants and the margin were
fitted on an NVIDIA H100 80GB HBM3 (700 W) from
``torch.cuda.max_memory_allocated`` of Base bf16 "lanes" steps with and
without rematerialisation (``chip_smoke.py``, ``memory`` phase, which prints
the points and the constants they imply, and fails if the estimate falls
below any measured peak).
"""

from __future__ import annotations

import os
from typing import Any

# Activation bytes a padded frame holds, per model dim and block-stream, in a
# bf16 step without rematerialisation (every block's saved tensors), and with
# it (each block's checkpointed inputs; one block's full set is added back
# for its recompute in the backward). Base peaks rose 8.27 GB for every 8,192
# frames without remat (44.8 B/frame/dim/layer, [12..24, 2048] and
# [24, 2816]) and 1.21 GB with it (4.5 above one block's 45).
ACT_BYTES_PER_FRAME_DIM_LAYER = 45.0
REMAT_BYTES_PER_FRAME_DIM_LAYER = 4.5
# Share of the card's memory the estimate may fill: the CUDA context (0.80
# GB) and the caching allocator's slack (reserved up to 1.057x allocated)
# left 0.937 of the card's 85.0e9 bytes; 0.92 keeps a margin below that.
MEMORY_MARGIN = 0.92


def state_bytes_per_param(mu_bf16: bool = True, bf16_compute: bool = True) -> int:
    """Bytes each parameter holds across a step: masters, EMA, moments, working copy, grads."""
    masters, ema, nu, grads = 4, 4, 4, 4
    mu = 2 if mu_bf16 else 4
    work = 2 if bf16_compute else 4
    return masters + ema + mu + nu + work + grads


def estimate_train_bytes(
    n_params: int, frames: int, dim: int, depth: int,
    mu_bf16: bool = True, bf16_compute: bool = True, remat: bool = False,
) -> int:
    """Peak device bytes of one training step over ``frames`` padded frames."""
    state = n_params * state_bytes_per_param(mu_bf16, bf16_compute)
    if remat:
        per_frame = dim * (REMAT_BYTES_PER_FRAME_DIM_LAYER * depth
                           + ACT_BYTES_PER_FRAME_DIM_LAYER)
    else:
        per_frame = dim * depth * ACT_BYTES_PER_FRAME_DIM_LAYER
    if not bf16_compute:
        per_frame *= 2  # f32 activations
    return int(state + frames * per_frame)


def worst_case_padded_frames(
    frames_threshold: int,
    max_clip_frames: int,
    row_multiple: int = 1,
    t_multiple: int = 64,
    max_samples: int = 0,
    min_clip_frames: int = 1,
) -> int:
    """Largest rows×T a frame-budget batch can really occupy after padding.

    The sampler bounds the sum of true frames by ``frames_threshold``, but
    the collator rounds the batch axis up to ``row_multiple`` and T up to
    ``t_multiple``: 17 clips of 2,816 frames (47.9k ≤ 48k budget) collate to
    24 rows × 2,816 = 67.6k frames, 1.4× the budget. This sweeps the batch
    row count and returns the padded worst case (sorted packing makes rows
    within a batch similar lengths, so T ≈ threshold/(rows-1), capped by
    the longest clip).
    """
    def round_up(n: int, m: int) -> int:
        return -(-n // m) * m

    min_clip_frames = max(1, min_clip_frames)
    worst = round_up(max_clip_frames, t_multiple) * row_multiple  # r = 1
    # the sampler cannot pack more rows than the budget divided by the
    # shortest admissible clip
    r_cap = frames_threshold // min_clip_frames + 1
    if max_samples:
        r_cap = min(r_cap, max_samples)
    r = 2
    while r <= r_cap:
        t = min(max_clip_frames,
                max(min_clip_frames, frames_threshold // (r - 1)))
        worst = max(worst, round_up(r, row_multiple) * round_up(t, t_multiple))
        r += 1
    return worst


def auto_gradient_checkpointing(
    config: dict[str, Any], frames: int, n_params: int, device_bytes: int | None = None,
    bf16_compute: bool | None = None, act_depth: int | None = None,
) -> bool:
    """True = rematerialise; False = the step without it fits ``device_bytes``.

    ``n_params`` is the backbone's parameter count; ``device_bytes`` defaults to
    the card's memory (:func:`device_memory_bytes`); ``bf16_compute`` to the
    config's ``mixed_precision``; ``act_depth``, the block-streams whose activations
    the step holds, to ``model.depth`` (two a block for an MMDiT: ``models/f5tts.py``
    ``config_activation_depth``).
    """
    m = config.get("model", {}) or {}
    if device_bytes is None:
        device_bytes = device_memory_bytes()
    if bf16_compute is None:
        bf16_compute = config.get("mixed_precision", "bfloat16") == "bfloat16"
    need = estimate_train_bytes(
        n_params, frames, m.get("dim", 1024), act_depth or m.get("depth", 22),
        mu_bf16=config.get("adam_mu_dtype", "bfloat16") == "bfloat16",
        bf16_compute=bf16_compute, remat=False,
    )
    return need > device_bytes * MEMORY_MARGIN


def device_memory_bytes(device: Any = None) -> int:
    """Total memory of the CUDA card (``torch.cuda.mem_get_info``); raises without CUDA."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_bytes needs a CUDA card; pass device_bytes")
    return int(torch.cuda.mem_get_info(device)[1])


def host_memory_bytes() -> int:
    """Physical memory of the host, the budget of a step run on the CPU."""
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
