"""The yardstick's arithmetic: the card's peaks and kernels' bounds.

A model's FLOPs are its architecture's own count, beside its plain reference
(``train_step_flops`` and ``solve_flops`` of ``portbench/reference/<backbone>.py``).

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at the
full 700 W power limit. A kernel's bound is the larger of its operations over
the peak rate and its bytes (each input read once, each output written once)
over the memory bandwidth.
"""

from __future__ import annotations

import math

BF16_FLOPS = 989e12   # tensor cores, bf16 dense
F32_FLOPS = 67e12     # CUDA cores, f32
HBM_BYTES = 3.35e12   # bytes/s


def bound_s(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    return max(flops / peak, nbytes / HBM_BYTES)


# ── kernels (the counting of the port's kernel table, rows 1, 3 and 5) ───


def attn_fwd_bound_s(B: int, T: int, H: int, D: int, kv_sum: int, elem_bytes: int = 2) -> float:
    """Lanes attention forward over ``[B, T, H·D]``: 4·T·H·D FLOPs a kept key of a row;
    q, k, v read and o written once."""
    return bound_s(4.0 * T * H * D * kv_sum, 4 * B * T * H * D * elem_bytes + 4 * B)


def attn_bwd_bound_s(B: int, T: int, H: int, D: int, kv_sum: int, elem_bytes: int = 2) -> float:
    """Lanes attention backward: 10·T·H·D FLOPs a kept key (the recomputed scores, dP,
    dS, dQ, dK, dV); q, k, v, o, dO read and dQ, dK, dV written once, the f32 row
    statistic read once."""
    return bound_s(10.0 * T * H * D * kv_sum,
                   8 * B * T * H * D * elem_bytes + 4 * B * H * T + 4 * B)


def mel_bound_s(n_waves: int, n_samples: int, sr: int = 24000, n_fft: int = 1024,
                hop: int = 256, n_mels: int = 100) -> float:
    """Fused log-mel of ``n_waves`` waveforms of ``n_samples``: a frame's window, real
    FFT (2.5·N·log2 N), magnitudes, the filterbank's non-zero taps and the log, in f32;
    bytes: audio, output, window and taps."""
    from portbench.reference.mel import mel_filterbank

    filter_taps = int((mel_filterbank(sr, n_fft, n_mels) != 0).sum())
    frames = n_waves * (1 + n_samples // hop)
    n_freqs = n_fft // 2 + 1
    per_frame = n_fft + 2.5 * n_fft * math.log2(n_fft) + 3.0 * n_freqs + 2.0 * filter_taps + n_mels
    nbytes = (n_waves * n_samples + frames * n_mels + n_fft + filter_taps) * 4
    return bound_s(frames * per_frame, nbytes, F32_FLOPS)
