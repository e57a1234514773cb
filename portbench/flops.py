"""The yardstick's arithmetic: the card's peaks, model FLOPs, and kernels' bounds.

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


# ── model FLOPs (products only; elementwise work counts nothing) ──────────


def dit_frame_flops(m: dict) -> float:
    """Products of one frame through the DiT, attention's key loop aside."""
    dim, depth, ff, mel, td = m["dim"], m["depth"], m["ff_mult"], m["mel_dim"], m["text_dim"]
    block = 8 * dim * dim + 4 * dim * dim * ff
    inp = 2 * (2 * mel + td) * dim + 2 * (2 * dim * (dim // 16) * 31)
    final = 2 * dim * mel
    return depth * block + inp + final


def dit_row_flops(m: dict, frames: int) -> float:
    """One forward of one row of ``frames`` kept frames (attention over its own keys)."""
    attn = 4 * frames * frames * m["dim"] * m["depth"]
    return frames * dit_frame_flops(m) + attn


def text_embed_flops(m: dict, frames: int) -> float:
    td = m["text_dim"]
    return m["conv_layers"] * (2 * frames * td * 7 + 8 * frames * td * td)


def solve_flops(m: dict, row_frames: list[int], steps: int, guided: bool = True) -> float:
    """A CFG Euler solve: per step one forward of each row, two when guided; the text
    embedding once a branch; the AdaLN tables once a solve."""
    branches = 2 if guided else 1
    per_step = sum(dit_row_flops(m, n) for n in row_frames)
    adaln = steps * (m["depth"] * 2 * m["dim"] * 6 * m["dim"] + 2 * m["dim"] * 2 * m["dim"])
    text = branches * sum(text_embed_flops(m, n) for n in row_frames)
    return branches * steps * per_step + text + adaln


def train_step_flops(m: dict, row_frames: list[int]) -> float:
    """One training step: 3 × the forward of each row at its kept frames, with the
    text embedding and each row's AdaLN (no recomputation counted)."""
    fwd = sum(dit_row_flops(m, n) + text_embed_flops(m, n)
              + m["depth"] * 2 * m["dim"] * 6 * m["dim"] + 2 * m["dim"] * 2 * m["dim"]
              for n in row_frames if n > 0)
    return 3.0 * fwd
