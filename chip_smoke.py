#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis and training slices on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. build: ``nvcc`` builds every kernel of ``oron_tts_tpu_torch/csrc`` into
   ``build/torch_kernels/`` (one process per source, in parallel).
3. kernels: each kernel against its plain PyTorch version on the card at
   the slice's shapes, with its time, the plain version's, a PyTorch
   library call's where one computes the same function, and its bound.
4. reference: a small f32 model on the card against the same model on the
   CPU (plain versions), same weights and noise: mel and waveform agree;
   then one training step of a small f32 model on both from the same
   weights, batch and generator seed: loss, gradient norm and update agree.
5. slice: ``F5TTS.synthesize`` at the Base width in bf16 with seeded DiT
   weights and the bundled vocoder, ref-free and voice-cloned, 32 steps,
   CFG 2; launch counts are zeroed just before each and read just after.
6. profile: one more synthesis of each kind under ``torch.profiler``: the
   device time by kernel kind, the device's idle share of the wall time and
   the number of kernels launched.
7. train: ``F5Trainer`` at the Base width in bf16 (seeded weights, dropout
   0.1, no rematerialisation) over a seeded synthetic ``TTSDataset`` of 24
   clips in batches of ``[12, 2048]`` frames: a warm-up epoch through
   ``train_epoch``, then timed steps with per-step launch counts, one more
   step under ``torch.profiler``, and a checkpoint written and read back.

Then the kernel table and, last, ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM data sheet
H100_F32_FLOPS = 67e12    # CUDA-core f32 peak
H100_BYTES = 3.35e12      # HBM3 bytes/s
MN_TEXT = "Монгол хэл бол Төв Азийн өргөн уудам нутагт олон сая хүний ярьдаг хэл юм."
REF_TEXT = "Өнөөдөр цаг агаар сайхан байна"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(flops: float, peak: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_by_backend(torch, F, qh, kh, vh, mask) -> dict[str, float | str]:
    """SDPA's time under each backend it offers; a backend that refuses a
    bool mask at these shapes is recorded with its refusal, not timed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out: dict[str, float | str] = {}
    for name in ("MATH", "EFFICIENT_ATTENTION", "FLASH_ATTENTION", "CUDNN_ATTENTION"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]):
                out[name] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask))
        except RuntimeError as exc:  # a yardstick only: the port never calls SDPA
            out[name] = "refused: " + str(exc).splitlines()[0][:80]
    return out


def fastest(times: dict[str, float | str]) -> tuple[str, float]:
    name = min((k for k, v in times.items() if isinstance(v, float)), key=lambda k: times[k])
    return name, times[name]


TRAIN_B, TRAIN_T = 12, 2048  # the single-chip training shape (Base, bf16)


def train_clip_frames() -> list[int]:
    """24 seeded clip lengths in frames, 12 s to 21.8 s; clips 0 and 12 the longest."""
    import numpy as np

    frames = np.random.default_rng(5).integers(1125, TRAIN_T, size=24)
    frames[::TRAIN_B] = TRAIN_T
    return [int(f) for f in frames]


def check_train_kernels(torch, F, report) -> list[dict]:
    """Kernels 4, 5, 10, 11 at the training shapes against their plain versions."""
    from oron_tts_tpu_torch.ops.flash_attention import (
        flash_lanes_bwd,
        flash_lanes_bwd_plain,
        flash_lanes_fwd,
        flash_lanes_fwd_stats,
        flash_lanes_fwd_stats_plain,
    )
    from oron_tts_tpu_torch.ops.gelu_dropout import (
        gelu_dropout_bwd,
        gelu_dropout_bwd_plain,
        gelu_dropout_fwd,
        gelu_dropout_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    src_fwd = "oron_tts_tpu_torch/csrc/flash_lanes.cu"
    src_bwd = "oron_tts_tpu_torch/csrc/flash_lanes_bwd.cu"
    src_gd = "oron_tts_tpu_torch/csrc/gelu_dropout.cu"

    def attention_case(B, T, H, lens, dtype, rel_tol, shape_tag=None, timed=False):
        D = 64
        out_tol = 5e-3 if dtype == torch.bfloat16 else 2e-4  # flash_lanes_fwd's tolerances
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        q, k, v, do = (torch.randn(B, T, H * D, generator=gen, device=dev).to(dtype)
                       for _ in range(4))
        out, lse = flash_lanes_fwd_stats(q, k, v, lens_t, H)
        same = torch.equal(out, flash_lanes_fwd(q, k, v, lens_t, H))
        ref_out, ref_lse = flash_lanes_fwd_stats_plain(q.float(), k.float(), v.float(), lens_t, H)
        dq, dk, dv = flash_lanes_bwd(q, k, v, lens_t, out, do, lse, H)
        refs = flash_lanes_bwd_plain(q.float(), k.float(), v.float(), lens_t, out.float(),
                                     do.float(), lse, H)
        torch.cuda.synchronize()
        if not same:
            raise AssertionError("flash_lanes_fwd_stats and flash_lanes_fwd outputs differ")
        tag = {} if shape_tag is None else {"shape": shape_tag}
        fwd_row = {"name": "flash_lanes_fwd_stats", "dtype": str(dtype), **tag,
                   "out_bit_equal_to_fwd": same,
                   "out_max_abs_err": (out.float() - ref_out).abs().max().item(),
                   "out_tol": out_tol,
                   "max_abs_err": (lse - ref_lse).abs().max().item(), "tol": 1e-4}
        # each gradient is held to rel_tol of its own reference's largest value
        names = ("dq", "dk", "dv")
        errs = {n: (a.float() - r).abs().max().item() for n, a, r in zip(names, (dq, dk, dv), refs)}
        tols = {n + "_tol": rel_tol * r.abs().max().item() for n, r in zip(names, refs)}
        bwd_row = {"name": "flash_lanes_bwd", "dtype": str(dtype), **tag, **errs, **tols,
                   "max_abs_err": max(errs.values()), "tol": max(tols.values())}
        if timed:
            kept = float(lens_t.clamp(max=T).sum())
            qh, kh, vh, doh = (x.view(B, T, H, D).transpose(1, 2).contiguous().requires_grad_(
                x is not do) for x in (q, k, v, do))
            mask = (torch.arange(T, device=dev)[None, :] < lens_t[:, None])[:, None, None, :]
            fwd_times = sdpa_by_backend(torch, F, qh.detach(), kh.detach(), vh.detach(), mask)
            best, best_ms = fastest(fwd_times)
            from torch.nn.attention import SDPBackend, sdpa_kernel

            with sdpa_kernel([getattr(SDPBackend, best)]):
                lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
                lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                    lib_out, (qh, kh, vh), doh, retain_graph=True), iters=5)
            del lib_out
            nb = q.numel() * 2
            b_ms, b_by = bound_ms(4.0 * T * H * D * kept, H100_BF16_FLOPS,
                                  4 * nb + lse.numel() * 4 + lens_t.numel() * 4)
            fwd_row.update(
                ms=cuda_ms(lambda: flash_lanes_fwd_stats(q, k, v, lens_t, H)),
                plain_ms=cuda_ms(lambda: flash_lanes_fwd_stats_plain(q, k, v, lens_t, H), iters=3),
                library_ms=best_ms, library="SDPA " + best, sdpa_ms_by_backend=fwd_times,
                bound_ms=b_ms, bound_by=b_by, route="cuda", source=src_fwd,
                replaces="oron_tts_tpu/ops/flash_attention.py:424")
            b_ms, b_by = bound_ms(10.0 * T * H * D * kept, H100_BF16_FLOPS,
                                  8 * nb + lse.numel() * 4 + lens_t.numel() * 4)
            bwd_row.update(
                ms=cuda_ms(lambda: flash_lanes_bwd(q, k, v, lens_t, out, do, lse, H), iters=5),
                plain_ms=cuda_ms(lambda: flash_lanes_bwd_plain(
                    q, k, v, lens_t, out, do, lse, H), iters=3),
                library_ms=lib_bwd, library="autograd backward of SDPA " + best,
                bound_ms=b_ms, bound_by=b_by, route="cuda", source=src_bwd,
                replaces="oron_tts_tpu/ops/flash_attention.py:528")
            rows.extend([fwd_row, bwd_row])
        report(fwd_row)
        report(bwd_row)
        if not fwd_row["out_max_abs_err"] <= out_tol:
            raise AssertionError(f"flash_lanes_fwd_stats ({dtype}) output off by "
                                 f"{fwd_row['out_max_abs_err']}")
        for n in names:
            if not errs[n] <= tols[n + "_tol"]:
                raise AssertionError(f"flash_lanes_bwd ({dtype}) {n} off by {errs[n]}, "
                                     f"tolerance {tols[n + '_tol']}")

    # the training shape, ragged kv_lens >= 1: f32 once small, bf16 timed
    attention_case(3, 200, 4, [200, 137, 1], torch.float32, 2e-4, "edge T=200")
    attention_case(3, 200, 4, [200, 137, 1], torch.bfloat16, 1e-2, "edge T=200")
    attention_case(2, 832, 16, [832, 755], torch.float32, 2e-4, "T=832")
    attention_case(TRAIN_B, TRAIN_T, 16, train_clip_frames()[:TRAIN_B], torch.bfloat16, 1e-2,
                   timed=True)

    # the conv's training pair at the training shape: the kernel's forward,
    # held against its plain version in f32 on the same bf16 values, and the
    # backward the Function takes through the library reference (no kernel)
    from oron_tts_tpu_torch.ops.grouped_conv import (
        grouped_conv1d_mish,
        grouped_conv1d_mish_grad,
        grouped_conv1d_mish_plain,
    )

    xc = torch.randn(TRAIN_B, TRAIN_T, 1024, generator=gen, device=dev).to(torch.bfloat16)
    wc = (torch.randn(31, 64, 1024, generator=gen, device=dev) / 44.5).to(torch.bfloat16)
    bc = (0.1 * torch.randn(1024, generator=gen, device=dev)).to(torch.bfloat16)
    report({"name": "grouped_conv1d_mish", "dtype": "torch.bfloat16",
            "shape": [TRAIN_B, TRAIN_T, 1024], "tol": 2e-2,
            "max_abs_err": (grouped_conv1d_mish(xc, wc, bc, 16).float() - grouped_conv1d_mish_plain(
                xc.float(), wc.float(), bc.float(), 16)).abs().max().item()})
    for leaf in (xc, wc, bc):
        leaf.requires_grad_(True)
    yc = grouped_conv1d_mish_grad(xc, wc, bc, 16)
    dyc = torch.randn_like(yc)
    emit({"phase": "conv_training_pair", "shape": [TRAIN_B, TRAIN_T, 1024],
          "forward_kernel_ms": cuda_ms(lambda: grouped_conv1d_mish_grad(xc, wc, bc, 16)),
          "backward_reference_ms": cuda_ms(lambda: torch.autograd.grad(
              yc, (xc, wc, bc), dyc, retain_graph=True), iters=5)})
    del xc, wc, bc, yc, dyc

    # GELU + dropout at [B*T, 4*dim]; the mask is read off a positive input,
    # where a zero can only be a dropped element
    seed, rate = -1234567, 0.1
    for shape, dtype in (((5, 7, 33), torch.float32), ((5, 7, 33), torch.bfloat16),
                         ((TRAIN_B * TRAIN_T, 4096), torch.float32),
                         ((TRAIN_B * TRAIN_T, 4096), torch.bfloat16)):
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        dy = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        pos = x.abs() + 0.5
        mask_equal = (
            torch.equal(gelu_dropout_fwd(pos, seed, rate) == 0, gelu_dropout_plain(pos, seed, rate) == 0)
            and torch.equal(gelu_dropout_bwd(pos, pos, seed, rate) == 0,
                            gelu_dropout_bwd_plain(pos, pos, seed, rate) == 0))
        dropped = (gelu_dropout_fwd(pos, seed, rate) == 0).float().mean().item()
        del pos
        # bf16: one rounding of the storage type, relative to the value; f32:
        # 1e-5 of (|value| + 1), as tanhf and fused multiply-adds differ from
        # the plain ops by a few ulp, more where dGELU's terms cancel
        ulp, floor = (2.0 ** -7, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1.0)
        big = len(shape) == 2
        for name, got, ref, line in (
            ("gelu_dropout_fwd", gelu_dropout_fwd(x, seed, rate),
             gelu_dropout_plain(x, seed, rate), 76),
            ("gelu_dropout_bwd", gelu_dropout_bwd(x, dy, seed, rate),
             gelu_dropout_bwd_plain(x, dy, seed, rate), 87),
        ):
            diff = (got.float() - ref.float()).abs()
            rel = (diff / (ref.float().abs() + floor)).max().item()
            row = {"name": name, "dtype": str(dtype), "shape": list(shape),
                   "mask_equal": mask_equal, "dropped_share": dropped,
                   "max_abs_err": diff.max().item(), "max_rel_err": rel, "tol": ulp,
                   "tol_on": "max_rel_err"}
            del diff
            if not mask_equal:
                raise AssertionError(f"{name}: the dropout mask differs from the plain version")
            if big and dtype == torch.bfloat16:
                bwd = name.endswith("bwd")
                xs = x.clone().requires_grad_(True)
                if bwd:
                    lib_y = F.dropout(F.gelu(xs, approximate="tanh"), rate)
                    lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_y, xs, dy, retain_graph=True))
                    del lib_y
                    k_ms = cuda_ms(lambda: gelu_dropout_bwd(x, dy, seed, rate))
                    p_ms = cuda_ms(lambda: gelu_dropout_bwd_plain(x, dy, seed, rate), iters=3)
                else:
                    lib_ms = cuda_ms(lambda: F.dropout(F.gelu(x, approximate="tanh"), rate))
                    k_ms = cuda_ms(lambda: gelu_dropout_fwd(x, seed, rate))
                    p_ms = cuda_ms(lambda: gelu_dropout_plain(x, seed, rate), iters=3)
                n = x.numel()
                b_ms, b_by = bound_ms((40.0 if bwd else 25.0) * n, H100_F32_FLOPS,
                                      (3 if bwd else 2) * n * 2)
                row.update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                           library="F.dropout(F.gelu(tanh))" + (" autograd backward" if bwd else ""),
                           bound_ms=b_ms, bound_by=b_by, route="cuda", source=src_gd,
                           replaces=f"oron_tts_tpu/ops/gelu_dropout.py:{line}")
                rows.append(row)
            emit({"phase": "kernel", **row})
            if not rel <= ulp:
                raise AssertionError(f"{name} ({dtype}) off by {rel} relative")
    return rows


def check_kernels(torch, F) -> list[dict]:
    from oron_tts_tpu_torch.config import ModelConfig
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd, flash_lanes_plain
    from oron_tts_tpu_torch.ops.fused_mel import log_mel_fused, log_mel_plain
    from oron_tts_tpu_torch.ops.grouped_conv import (
        grouped_conv1d_mish,
        grouped_conv1d_mish_plain,
        mish,
    )
    from oron_tts_tpu_torch.ops.mel import MelConfig, mel_constants
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []

    def report(row: dict) -> None:
        emit({"phase": "kernel", **row})
        if not row["max_abs_err"] <= row["tol"]:
            raise AssertionError(f"{row['name']} ({row['dtype']}) off by {row['max_abs_err']}")

    # 1. lanes attention: q/k/v [2, 832, 1024], kv_lens [832, 755]
    B, T, H, D = 2, 832, 16, 64
    lens = torch.tensor([832, 755], dtype=torch.int32, device=dev)
    # bf16: the plain version in f32 on the same (already rounded) inputs, so
    # the error is the kernel's own (P rounded to bf16, one output rounding)
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 5e-3)):
        q, k, v = (torch.randn(B, T, H * D, generator=gen, device=dev).to(dtype) for _ in range(3))
        out = flash_lanes_fwd(q, k, v, lens, H)
        ref = flash_lanes_plain(q.float(), k.float(), v.float(), lens, H)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        row = {"name": "flash_lanes_fwd", "dtype": str(dtype), "max_abs_err": err, "tol": tol}
        if dtype == torch.bfloat16:
            qh, kh, vh = (x.view(B, T, H, D).transpose(1, 2).contiguous() for x in (q, k, v))
            mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
            flops = 4.0 * T * H * D * float(lens.clamp(max=T).sum())
            b_ms, b_by = bound_ms(flops, H100_BF16_FLOPS, 4 * q.numel() * 2 + lens.numel() * 4)
            row.update(
                ms=cuda_ms(lambda: flash_lanes_fwd(q, k, v, lens, H)),
                plain_ms=cuda_ms(lambda: flash_lanes_plain(q, k, v, lens, H)),
                bound_ms=b_ms, bound_by=b_by,
                route="cuda", source="oron_tts_tpu_torch/csrc/flash_lanes.cu",
                replaces="oron_tts_tpu/ops/flash_attention.py:387",
            )
            # the library yardstick: SDPA under each backend, the fastest kept
            row["sdpa_ms_by_backend"] = sdpa_by_backend(torch, F, qh, kh, vh, mask)
            best, row["library_ms"] = fastest(row["sdpa_ms_by_backend"])
            row["library"] = "SDPA " + best
            rows.append(row)
        report(row)

    # 2. grouped conv + Mish: x [2, 832, 1024], Base conv weights [31, 64, 1024]
    p = seeded_dit_params(ModelConfig(), seed=0)["input_embed"]["conv_pos_embed"]["conv1"]
    C, G = 1024, 16
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.randn(B, T, C, generator=gen, device=dev).to(dtype)
        w = torch.from_numpy(p["kernel"]).to(dev, dtype)
        bias = torch.from_numpy(p["bias"]).to(dev)
        out = grouped_conv1d_mish(x, w, bias, G)
        # the plain version in f32 on the same (already rounded) values; the
        # kernel also sums in f32 and rounds once, at its output
        ref = grouped_conv1d_mish_plain(x.float(), w.float(), bias, G)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        row = {"name": "grouped_conv1d_mish", "dtype": str(dtype), "max_abs_err": err, "tol": tol}
        if dtype == torch.bfloat16:
            xt = x.transpose(1, 2).contiguous()
            wt = w.permute(2, 1, 0).contiguous()
            bt = bias.to(dtype)
            K, cin_g = w.shape[0], w.shape[1]
            flops = 2.0 * B * T * C * cin_g * K
            nbytes = 2 * x.numel() * 2 + w.numel() * 2 + bias.numel() * 4
            b_ms, b_by = bound_ms(flops, H100_BF16_FLOPS, nbytes)
            row.update(
                ms=cuda_ms(lambda: grouped_conv1d_mish(x, w, bias, G)),
                plain_ms=cuda_ms(lambda: grouped_conv1d_mish_plain(x, w, bias, G)),
                library_ms=cuda_ms(lambda: mish(F.conv1d(xt, wt, bt, padding=K // 2, groups=G))),
                library="F.conv1d groups 16 + Mish",
                bound_ms=b_ms, bound_by=b_by,
                route="cuda", source="oron_tts_tpu_torch/csrc/grouped_conv.cu",
                replaces="oron_tts_tpu/ops/grouped_conv.py:34",
            )
            rows.append(row)
        report(row)

    # ragged edges: T not a multiple of any tile, a row with every key masked
    lens3 = torch.tensor([200, 137, 0], dtype=torch.int32, device=dev)
    for dtype, tol, conv_tol in ((torch.float32, 2e-4, 2e-4), (torch.bfloat16, 5e-3, 2e-2)):
        q, k, v = (torch.randn(3, 200, 256, generator=gen, device=dev).to(dtype) for _ in range(3))
        err = (flash_lanes_fwd(q, k, v, lens3, 4).float()
               - flash_lanes_plain(q.float(), k.float(), v.float(), lens3, 4)).abs().max().item()
        report({"name": "flash_lanes_fwd", "dtype": str(dtype), "shape": "edge T=200",
                "max_abs_err": err, "tol": tol})
        x = torch.randn(1, 200, C, generator=gen, device=dev).to(dtype)
        w = torch.from_numpy(p["kernel"]).to(dev, dtype)
        err = (grouped_conv1d_mish(x, w, bias, G).float()
               - grouped_conv1d_mish_plain(x.float(), w.float(), bias, G)).abs().max().item()
        report({"name": "grouped_conv1d_mish", "dtype": str(dtype), "shape": "edge T=200",
                "max_abs_err": err, "tol": conv_tol})

    # 3. fused log-mel: 10 s of seeded noise at 24 kHz
    cfg = MelConfig()
    audio = 0.3 * torch.randn(240000, generator=gen, device=dev)
    out = log_mel_fused(audio, cfg)
    ref = log_mel_plain(audio, cfg)
    torch.cuda.synchronize()
    n_frames, n_bins = out.shape[1], cfg.n_freqs
    # the least work for the function: window, a real FFT (2.5 N log2 N),
    # magnitudes, the filterbank's non-zero taps (its triangles overlap only
    # pairwise) and the log; bytes: audio, output, window and those taps
    window, fb = mel_constants(cfg)
    taps = int((fb != 0).sum())
    per_frame = (cfg.n_fft + 2.5 * cfg.n_fft * math.log2(cfg.n_fft) + 3.0 * n_bins
                 + 2.0 * taps + cfg.n_mels)
    flops = n_frames * per_frame
    nbytes = (audio.numel() + out.numel() + window.size + taps) * 4
    b_ms, b_by = bound_ms(flops, H100_F32_FLOPS, nbytes)
    row = {
        "name": "log_mel_fused", "dtype": "torch.float32",
        "max_abs_err": (out - ref).abs().max().item(), "tol": 1e-3,
        "ms": cuda_ms(lambda: log_mel_fused(audio, cfg)),
        "plain_ms": cuda_ms(lambda: log_mel_plain(audio, cfg)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "route": "cuda", "source": "oron_tts_tpu_torch/csrc/fused_mel.cu",
        "replaces": "oron_tts_tpu/ops/pallas_mel.py:26",
    }
    rows.append(row)
    report(row)
    short = 0.3 * torch.randn(30001, generator=gen, device=dev)
    report({"name": "log_mel_fused", "dtype": "torch.float32", "shape": "edge L=30001",
            "max_abs_err": (log_mel_fused(short, cfg) - log_mel_plain(short, cfg)).abs().max().item(),
            "tol": 1e-3})
    del audio, out, ref, q, k, v, x
    torch.cuda.empty_cache()
    return rows + check_train_kernels(torch, F, report)


def check_reference(torch) -> None:
    """Small f32 model: card (kernels) vs CPU (plain versions), same inputs."""
    from oron_tts_tpu_torch.config import F5Config, ModelConfig
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    mcfg = ModelConfig(dim=256, depth=2, heads=4, text_dim=64, conv_layers=1)
    params = seeded_dit_params(mcfg, seed=1)
    rng = torch.Generator().manual_seed(2)
    T, ref_len, dur = 192, 40, 170
    cond = torch.zeros(1, T, 100)
    cond[0, :ref_len] = torch.randn(ref_len, 100, generator=rng)
    ids = torch.randint(1, 64, (1, T), generator=rng)
    ids[0, dur:] = -1
    noise = torch.randn(1, T, 100, generator=rng)
    mels, wavs = [], []
    for device in ("cuda", "cpu"):
        model = F5TTS(F5Config(model=mcfg), device=device, dtype=torch.float32)
        model.load_params(params)
        mel = model.cfm.sample(
            cond.to(device), ids.to(device), torch.tensor([dur]), torch.tensor([ref_len]),
            steps=4, cfg_strength=2.0, sway_sampling_coef=-1.0, noise=noise,
        )
        gen = mel[:, ref_len:dur].transpose(1, 2)
        mels.append(gen.cpu())
        wavs.append(model._decode_mel(gen))
    mel_err = (mels[0] - mels[1]).abs().max().item()
    wav_err = float(abs(wavs[0] - wavs[1]).max())
    peak = float(abs(wavs[1]).max())
    emit({"phase": "reference", "mel_max_abs_err": mel_err, "mel_tol": 1e-3,
          "wav_max_abs_err": wav_err, "wav_tol": 1e-3 * peak, "wav_peak": peak})
    if not (mel_err <= 1e-3 and wav_err <= 1e-3 * peak and math.isfinite(peak) and peak > 0):
        raise AssertionError("card and CPU disagree on the small model")


def check_train_reference(torch) -> None:
    """One training step of a small f32 model: card (kernels) vs CPU (plain).

    Same seeded weights, batch and generator seed, so the same spans, times,
    noise and dropout masks. Tolerances: loss 1e-4 and gradient norm 1e-3
    relative (f32 sums in another order); the update (new − old parameters)
    1e-2 in relative L2 norm. Adam's first step is g/(|g| + 1e-8), which
    amplifies a difference of 1e-7 in a gradient near zero to the size of
    the step, so single elements may differ while the update as a whole
    agrees.
    """
    import numpy as np

    from oron_tts_tpu_torch.config import F5Config, ModelConfig
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    mcfg = ModelConfig(dim=256, depth=2, heads=4, text_dim=64, conv_layers=1, p_dropout=0.1)
    params = seeded_dit_params(mcfg, seed=3)
    rng = np.random.default_rng(4)
    batch = {
        "mel": rng.standard_normal((2, 100, 192)).astype(np.float32),
        "text_ids": rng.integers(0, 60, (2, 192)).astype(np.int32),
        "mel_lengths": np.asarray([192, 150], np.int32),
    }
    cfg = {"learning_rate": 1e-3, "warmup_steps": 0, "num_epochs": 1, "use_tqdm": False}
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for device in ("cuda", "cpu"):
            model = F5TTS(F5Config(model=mcfg), device=device, dtype=torch.float32)
            model.load_params(params)
            trainer = F5Trainer(cfg, model, [batch], log_dir=f"{tmp}/{device}/logs",
                                checkpoint_dir=f"{tmp}/{device}/ckpt")
            before = [p.cpu().clone() for p in trainer.state.params]
            m = trainer.train_step(batch, torch.Generator().manual_seed(11))
            update = torch.cat([(p.cpu() - b).flatten()
                                for p, b in zip(trainer.state.params, before)])
            results.append((m, update))
    (m_gpu, u_gpu), (m_cpu, u_cpu) = results
    loss_err = abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    norm_err = abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) / m_cpu["grad_norm"]
    upd_err = ((u_gpu - u_cpu).norm() / u_cpu.norm()).item()
    emit({"phase": "reference_train", "loss": m_gpu["loss"], "loss_rel_err": loss_err,
          "loss_tol": 1e-4, "grad_norm": m_gpu["grad_norm"], "grad_norm_rel_err": norm_err,
          "grad_norm_tol": 1e-3, "update_rel_l2_err": upd_err, "update_tol": 1e-2,
          "update_l2": u_cpu.norm().item(), "ok": [m_gpu["ok"], m_cpu["ok"]]})
    if not (m_gpu["ok"] and m_cpu["ok"] and loss_err <= 1e-4 and norm_err <= 1e-3
            and upd_err <= 1e-2 and u_cpu.norm().item() > 0):
        raise AssertionError("card and CPU disagree on one training step of the small model")


PROFILE_KINDS = (
    ("flash_lanes_bwd", ("lanes_bwd", "attn_delta")),
    ("gelu_dropout", ("gelu_dropout_kernel",)),
    ("flash_lanes", ("flash_lanes",)),
    ("grouped_conv", ("gconv_",)),
    ("fused_mel", ("log_mel_kernel",)),
    ("matmul", ("nvjet", "gemm", "gemv", "cutlass", "xmma", "cublas", "matmul")),
)


def profile_once(torch, synthesize) -> dict:
    """Device time by kernel kind and idle share of one traced synthesis."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synthesize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.device_time_total <= 0:
            continue
        low = ev.name.lower()
        kind = next((k for k, keys in PROFILE_KINDS if any(x in low for x in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ev.device_time_total / 1e6
        entry = by_name.setdefault(ev.name[:90], [0.0, 0])
        entry[0] += ev.device_time_total / 1e6
        entry[1] += 1
    busy = sum(by_kind.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "wall_s": wall, "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
        "device_s_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "device_kernels": sum(c for _, c in by_name.values()),
        "top_kernels": [{"name": n, "s": t, "launches": c} for n, (t, c) in top],
    }


def run_slice(torch, smi: str) -> dict[str, int]:
    import numpy as np

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.data.wav import write_wav
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd
    from oron_tts_tpu_torch.ops.fused_mel import log_mel_fused
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    kernels = (flash_lanes_fwd, grouped_conv1d_mish, log_mel_fused)
    cfg = F5Config()
    t0 = time.perf_counter()
    model = F5TTS(cfg)  # the card, bf16
    assert model.device.type == "cuda" and model.dtype == torch.bfloat16
    model.load_params(seeded_dit_params(cfg.model, seed=0))
    model.load_vocoder()
    n_params = sum(p.numel() for p in model.backbone.parameters())
    emit({"phase": "load", "seconds": time.perf_counter() - t0, "dit_params": n_params})
    model.synthesize(MN_TEXT, n_steps=2, seed=0)  # warm-up: cuBLAS handles, caches

    depth, steps = cfg.model.depth, 32
    totals = {k.__name__: 0 for k in kernels}
    with tempfile.TemporaryDirectory() as tmp:
        wav_ref = 0.3 * np.random.default_rng(0).standard_normal(5 * 24000).astype(np.float32)
        write_wav(Path(tmp) / "ref.wav", wav_ref, 24000, subtype="float32")
        modes = (("ref_free", {}),
                 ("voice_cloned", {"ref_audio_path": Path(tmp) / "ref.wav",
                                   "ref_text": REF_TEXT}))
        for mode, extra in modes:
            ids = model.text_cleaner.text_to_sequence(MN_TEXT, lang="mn")
            ref_len, ref_ids = 0, []
            if extra:
                ref_len = 1 + len(wav_ref) // cfg.audio.hop_length
                ref_ids = model.text_cleaner.text_to_sequence(REF_TEXT, lang="mn")
            target_len = model._target_len(MN_TEXT, ids, None, ref_len, ref_ids, 1.0)
            for k in kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav = model.synthesize(MN_TEXT, lang="mn", n_steps=steps, cfg_strength=2.0,
                                   sway_sampling_coef=-1.0, seed=0, **extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k.__name__: k.launches for k in kernels}
            rms = float(np.sqrt(np.mean(np.square(wav, dtype=np.float64))))
            audio_s = len(wav) / cfg.audio.sample_rate
            emit({"phase": "slice", "mode": mode, "letters": len(MN_TEXT.replace(" ", "")),
                  "target_frames": target_len, "bucket": model._bucket(ref_len + target_len),
                  "samples": len(wav), "rms": rms, "wall_s": wall, "audio_s": audio_s,
                  "rtf": wall / audio_s, "launches": counts, "card": smi})
            want = {"flash_lanes_fwd": steps * depth, "grouped_conv1d_mish": steps * 2,
                    "log_mel_fused": 1 if extra else 0}
            if counts != want:
                raise AssertionError(f"{mode}: launches {counts}, expected {want}")
            if len(wav) != target_len * cfg.audio.hop_length:
                raise AssertionError(f"{mode}: {len(wav)} samples for {target_len} frames")
            if not (np.isfinite(wav).all() and rms > 0):
                raise AssertionError(f"{mode}: output not finite or silent")
            for name, n in counts.items():
                totals[name] += n
        # after the counts were read: one traced synthesis of each kind
        for mode, extra in modes:
            emit({"phase": "profile", "mode": mode, "card": smi, **profile_once(
                torch, lambda: model.synthesize(MN_TEXT, lang="mn", n_steps=steps,
                                                cfg_strength=2.0, sway_sampling_coef=-1.0,
                                                seed=0, **extra))})
    return totals


def run_train(torch, smi: str) -> dict[str, int]:
    """F5Trainer at the Base width, bf16, batches of [12, 2048] frames."""
    import numpy as np

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.data.dataset import FixedBatchSampler, TTSCollator, TTSDataset
    from oron_tts_tpu_torch.data.loader import DataLoader
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.flash_attention import (
        flash_lanes_bwd,
        flash_lanes_fwd,
        flash_lanes_fwd_stats,
    )
    from oron_tts_tpu_torch.ops.gelu_dropout import gelu_dropout_bwd, gelu_dropout_fwd
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    kernels = (flash_lanes_fwd, flash_lanes_fwd_stats, flash_lanes_bwd, gelu_dropout_fwd,
               gelu_dropout_bwd, grouped_conv1d_mish)
    cfg = F5Config()  # Base: dim 1024, depth 22, heads 16, p_dropout 0.1, no remat
    depth = cfg.model.depth
    config = {"learning_rate": 1e-4, "warmup_steps": 2, "num_epochs": 4, "use_tqdm": False,
              "log_interval": 1, "max_checkpoints": 1, "seed": 0}

    t0 = time.perf_counter()
    rng = np.random.default_rng(6)
    hop = cfg.audio.hop_length
    arrays = [(0.3 * rng.standard_normal((f - 1) * hop, dtype=np.float32))
              for f in train_clip_frames()]
    dataset = TTSDataset(audio_arrays=arrays, texts=[MN_TEXT] * len(arrays),
                         sample_rate=cfg.audio.sample_rate, n_mels=cfg.audio.n_mels)
    loader = DataLoader(dataset, FixedBatchSampler(len(dataset), TRAIN_B, shuffle=False),
                        TTSCollator(pad_to_multiple=64), num_workers=2)
    model = F5TTS(cfg)  # the card, bf16
    assert model.device.type == "cuda" and model.dtype == torch.bfloat16
    model.load_params(seeded_dit_params(cfg.model, seed=0))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = F5Trainer(config, model, loader, log_dir=f"{tmp}/logs",
                            checkpoint_dir=f"{tmp}/ckpt")
        emit({"phase": "train_setup", "seconds": time.perf_counter() - t0,
              "clips": len(dataset), "clip_seconds": [round(len(a) / 24000, 2) for a in arrays][:4],
              "dit_params": model.num_params()})
        watched = (0, 1, 2, -3, -2, -1)  # time embedding ... output projection
        before = [trainer.state.params[i].clone() for i in watched]
        ema_before = [trainer.state.ema[i].clone() for i in watched]

        # warm-up: one epoch (two optimizer steps) through the trainer's own loop
        torch.cuda.reset_peak_memory_stats()
        warm_loss = trainer.train_epoch(total_epochs=config["num_epochs"])
        torch.cuda.synchronize()
        emit({"phase": "train_warmup", "steps": trainer.global_step, "avg_loss": warm_loss})
        if trainer.global_step != 2 or not math.isfinite(warm_loss):
            raise AssertionError("the warm-up epoch did not take two finite steps")

        totals = {k.__name__: 0 for k in kernels}
        want = {"flash_lanes_fwd": 0, "flash_lanes_fwd_stats": depth, "flash_lanes_bwd": depth,
                "gelu_dropout_fwd": depth, "gelu_dropout_bwd": depth,
                "grouped_conv1d_mish": 2}
        step_ms = []
        for epoch in (1, 2):
            loader.batch_sampler.set_epoch(epoch)
            generator = torch.Generator().manual_seed(config["seed"] + epoch)
            for batch in loader:
                shape = tuple(batch["mel"].shape)
                frames = int(batch["mel_lengths"].sum())
                for k in kernels:
                    k.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = trainer.train_step(batch, generator)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = {k.__name__: k.launches for k in kernels}
                step_ms.append(ms)
                emit({"phase": "train", "step": trainer.state.step, "batch": list(shape),
                      "mel_frames": frames, "loss": m["loss"], "grad_norm": m["grad_norm"],
                      "ok": m["ok"], "step_ms": ms, "frames_per_s": frames / ms * 1e3,
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": counts, "card": smi})
                if shape != (TRAIN_B, cfg.audio.n_mels, TRAIN_T):
                    raise AssertionError(f"batch shape {shape}")
                if not (m["ok"] and math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
                    raise AssertionError(f"step not finite: {m}")
                if counts != want:
                    raise AssertionError(f"launches {counts}, expected {want}")
                for name, n in counts.items():
                    totals[name] += n
        moved = all(not torch.equal(trainer.state.params[i], b) for i, b in zip(watched, before))
        ema_moved = all(not torch.equal(trainer.state.ema[i], b)
                        for i, b in zip(watched, ema_before))
        emit({"phase": "train_summary", "steps": len(step_ms), "step_ms_mean": sum(step_ms) / len(step_ms),
              "step_ms_min": min(step_ms), "params_moved": moved, "ema_moved": ema_moved,
              "optimizer_steps": trainer.state.step, "card": smi})
        if not (moved and ema_moved and trainer.state.step == 6):
            raise AssertionError("parameters or EMA did not move")

        # after the counts were read: one traced step
        batch = next(iter(loader))
        generator = torch.Generator().manual_seed(99)
        emit({"phase": "profile", "mode": "train_step", "card": smi,
              **profile_once(torch, lambda: trainer.train_step(batch, generator))})

        # a checkpoint written, read back, and compared
        t0 = time.perf_counter()
        path = trainer.save_checkpoint(loss=m["loss"])
        trainer.checkpoint_manager.wait()
        wrote = time.perf_counter() - t0
        st = trainer.state
        probes = (st.params[-3], st.ema[5], st.mu[7], st.nu[-3])
        keep = [t.clone() for t in probes]
        step, count = trainer.global_step, st.count
        for t in probes:
            t.zero_()
        t0 = time.perf_counter()
        trainer.load_checkpoint()  # copies into the same tensors
        same = all(torch.equal(k, t) for k, t in zip(keep, probes))
        emit({"phase": "train_checkpoint", "file": path.name, "bytes": path.stat().st_size,
              "write_s": wrote, "read_s": time.perf_counter() - t0, "restored_equal": same,
              "step": trainer.global_step})
        if not (same and trainer.global_step == step and trainer.state.count == count):
            raise AssertionError("the checkpoint did not read back what was written")
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from oron_tts_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [str(p.relative_to(_build.BUILD_DIR.parents[1])) for p in libs.values()]})

    rows = check_kernels(torch, F)
    check_reference(torch)
    check_train_reference(torch)
    launches = run_slice(torch, smi)
    torch.cuda.empty_cache()
    for name, n in run_train(torch, smi).items():
        launches[name] = launches.get(name, 0) + n
    emit({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches[row["name"]]}
        | {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}
        | {"library": row.get("library")}
        for row in rows
    ], "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
