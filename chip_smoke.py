#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis, training, serving and attention slices on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. build: ``nvcc`` builds every kernel of ``oron_tts_tpu_torch/csrc`` into
   ``build/torch_kernels/`` (one process per source, in parallel).
3. kernels: each kernel against its plain PyTorch version on the card at
   the slice's shapes, with its time, the plain version's, a PyTorch
   library call's where one computes the same function, and its bound;
   the classic-layout kernels also at small shapes (f32 and bf16, head
   widths 32, 48 and 64, a ``kv_len = 0`` row, odd H), the lanes kernels at
   head width 32 and the grouped conv at group widths 16, 32 and 128.
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
8. reference_serve: the small f32 model with int8 weights (``int8`` through
   the w8a16 kernel, ``int8_dynamic``) on the card against the CPU.
9. batch_knee: the per-row time of one ``synthesize_batch`` solve at 1 to 8
   rows of 832 frames (Base, bf16, 8 steps), the sweep
   ``F5TTS.GROUP_FRAME_BUDGET`` was set from (an earlier sweep also ran 16
   rows and rows of 1,600 frames; PERF.md keeps its readings).
10. serve: the HTTP server (``cli/serve.py``) in this process on 127.0.0.1 at
    the Base width, from a seeded checkpoint written to a temporary
    directory, three times: bf16, ``--quantize int8`` and ``--profile fast``.
    Each answers /healthz, a ref-free /synthesize, eight concurrent
    /synthesize that merge into one solve (each held against its solo
    audio), a voice-cloned request, a /synthesize_batch of four, a
    /synthesize_stream of three chunks (held against /synthesize; time to
    first audio), a 429 from a full queue and a drain. The int8 server's
    launch counts are zeroed before its requests and read after them, and
    one merged solve of each server is traced by ``torch.profiler``.
11. classic: the Base DiT rebuilt with ``attn_impl`` "flash" and "packed"
    from the seeded tree: ``CFM.sample`` + the vocoder under ``bench.py``'s
    protocol (120 letters, 1,560 frames, bucket 1,600, 32 steps, CFG 2) with
    the noise of a lanes solve, held against it; five ``F5Trainer`` steps on
    "flash" at ``[12, 2048]`` (two warm-up, three timed), the first step's
    loss held against the lanes model's on the same batch and generator
    seed; then ``cli.bench_attention --t 1664 --backward`` and
    ``cli.bench_model_ablation`` as a user runs them. Launch counts are
    zeroed before each piece and read after it.
12. widths: ``F5TTS.synthesize`` at ``configs/local.yaml``'s width (the
    Small config: dim 512, the conv kernel at group width 32) and two
    ``cli.train`` epochs on ``configs/test.yaml`` (head width 32 through the
    lanes kernels, the conv through ``F.conv1d``), both on the card.

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
SERVE_STEPS = 32
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
        key = row.get("tol_on", "max_abs_err")
        if not row[key] <= row["tol"]:
            raise AssertionError(f"{row['name']} ({row['dtype']}) off by {row[key]} ({key})")

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
    return (rows + check_train_kernels(torch, F, report) + check_qmm(torch, F, report)
            + check_classic_kernels(torch, F, report))


CLASSIC_SRC = "oron_tts_tpu_torch/csrc/flash_classic.cu"
# bench.py's synthesis protocol: 120 letters, 1,560 frames; its comment says
# "bucketed to 1664", its arithmetic (and the facade's multiple of 64) 1,600
SYNTH_LETTERS, SYNTH_STEPS = 120, 32


def grad_errors(got, refs, rel_tol) -> dict:
    """Each gradient's max |error| and its tolerance, rel_tol of its reference's max.

    ``max_rel_err`` is the largest error over its reference's max, held to
    ``rel_tol``; ``max_abs_err`` is the largest error.
    """
    names = ("dq", "dk", "dv")
    errs = {n: (a.float() - r.float()).abs().max().item() for n, a, r in zip(names, got, refs)}
    tops = {n: r.float().abs().max().item() for n, r in zip(names, refs)}
    return {**errs, **{n + "_tol": rel_tol * tops[n] for n in names},
            "max_abs_err": max(errs.values()),
            "max_rel_err": max(errs[n] / tops[n] for n in names),
            "tol": rel_tol, "tol_on": "max_rel_err"}


def check_classic_kernels(torch, F, report) -> list[dict]:
    """Kernels 6, 7, 8 and 12 against their plain versions, and the two repairs.

    Tolerances as for the lanes kernels: forwards 5e-3 absolute in bf16 (the
    plain version in f32 on the same rounded inputs: the error is P rounded
    to bf16 and one output rounding), gradients 1e-2 of each reference's
    largest value in bf16; f32 forwards 1e-5 absolute and f32 gradients 1e-5
    of the largest value (sums in another order).
    """
    from oron_tts_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_packed,
        flash_attention_plain,
        flash_lanes_bwd,
        flash_lanes_bwd_plain,
        flash_lanes_fwd,
        flash_lanes_fwd_stats,
        flash_lanes_fwd_stats_plain,
        flash_nosm,
        flash_nosm_plain,
    )
    from oron_tts_tpu_torch.ops.grouped_conv import (
        grouped_conv1d_mish,
        grouped_conv1d_mish_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = []
    bf16, f32 = torch.bfloat16, torch.float32
    fwd_tol = {bf16: 5e-3, f32: 1e-5}
    grad_tol = {bf16: 1e-2, f32: 1e-5}

    def qkv(shape, dtype, n=3):
        return [torch.randn(*shape, generator=gen, device=dev).to(dtype) for _ in range(n)]

    def lens_of(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def kept_keys(lens, T):
        return float(lens.clamp(min=0, max=T).sum())

    def sdpa_mask(lens, T):
        return (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]

    # kernel 6 (and 8) at small shapes: f32 and bf16, D 32/48/64, exp and
    # exp2, a kv_len = 0 row (every key weighs 1/T), odd H for the packed one
    for dtype in (f32, bf16):
        for D in (32, 48, 64):
            for H in (3, 4):
                q, k, v = qkv((2, H, 200, D), dtype)
                lens = lens_of([137, 0])
                for name, got, ref in (
                    ("flash_attention", flash_attention(q, k, v, kv_lens=lens),
                     flash_attention_plain(q.float(), k.float(), v.float(), kv_lens=lens)),
                    ("flash_attention", flash_attention(q, k, v, kv_lens=lens, use_exp2=False),
                     flash_attention_plain(q.float(), k.float(), v.float(), kv_lens=lens,
                                           use_exp2=False)),
                    ("flash_attention", flash_attention(q, k, v),
                     flash_attention_plain(q.float(), k.float(), v.float())),
                    ("flash_attention_packed", flash_attention_packed(q, k, v, kv_lens=lens),
                     flash_attention_plain(q.float(), k.float(), v.float(), kv_lens=lens)),
                ):
                    report({"name": name, "dtype": str(dtype), "shape": [2, H, 200, D],
                            "kv_lens": [137, 0],
                            "max_abs_err": (got.float() - ref).abs().max().item(),
                            "tol": fwd_tol[dtype]})

    # kernel 7 at small shapes, the kv_len = 0 row's gradients non-zero
    for dtype in (f32, bf16):
        for D in (32, 48, 64):
            q, k, v, do = qkv((2, 4, 200, D), dtype, 4)
            lens = lens_of([137, 0])
            out = flash_attention(q, k, v, kv_lens=lens)
            got = flash_attention_bwd(q, k, v, lens, out, do)
            refs = flash_attention_bwd_plain(q.float(), k.float(), v.float(), lens,
                                             out.float(), do.float())
            empty_row = min(g[1].float().abs().max().item() for g in got)
            report({"name": "flash_attention_bwd", "dtype": str(dtype),
                    "shape": [2, 4, 200, D], "kv_lens": [137, 0],
                    **grad_errors(got, refs, grad_tol[dtype]),
                    "kv_len_0_row_min_grad_max": empty_row})
            if not empty_row > 0:
                raise AssertionError("flash_attention_bwd: the kv_len = 0 row has a zero gradient")

    def nosm_row(q, k, v) -> dict:
        """Kernel 12's error. Its output is not an average (no softmax): in
        bf16 it reaches ~3, where one output rounding is 2^-8 of the value,
        so the error beyond that rounding is what is held to 5e-3."""
        ref = flash_nosm_plain(q.float(), k.float(), v.float())
        diff = (flash_nosm(q, k, v).float() - ref).abs()
        half_step = 2.0 ** -8 if q.dtype == bf16 else 0.0
        return {"name": "flash_nosm", "dtype": str(q.dtype), "shape": list(q.shape),
                "max_abs_err": diff.max().item(), "ref_max": ref.abs().max().item(),
                "max_excess": (diff - half_step * ref.abs()).max().item(),
                "tol": fwd_tol[q.dtype], "tol_on": "max_excess"}

    # kernel 12 small, f32 and bf16
    for dtype in (f32, bf16):
        report(nosm_row(*qkv((2, 4, 200, 64), dtype)))

    # the synthesis shape: kernels 6, 8 and 12, timed, bf16
    B, H, T, D = 2, 16, 1664, 64
    q, k, v = qkv((B, H, T, D), bf16)
    lens = lens_of([SYNTH_LETTERS * 13] * B)
    kept = kept_keys(lens, T)
    nb = q.numel() * 2
    mask = sdpa_mask(lens, T)
    sdpa = sdpa_by_backend(torch, F, q, k, v, mask)
    best, best_ms = fastest(sdpa)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), kv_lens=lens)
    for name, fn, line in (
        ("flash_attention", lambda: flash_attention(q, k, v, kv_lens=lens), 32),
        ("flash_attention_packed", lambda: flash_attention_packed(q, k, v, kv_lens=lens), 246),
    ):
        b_ms, b_by = bound_ms(4.0 * T * D * H * kept, H100_BF16_FLOPS, 4 * nb + lens.numel() * 4)
        row = {"name": name, "dtype": str(bf16), "shape": [B, H, T, D], "kv_lens": lens.tolist(),
               "max_abs_err": (fn().float() - ref).abs().max().item(), "tol": 5e-3,
               "ms": cuda_ms(fn),
               "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, kv_lens=lens), iters=5),
               "library_ms": best_ms, "library": "SDPA " + best, "sdpa_ms_by_backend": sdpa,
               "bound_ms": b_ms, "bound_by": b_by, "route": "cuda", "source": CLASSIC_SRC,
               "replaces": f"oron_tts_tpu/ops/flash_attention.py:{line}"}
        rows.append(row)
        report(row)
    flash_exp_ms = cuda_ms(lambda: flash_attention(q, k, v, kv_lens=lens, use_exp2=False))
    emit({"phase": "kernel_variant", "name": "flash_attention", "use_exp2": False,
          "ms": flash_exp_ms, "shape": [B, H, T, D]})
    b_ms, b_by = bound_ms(4.0 * T * D * H * B * T, H100_BF16_FLOPS, 4 * nb)
    row = {**nosm_row(q, k, v),
           "ms": cuda_ms(lambda: flash_nosm(q, k, v)),
           "plain_ms": cuda_ms(lambda: flash_nosm_plain(q, k, v), iters=5),
           "library_ms": cuda_ms(lambda: torch.matmul(torch.matmul(q, k.transpose(-1, -2)), v)),
           "library": "torch.matmul(torch.matmul(q, k^T), v), two calls, 1/T left out",
           "bound_ms": b_ms, "bound_by": b_by, "route": "cuda", "source": CLASSIC_SRC,
           "replaces": "scripts/bench_attention.py:128"}
    rows.append(row)
    report(row)
    del q, k, v, ref

    # the training shape: kernel 7, timed, bf16, against SDPA's backward
    B, T = TRAIN_B, TRAIN_T
    q, k, v, do = qkv((B, H, T, D), bf16, 4)
    lens = lens_of(train_clip_frames()[:B])
    kept = kept_keys(lens, T)
    out = flash_attention(q, k, v, kv_lens=lens)
    got = flash_attention_bwd(q, k, v, lens, out, do)
    refs = flash_attention_bwd_plain(q.float(), k.float(), v.float(), lens, out.float(),
                                     do.float())
    errs = grad_errors(got, refs, 1e-2)
    del got, refs
    mask = sdpa_mask(lens, T)
    fwd_times = sdpa_by_backend(torch, F, q, k, v, mask)
    best, _ = fastest(fwd_times)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))
    with sdpa_kernel([getattr(SDPBackend, best)]):
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                      retain_graph=True), iters=5)
    del lib_out, qs, ks, vs
    b_ms, b_by = bound_ms(10.0 * T * D * H * kept, H100_BF16_FLOPS,
                          8 * q.numel() * 2 + lens.numel() * 4)
    row = {"name": "flash_attention_bwd", "dtype": str(bf16), "shape": [B, H, T, D],
           "kept_keys": kept, **errs,
           "ms": cuda_ms(lambda: flash_attention_bwd(q, k, v, lens, out, do), iters=5),
           "plain_ms": cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, lens, out, do), iters=3),
           "library_ms": lib_bwd, "library": "autograd backward of SDPA " + best,
           "bound_ms": b_ms, "bound_by": b_by, "route": "cuda",
           "source": "oron_tts_tpu_torch/csrc/flash_classic_bwd.cu",
           "replaces": "oron_tts_tpu/ops/flash_attention.py:749"}
    rows.append(row)
    report(row)
    del q, k, v, do, out
    torch.cuda.empty_cache()

    # repair: lanes forward, stats and backward at D = 32
    for dtype, (Bl, Tl, Hl) in ((f32, (2, 200, 2)), (bf16, (2, 200, 2)), (bf16, (2, 832, 16))):
        q, k, v, do = qkv((Bl, Tl, Hl * 32), dtype, 4)
        lens = lens_of([Tl, Tl - 63])
        out, lse = flash_lanes_fwd_stats(q, k, v, lens, Hl)
        ref_out, ref_lse = flash_lanes_fwd_stats_plain(q.float(), k.float(), v.float(), lens, Hl)
        same = torch.equal(out, flash_lanes_fwd(q, k, v, lens, Hl))
        got = flash_lanes_bwd(q, k, v, lens, out, do, lse, Hl)
        refs = flash_lanes_bwd_plain(q.float(), k.float(), v.float(), lens, out.float(),
                                     do.float(), lse, Hl)
        report({"name": "flash_lanes_fwd_stats", "dtype": str(dtype), "shape": [Bl, Tl, Hl * 32],
                "head_dim": 32, "out_bit_equal_to_fwd": same,
                "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
                "max_abs_err": (out.float() - ref_out).abs().max().item(), "tol": fwd_tol[dtype]})
        report({"name": "flash_lanes_bwd", "dtype": str(dtype), "shape": [Bl, Tl, Hl * 32],
                "head_dim": 32, **grad_errors(got, refs, grad_tol[dtype])})
        if not same:
            raise AssertionError("flash_lanes_fwd_stats and flash_lanes_fwd differ at D = 32")

    # repair: the grouped conv at group widths 16, 32 (the Small config) and 128
    for C, T in ((512, 832), (256, 200), (2048, 200)):
        for dtype, tol in ((f32, 1e-4), (bf16, 2e-2)):
            x = torch.randn(2, T, C, generator=gen, device=dev).to(dtype)
            w = (torch.randn(31, C // 16, C, generator=gen, device=dev)
                 / math.sqrt(31 * C // 16)).to(dtype)
            bias = 0.1 * torch.randn(C, generator=gen, device=dev)
            report({"name": "grouped_conv1d_mish", "dtype": str(dtype), "shape": [2, T, C],
                    "group_width": C // 16,
                    "max_abs_err": (grouped_conv1d_mish(x, w, bias, 16).float()
                                    - grouped_conv1d_mish_plain(x.float(), w.float(), bias, 16)
                                    ).abs().max().item(), "tol": tol})
    return rows


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


# the lanes and classic attention kernels share their device bodies
# (csrc/flash_fwd.cuh, flash_bwd.cuh) and so their names
PROFILE_KINDS = (
    ("attention_bwd", ("bwd_dkdv", "bwd_dq", "attn_delta")),
    ("gelu_dropout", ("gelu_dropout_kernel",)),
    ("attention_fwd", ("attn_fwd_",)),
    ("grouped_conv", ("gconv_",)),
    ("fused_mel", ("log_mel_kernel",)),
    ("quantized_matmul", ("qmm_",)),
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


QMM_SRC = "oron_tts_tpu_torch/csrc/qmm.cu"
BASE_PROJECTIONS = ((1024, 1024, 4), (1024, 4096, 1), (4096, 1024, 1))  # (K, N, per block)


def check_qmm(torch, F, report) -> list[dict]:
    """Kernel 9 (w8a16) against its plain version, and w8a8 against the CPU.

    Tolerances. The plain version runs in f32 on the same values and is not
    rounded. f32: 1e-5 of the largest output (sums of up to 4,096 products in
    another order). bf16: the kernel also sums in f32 and rounds once, at its
    output, so it may be off by that rounding, half a bf16 step (2^-8 of
    the value), beyond the f32 bound.
    """
    from oron_tts_tpu_torch.ops.quantized_matmul import (
        dequantize_weight,
        int8_product,
        quantize_activations,
        quantize_weight,
        quantized_matmul,
        quantized_matmul_plain,
        w8a8_matmul,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def case(m, k, n, dtype, timed=False, zero_col=False):
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        w = torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k)
        if zero_col:
            w[n // 2] = 0.0  # an all-zero output channel: its scale is 1
        w_q, scale = quantize_weight(w)
        out = quantized_matmul(x, w_q, scale)
        ref = quantized_matmul_plain(x.float(), w_q, scale)
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        top = ref.abs().max().item()
        if dtype == torch.bfloat16:
            excess = (diff - (2.0 ** -8) * ref.abs()).max().item()
        else:
            excess = diff.max().item()
        row = {"name": "quantized_matmul", "dtype": str(dtype), "shape": [m, k, n],
               "max_abs_err": diff.max().item(), "max_excess": excess, "tol": 1e-5 * top,
               "tol_on": "max_excess", "ref_max": top}
        if zero_col and not (scale[n // 2].item() == 1.0
                             and out[:, n // 2].abs().max().item() == 0.0):
            raise AssertionError("quantized_matmul: a zero channel must stay exactly zero")
        if timed:
            w_bf = w.to(dtype)
            deq = dequantize_weight(w_q, scale, dtype)
            b_ms, b_by = bound_ms(2.0 * m * k * n, H100_BF16_FLOPS,
                                  m * k * 2 + n * k + n * 4 + m * n * 2)
            row.update(
                ms=cuda_ms(lambda: quantized_matmul(x, w_q, scale)),
                plain_ms=cuda_ms(lambda: quantized_matmul_plain(x, w_q, scale), iters=5),
                library_ms=cuda_ms(lambda: torch.matmul(
                    x, dequantize_weight(w_q, scale, dtype).t())),
                library="dequantize to bf16 + torch.matmul",
                library_matmul_only_ms=cuda_ms(lambda: torch.matmul(x, deq.t())),
                linear_bf16_ms=cuda_ms(lambda: F.linear(x, w_bf)),
                bound_ms=b_ms, bound_by=b_by)
            row["tflops"] = 2.0 * m * k * n / row["ms"] / 1e9
        emit({"phase": "kernel", **row})
        if not excess <= row["tol"]:
            raise AssertionError(f"quantized_matmul {dtype} [{m},{k},{n}] off by {excess} "
                                 f"beyond its tolerance {row['tol']}")
        return row

    # ragged edges: M = 1 and 13, N = 40, K = 96, a zero channel
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in ((1, 96, 40), (13, 96, 40), (13, 1024, 1024), (200, 4096, 136)):
            case(m, k, n, dtype, zero_col=True)
    timed = {}
    for k, n, _ in BASE_PROJECTIONS:
        for m in (1664, 6144):
            case(m, k, n, torch.float32)
            timed[m, k, n] = case(m, k, n, torch.bfloat16, timed=True)

    # the row of the kernel table: the six projections of one block at
    # M = 1,664 (2 CFG rows x bucket 832), times and bounds summed
    block = [(timed[1664, k, n], count) for k, n, count in BASE_PROJECTIONS]
    row = {"name": "quantized_matmul", "dtype": "torch.bfloat16",
           "shape": "one block's six projections, M=1664",
           "max_abs_err": max(r["max_abs_err"] for r, _ in block),
           "bound_by": "operations", "route": "cuda", "source": QMM_SRC,
           "replaces": "oron_tts_tpu/ops/quantized_matmul.py:55",
           "library": "dequantize to bf16 + torch.matmul"}
    for key in ("ms", "plain_ms", "library_ms", "library_matmul_only_ms", "linear_bf16_ms",
                "bound_ms"):
        row[key] = sum(r[key] * count for r, count in block)
    if any(r["bound_by"] != "operations" for r, _ in block):
        raise AssertionError("a Base projection at M=1664 is not bound by operations")
    emit({"phase": "kernel_block", **row})

    # what torch._int_mm takes on this card (reported, not relied on: the port
    # asks int8_product, which falls back to an exact float64 product)
    probes = {}
    for m, k, n in ((17, 64, 64), (16, 64, 64), (32, 100, 64), (32, 64, 40), (32, 64, 44)):
        a = torch.ones(m, k, dtype=torch.int8, device=dev)
        b = torch.ones(n, k, dtype=torch.int8, device=dev)
        try:
            probes[f"{m}x{k}x{n}"] = bool((torch._int_mm(a, b.t()) == k).all().item())
        except RuntimeError as exc:  # a probe of the library's limits, printed
            probes[f"{m}x{k}x{n}"] = "refused: " + str(exc).splitlines()[0][:90]
    emit({"phase": "int_mm_probe", "accepted": probes})

    # w8a8 on the card against the CPU's result on the same values: the
    # int8 activations and the s32 product are exact on both, the f32 rescale
    # multiplies in the same order
    for m, k, n in ((1664, 1024, 4096), (13, 96, 40), (40, 100, 44)):
        x = torch.randn(m, k, generator=gen, device=dev)
        w_q, scale = quantize_weight(torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k))
        x_q = quantize_activations(x)[0]
        exact = (torch.equal(x_q.cpu(), quantize_activations(x.cpu())[0])
                 and torch.equal(int8_product(x_q, w_q).cpu(), int8_product(x_q.cpu(), w_q.cpu())))
        got = w8a8_matmul(x, w_q, scale)
        want = w8a8_matmul(x.cpu(), w_q.cpu(), scale.cpu())
        err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        emit({"phase": "w8a8", "shape": [m, k, n], "max_rel_err": err, "tol": 1e-6,
              "integers_equal_to_cpu": exact})
        if not (err <= 1e-6 and exact):
            raise AssertionError(f"w8a8_matmul on the card differs from the CPU: {err}")
    times = {}
    for k, n, _ in BASE_PROJECTIONS:
        x = torch.randn(1664, k, generator=gen, device=dev).to(torch.bfloat16)
        w_q, scale = quantize_weight(torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k))
        x_q = quantize_activations(x)[0]
        times[f"{k}x{n}"] = {
            "w8a8_matmul_ms": cuda_ms(lambda: w8a8_matmul(x, w_q, scale)),
            "int8_product_only_ms": cuda_ms(lambda: int8_product(x_q, w_q)),
            "linear_bf16_ms": timed[1664, k, n]["linear_bf16_ms"]}
    emit({"phase": "w8a8_time", "m": 1664, "dtype": "torch.bfloat16", "by_shape": times})
    return [row]


def check_reference_serve(torch) -> None:
    """Small f32 model with int8 weights: card (kernel) against CPU (plain).

    Same weights, same injected noise. ``int8`` repeats the unquantized
    reference's arithmetic with exact integers: mel within 1e-3 of its largest
    value. Under
    ``int8_dynamic`` an activation next to a rounding boundary may land on
    the neighbouring integer on the two devices (1/127 of its token's
    largest value), so the mel is held to 2e-2 of its largest value.
    """
    from oron_tts_tpu_torch.config import F5Config, ModelConfig
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.quantized_matmul import quantized_matmul
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    mcfg = ModelConfig(dim=256, depth=2, heads=4, text_dim=64, conv_layers=1)
    params = seeded_dit_params(mcfg, seed=1)
    rng = torch.Generator().manual_seed(2)
    B, T = 2, 192
    durs, refs = [170, 121], [40, 0]
    cond = torch.zeros(B, T, 100)
    cond[0, :40] = torch.randn(40, 100, generator=rng)
    ids = torch.randint(1, 64, (B, T), generator=rng)
    for b, d in enumerate(durs):
        ids[b, d:] = -1
    noise = torch.randn(B, T, 100, generator=rng)
    for mode, tol in (("int8", 1e-3), ("int8_dynamic", 2e-2)):
        mels = []
        for device in ("cuda", "cpu"):
            model = F5TTS(F5Config(model=mcfg), device=device, dtype=torch.float32)
            model.load_params(params)
            model.quantize_for_serving(mode)
            quantized_matmul.launches = 0
            mels.append(model.cfm.sample(
                cond.to(device), ids.to(device), torch.tensor(durs), torch.tensor(refs),
                steps=4, cfg_strength=2.0, sway_sampling_coef=-1.0, noise=noise,
                cfg_interval=(0.1, 0.7), method="midpoint").cpu())
            if device == "cuda":
                launches = quantized_matmul.launches
        err = (mels[0] - mels[1]).abs().max().item()
        top = mels[1].abs().max().item()
        emit({"phase": "reference_serve", "mode": mode, "mel_max_abs_err": err,
              "mel_tol": tol * top, "mel_max": top, "kernel_launches_on_card": launches})
        # 4 midpoint steps = 8 forwards of 2 blocks x 6 projections
        if not (err <= tol * top and launches == (96 if mode == "int8" else 0)):
            raise AssertionError(f"card and CPU disagree on the small {mode} model")


def serve_params(cfg) -> dict:
    """Seeded Base weights with the text blocks' GRN ``gamma`` at zero, as at initialisation.

    That GRN normalises by a sum over the whole padded sequence (in the JAX
    package and upstream alike), so with a non-zero ``gamma`` a row feels
    how much padding its bucket adds and "merged equals solo" cannot hold
    across buckets for any implementation. ``run_batch_knee`` reports how
    large that effect is on the unmodified seeded weights.
    """
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    params = seeded_dit_params(cfg.model, seed=0)
    for name, block in params["text_embed"].items():
        if name.startswith("block"):
            block["grn"]["gamma"][...] = 0.0
    return params


def letters(n: int, salt: int = 0) -> str:
    """A text of exactly ``n`` Mongolian letters in short words (``13 n`` target frames)."""
    alphabet = "абвгдеёжзийклмноөпрстуүфхцчшыэюя"
    out, i = [], salt
    while sum(len(w) for w in out) < n:
        size = min(3 + (i * 7 + salt) % 5, n - sum(len(w) for w in out))
        out.append("".join(alphabet[(i * 11 + j * 5 + salt) % len(alphabet)] for j in range(size)))
        i += 1
    return " ".join(out)


def run_batch_knee(torch, smi: str) -> None:
    """Per-row solve time of ``synthesize_batch`` against rows x bucket (Base, bf16)."""
    import numpy as np

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    cfg = F5Config()
    model = F5TTS(cfg)
    model.load_params(seeded_dit_params(cfg.model, seed=0))
    model.load_vocoder()
    budget = F5TTS.GROUP_FRAME_BUDGET
    F5TTS.GROUP_FRAME_BUDGET = 1 << 30  # the sweep looks past the constant it informs
    points = []
    try:
        model.synthesize_batch([letters(64)], n_steps=2, seed=0, max_chars_per_chunk=0)
        # the 16-row point and the 1,600-frame rows are left out to keep the
        # script under ten minutes (PERF.md keeps their earlier readings)
        for n_letters, bucket, row_counts in ((64, 832, (1, 2, 4, 8)),):
            for rows in row_counts:
                texts = [letters(n_letters, salt=r) for r in range(rows)]
                best = None
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    wavs = model.synthesize_batch(texts, n_steps=8, seed=0, max_batch=rows,
                                                  max_chars_per_chunk=0)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                if any(len(w) != n_letters * 13 * cfg.audio.hop_length for w in wavs):
                    raise AssertionError("batch_knee: a row has the wrong length")
                points.append({"rows": rows, "bucket": bucket, "frames": rows * bucket,
                               "solve_s": best, "per_row_s": best / rows,
                               "per_row_frame_us": best / rows / bucket * 1e6})
        # how much a row feels its bucket on the unmodified seeded weights
        # (the text blocks' GRN sums over the padding too): one text at its
        # own bucket and padded to 1,600 frames
        text = letters(64)
        own = model.synthesize_mel(text, n_steps=8, seed=0)
        model.pad_to_multiple = 1600
        wide = model.synthesize_mel(text, n_steps=8, seed=0)
        model.pad_to_multiple = 64
        leak = float(np.linalg.norm(own - wide) / np.linalg.norm(own))
    finally:
        F5TTS.GROUP_FRAME_BUDGET = budget
    emit({"phase": "batch_knee", "steps": 8, "points": points, "group_frame_budget": budget,
          "bucket_leak_rel_l2_seeded_weights": leak, "card": smi})
    del model
    torch.cuda.empty_cache()


def http_post(port: int, path: str, payload: dict, timeout: float = 600.0):
    """(status, headers, body) of one POST to the server in this process."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read()


def http_health(port: int) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


# Waveforms of two runs that should be "the same" are compared by the relative
# L2 distance. In f32 that is rounding (2e-5 on the CPU). In bf16 a merged
# solve runs its matmuls at another M than the solo solve, the library picks
# other tilings, sums round elsewhere in bf16, 32 steps x 22 blocks carry that
# along and the vocoder's phase head amplifies it: this script read 0.009 to
# 0.046 over 24 requests on an H100 (PERF.md); the bound leaves 3x room.
MERGED_REL_L2_TOL = 0.15
# chunks solved at the same shapes on both routes: equal up to PCM16 rounding
STREAM_ABS_TOL = 1e-4
# mel of a quantized model against the bf16 model's, same seed, relative L2:
# the JAX package's own bounds for its small f32 model
# (tests/test_quantized.py: 0.01 for int8, 0.03 for int8_dynamic), which the
# Base model in bf16 over 32 steps also keeps (0.0017 and 0.0018 measured)
QUANT_MEL_REL_L2_TOL = {"int8": 0.01, "fast": 0.03}


def rel_l2(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def run_serve(torch, smi: str) -> dict[str, int]:
    """The HTTP server at the Base width: bf16, ``--quantize int8``, ``--profile fast``."""
    import base64
    import http.client
    import threading

    import numpy as np

    from oron_tts_tpu_torch.cli import serve
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.data.wav import read_wav_bytes, wav_bytes
    from oron_tts_tpu_torch.models.f5tts import F5TTS, split_text_for_synthesis
    from oron_tts_tpu_torch.ops.flash_attention import flash_lanes_fwd
    from oron_tts_tpu_torch.ops.fused_mel import log_mel_fused
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.ops.quantized_matmul import quantized_matmul
    from oron_tts_tpu_torch.train.checkpoint import flatten_tree, write_npz

    kernels = (flash_lanes_fwd, grouped_conv1d_mish, log_mel_fused, quantized_matmul)
    cfg = F5Config()
    depth, hop, rate = cfg.model.depth, cfg.audio.hop_length, cfg.audio.sample_rate
    eight = [letters(60 + i % 5, salt=i) for i in range(8)]  # 780-832 frames: bucket 832
    seeds = [11 + 3 * i for i in range(8)]
    # three chunks (1,274, 871 and 455 frames) whose lengths lie too far apart
    # to share a group, so that the stream and /synthesize solve each chunk at
    # the same shape and can be held to each other sample by sample
    paragraph = f"{letters(97, 1)}. {letters(66, 2)}. {letters(34, 3)}."
    chunk_frames = [13 * len(c.replace(" ", "")) for c in split_text_for_synthesis(paragraph, 120)]
    if len(chunk_frames) != 3 or any(len(g) != 1 for g in F5TTS._length_groups(
            chunk_frames, 64, 16)):
        raise AssertionError(f"the stream's paragraph no longer gives three lone chunks: "
                             f"{chunk_frames}")
    wav_ref = 0.3 * np.random.default_rng(0).standard_normal(5 * rate).astype(np.float32)
    ref_b64 = base64.b64encode(wav_bytes(wav_ref, rate, subtype="float32")).decode()
    totals = {k.__name__: 0 for k in kernels}
    bf16_mels: dict[str, np.ndarray] = {}

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_npz(Path(tmp) / "f5tts_step_00000001.npz",
                  flatten_tree({"params": serve_params(cfg)}))
        (Path(tmp) / "config.json").write_text("{}")  # every default: the Base model
        emit({"phase": "serve_checkpoint", "seconds": time.perf_counter() - t0,
              "bytes": (Path(tmp) / "f5tts_step_00000001.npz").stat().st_size})

        for mode, flags in (("bf16", []), ("int8", ["--quantize", "int8"]),
                            ("fast", ["--profile", "fast"])):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            server = serve.create_server(["--checkpoint", tmp, "--port", "0", "--warmup",
                                          "--max-queue", "8", *flags])
            service, port = server.service, server.server_address[1]
            model = service.model
            loop = threading.Thread(target=server.serve_forever, name="serve-forever")
            loop.start()
            if not (model.device.type == "cuda" and model.dtype == torch.bfloat16
                    and model.config.model.dim == 1024 and model.config.model.depth == 22):
                raise AssertionError("the server did not load the Base model in bf16 on the card")
            for k in kernels:
                k.launches = 0
            code, health = http_health(port)
            if code != 200 or health["status"] != "ok" or health["device"] != "cuda":
                raise AssertionError(f"{mode}: /healthz said {code} {health}")
            report = {"phase": "serve", "mode": mode, "card": smi,
                      "start_s": time.perf_counter() - t0,
                      "weight_bytes": model.weight_bytes(), "params": health["params"]}

            def post_wav(payload: dict) -> tuple[np.ndarray, float]:
                t = time.perf_counter()
                status, headers, body = http_post(port, "/synthesize", payload)
                dt = time.perf_counter() - t
                if status != 200 or headers.get("Content-Type") != "audio/wav":
                    raise AssertionError(f"{mode}: /synthesize said {status} {body[:200]!r}")
                wav, sr = read_wav_bytes(body)
                if sr != rate or not (np.isfinite(wav).all() and float(np.abs(wav).max()) > 0):
                    raise AssertionError(f"{mode}: /synthesize returned no sound")
                return wav, dt

            # one ref-free request, alone
            before = quantized_matmul.launches
            wav, dt = post_wav({"text": MN_TEXT, "seed": 0, "steps": SERVE_STEPS})
            qmm_solo = quantized_matmul.launches - before
            if len(wav) != len(MN_TEXT.replace(" ", "")) * 13 * hop:
                raise AssertionError(f"{mode}: {len(wav)} samples, not 13 frames a letter")
            report["solo"] = {"latency_s": dt, "audio_s": len(wav) / rate,
                              "rtf": dt / (len(wav) / rate), "qmm_launches": qmm_solo}

            # eight solo answers, then the same eight at once: one merged solve
            solo = [post_wav({"text": t, "seed": s, "steps": SERVE_STEPS})
                    for t, s in zip(eight, seeds)]
            merged_before = http_health(port)[1]["merged_batches"]
            before = quantized_matmul.launches
            with service.model_lock:  # a busy device: the requests queue behind it
                first = threading.Thread(target=http_post, args=(
                    port, "/synthesize", {"text": "за", "seed": 1, "steps": 2}))
                first.start()
                time.sleep(0.3)  # the dispatcher has taken it and waits for the lock
                results: list = [None] * 8

                def one(i: int) -> None:
                    results[i] = post_wav({"text": eight[i], "seed": seeds[i],
                                           "steps": SERVE_STEPS})

                pending = [threading.Thread(target=one, args=(i,)) for i in range(8)]
                for th in pending:
                    th.start()
                deadline = time.monotonic() + 60
                while service.batcher._queued < 8 and time.monotonic() < deadline:
                    time.sleep(0.01)
                queued = service.batcher._queued
                torch.cuda.synchronize()
                t_release = time.perf_counter()
            first.join(timeout=600)
            for th in pending:
                th.join(timeout=600)
            merged_s = time.perf_counter() - t_release
            if queued != 8 or any(r is None for r in results) or first.is_alive():
                raise AssertionError(f"{mode}: the eight requests did not all queue and return")
            merged_batches = http_health(port)[1]["merged_batches"] - merged_before
            devs = [rel_l2(got[0], want[0]) for got, want in zip(results, solo)]
            report["merged"] = {
                "requests": 8, "bucket": 832, "merged_batches": merged_batches,
                "wall_s_after_release": merged_s, "per_row_s": merged_s / 8,
                "solo_latency_s_mean": sum(d for _, d in solo) / 8,
                "rel_l2_vs_solo_max": max(devs), "rel_l2_vs_solo": devs,
                "tol": MERGED_REL_L2_TOL,
                "qmm_launches": quantized_matmul.launches - before,
            }
            if merged_batches < 1:
                raise AssertionError(f"{mode}: no merged batch")
            if any(g[0].shape != w[0].shape for g, w in zip(results, solo)) or not (
                    max(devs) <= MERGED_REL_L2_TOL):
                raise AssertionError(f"{mode}: a merged request differs from its solo audio: "
                                     f"{devs}")

            # the solve itself, without HTTP and queueing: eight rows against one
            with service.model_lock:
                timing = {}
                for name, texts_, seeds_ in (("rows8", eight, seeds), ("rows1", eight[:1], seeds[:1])):
                    best = None
                    for _ in range(2):
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        model.synthesize_batch(texts_, seeds=seeds_, n_steps=SERVE_STEPS,
                                               **service.profile_defaults)
                        torch.cuda.synchronize()
                        dt = time.perf_counter() - t
                        best = dt if best is None else min(best, dt)
                    timing[name + "_solve_s"] = best
            timing["per_row_s"] = timing["rows8_solve_s"] / 8
            report["merged_solve"] = timing

            # a voice-cloned request (base64 reference)
            wav, dt = post_wav({"text": MN_TEXT, "seed": 0, "steps": SERVE_STEPS,
                                "ref_audio_b64": ref_b64, "ref_text": REF_TEXT})
            report["cloned"] = {"latency_s": dt, "audio_s": len(wav) / rate,
                                "rtf": dt / (len(wav) / rate)}

            # /synthesize_batch of four texts
            t = time.perf_counter()
            status, _, body = http_post(port, "/synthesize_batch", {
                "texts": eight[:4], "seed": 5, "steps": SERVE_STEPS})
            dt = time.perf_counter() - t
            wavs = [read_wav_bytes(base64.b64decode(b))[0]
                    for b in json.loads(body)["wavs_base64"]] if status == 200 else []
            if status != 200 or [len(w) for w in wavs] != [
                    len(t_.replace(" ", "")) * 13 * hop for t_ in eight[:4]]:
                raise AssertionError(f"{mode}: /synthesize_batch said {status}")
            audio = sum(len(w) for w in wavs) / rate
            report["batch4"] = {"latency_s": dt, "audio_s": audio, "rtf": dt / audio}

            # /synthesize_stream: time to the first audio bytes, total, and the
            # joined pieces against /synthesize
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            payload = json.dumps({"text": paragraph, "seed": 7, "steps": SERVE_STEPS})
            t = time.perf_counter()
            conn.request("POST", "/synthesize_stream", body=payload)
            resp = conn.getresponse()
            head = resp.read(44 + 2)  # the WAV header and the first sample
            ttfa = time.perf_counter() - t
            streamed = head + resp.read()
            total = time.perf_counter() - t
            conn.close()
            whole, whole_s = post_wav({"text": paragraph, "seed": 7, "steps": SERVE_STEPS})
            got = read_wav_bytes(streamed)[0]
            dev = float(np.abs(got - whole).max()) if got.shape == whole.shape else float("inf")
            report["stream"] = {"chunk_frames": chunk_frames, "ttfa_s": ttfa, "total_s": total,
                                "synthesize_s": whole_s, "audio_s": len(whole) / rate,
                                "max_abs_dev_vs_synthesize": dev, "tol": STREAM_ABS_TOL}
            if resp.status != 200 or not dev <= STREAM_ABS_TOL:
                raise AssertionError(f"{mode}: the stream differs from /synthesize by {dev}")

            # the mel of this model against the bf16 model's, same seed
            kw = {"cfg_interval": serve.FAST_PROFILE_CFG_INTERVAL} if mode == "fast" else {}
            with service.model_lock:
                mel = model.synthesize_mel(MN_TEXT, n_steps=SERVE_STEPS, seed=0, **kw)
                if mode == "bf16":
                    bf16_mels["int8"] = mel
                    bf16_mels["fast"] = model.synthesize_mel(
                        MN_TEXT, n_steps=SERVE_STEPS, seed=0,
                        cfg_interval=serve.FAST_PROFILE_CFG_INTERVAL)
            if mode != "bf16":
                dev = rel_l2(mel, bf16_mels[mode])
                report["mel_rel_l2_vs_bf16"] = dev
                report["mel_tol"] = QUANT_MEL_REL_L2_TOL[mode]
                if not dev <= QUANT_MEL_REL_L2_TOL[mode]:
                    raise AssertionError(f"{mode}: mel deviates from bf16 by {dev}")

            # a full queue sheds with 429 + Retry-After; the queued ones are served
            with service.model_lock:
                first = threading.Thread(target=http_post, args=(
                    port, "/synthesize", {"text": "за", "seed": 1, "steps": 2}))
                first.start()
                time.sleep(0.3)
                fill = [threading.Thread(target=http_post, args=(
                    port, "/synthesize", {"text": "за", "seed": i, "steps": 2}))
                    for i in range(8)]
                for th in fill:
                    th.start()
                deadline = time.monotonic() + 60
                while service.batcher._queued < 8 and time.monotonic() < deadline:
                    time.sleep(0.01)
                status, headers, body = http_post(port, "/synthesize",
                                                  {"text": "за", "steps": 2})
            for th in [first, *fill]:
                th.join(timeout=600)
            report["shed"] = {"status": status, "retry_after": headers.get("Retry-After"),
                              "shed_requests": http_health(port)[1]["shed_requests"]}
            if status != 429 or not headers.get("Retry-After") or b"overloaded" not in body:
                raise AssertionError(f"{mode}: a full queue answered {status}")

            # the counters of the main path, read before anything else runs
            counts = {k.__name__: k.launches for k in kernels}
            report["launches"] = counts
            if mode == "int8":
                # 6 projections x 22 blocks x 32 steps, for one row or eight
                want = 6 * depth * SERVE_STEPS
                if qmm_solo != want or report["merged"]["qmm_launches"] != want + 6 * depth * 2:
                    raise AssertionError(
                        f"int8: quantized_matmul launched {qmm_solo} times for the solo "
                        f"request and {report['merged']['qmm_launches']} for the merged "
                        f"solve plus its 2-step blocker, expected {want} and "
                        f"{want + 6 * depth * 2}")
                for name, n in counts.items():
                    totals[name] += n
            elif counts["quantized_matmul"] != 0:
                raise AssertionError(f"{mode}: the w8a16 kernel ran without --quantize int8")
            # after the counts were read: one traced merged solve
            emit({"phase": "profile", "mode": f"serve_{mode}_merged_8x832", "card": smi,
                  **profile_once(torch, lambda: model.synthesize_batch(
                      eight, seeds=seeds, n_steps=SERVE_STEPS, **service.profile_defaults))})

            # drain: a request in flight is answered, then the server is gone
            inflight: dict = {}
            client = threading.Thread(target=lambda: inflight.update(
                resp=post_wav({"text": eight[0], "seed": 2, "steps": SERVE_STEPS})))
            client.start()
            time.sleep(0.2)
            serve.begin_drain(server)
            draining = service.draining
            server.server_close()  # joins the handler in flight
            client.join(timeout=600)
            loop.join(timeout=60)
            service.close()
            report["drain"] = {"answered_in_flight": "resp" in inflight,
                               "threads_left": [t.name for t in threading.enumerate()
                                                if t is not threading.main_thread()
                                                and not t.daemon]}
            if not (draining and "resp" in inflight and not loop.is_alive()
                    and not client.is_alive()):
                raise AssertionError(f"{mode}: the drain dropped the request in flight")
            report["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
            report["requests"] = service.health()["requests"]
            emit(report)
            del server, service, model
    return totals


CLASSIC_MEL_REL_L2_TOL = 0.1  # bf16, 32 steps x 22 blocks, other roundings of the same math
CLASSIC_LOSS_REL_TOL = 1e-2   # one bf16 forward of the same weights, batch and noise


def kernel_wrappers() -> dict:
    """The attention and GELU+dropout wrappers whose launches the classic phase counts."""
    from oron_tts_tpu_torch.ops import flash_attention as fa
    from oron_tts_tpu_torch.ops.gelu_dropout import gelu_dropout_bwd, gelu_dropout_fwd

    return {f.__name__: f for f in (
        fa.flash_attention, fa.flash_attention_packed, fa.flash_attention_bwd, fa.flash_nosm,
        fa.flash_lanes_fwd, fa.flash_lanes_fwd_stats, fa.flash_lanes_bwd, gelu_dropout_fwd,
        gelu_dropout_bwd)}


def zero_counts(wrappers: dict) -> None:
    import torch

    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0


def read_counts(wrappers: dict) -> dict[str, int]:
    import torch

    torch.cuda.synchronize()
    return {n: fn.launches for n, fn in wrappers.items()}


def with_attn_impl(torch, model, impl: str, state: dict):
    """Rebuild ``model``'s backbone (an F5TTS) under ``attn_impl=impl`` from ``state``.

    ``F5TTS`` has no ``attn_impl`` (neither has the JAX facade); the switch
    lives on ``DiT``, as in the JAX package's ``bench.py``.
    """
    from oron_tts_tpu_torch.models.cfm import CFM
    from oron_tts_tpu_torch.models.dit import DiT

    m, a = model.config.model, model.config.audio
    model.backbone = model.cfm = None
    with torch.device(model.device):
        dit = DiT(dim=m.dim, depth=m.depth, heads=m.heads, dim_head=m.dim_head,
                  ff_mult=m.ff_mult, mel_dim=a.n_mels, vocab_size=m.vocab_size,
                  text_dim=m.text_dim, conv_layers=m.conv_layers, dropout=m.p_dropout,
                  attn_impl=impl)
    dit = dit.to(model.dtype).eval()
    dit.load_state_dict(state, strict=True)
    if dit.attn_impl != impl:
        raise AssertionError(f"asked for {impl}, the blocks run {dit.attn_impl}")
    model.backbone = dit
    model.cfm = CFM(dit, n_mels=a.n_mels, audio_drop_prob=m.audio_drop_prob,
                    cond_drop_prob=m.cond_drop_prob, frac_lengths_mask=m.frac_lengths_mask)
    return model


def run_classic(torch, smi: str) -> dict[str, int]:
    """Synthesis and training on the classic-layout attention, and the two benches."""
    import numpy as np

    from oron_tts_tpu_torch.cli import bench_attention, bench_model_ablation
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils.weights import from_flax_params, seeded_dit_params

    wrappers = kernel_wrappers()
    totals = {n: 0 for n in wrappers}

    def add(counts: dict) -> None:
        for n, c in counts.items():
            totals[n] += c

    cfg = F5Config()
    depth, hop, rate = cfg.model.depth, cfg.audio.hop_length, cfg.audio.sample_rate
    params = seeded_dit_params(cfg.model, seed=0)
    state = from_flax_params(params)
    model = F5TTS(cfg)
    model.load_params(params)
    model.load_vocoder()

    # synthesis: bench.py's protocol, the same text ids and noise for every impl
    frames = SYNTH_LETTERS * 13
    T = -(-frames // 64) * 64
    gen = torch.Generator().manual_seed(0)
    text = torch.randint(0, 65, (1, T), generator=gen).to(model.device)
    noise = torch.randn(1, T, cfg.audio.n_mels, generator=gen)
    cond = torch.zeros(1, T, cfg.audio.n_mels, device=model.device)
    duration, lens = torch.tensor([frames]), torch.tensor([0])
    audio_s = frames * hop / rate
    mels = {}
    for impl in ("lanes", "flash", "packed"):
        with_attn_impl(torch, model, impl, state)

        def solve(steps: int):
            mel = model.cfm.sample(cond, text, duration, lens, steps=steps, cfg_strength=2.0,
                                   sway_sampling_coef=-1.0, noise=noise)
            return mel, model._decode_mel(mel[:, :frames].transpose(1, 2))

        solve(2)  # warm-up
        zero_counts(wrappers)
        t0 = time.perf_counter()
        mel, wav = solve(SYNTH_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(wrappers)
        mels[impl] = mel[0, :frames].float().cpu().numpy()
        row = {"phase": "classic_synthesis", "impl": impl, "frames": frames, "bucket": T,
               "steps": SYNTH_STEPS, "wall_s": wall, "audio_s": audio_s, "rtf": wall / audio_s,
               "samples": len(wav), "launches": {n: c for n, c in counts.items() if c},
               "card": smi}
        if impl != "lanes":
            row["mel_rel_l2_vs_lanes"] = rel_l2(mels[impl], mels["lanes"])
            row["tol"] = CLASSIC_MEL_REL_L2_TOL
        emit(row)
        want = {"lanes": "flash_lanes_fwd", "flash": "flash_attention",
                "packed": "flash_attention_packed"}[impl]
        attn = {n: c for n, c in counts.items() if n.startswith("flash_")}
        if attn != {n: (SYNTH_STEPS * depth if n == want else 0) for n in attn}:
            raise AssertionError(f"{impl} synthesis launched {attn}, expected "
                                 f"{SYNTH_STEPS * depth} of {want} and nothing else")
        if not (np.isfinite(wav).all() and len(wav) == frames * hop and np.abs(wav).max() > 0):
            raise AssertionError(f"{impl} synthesis: no finite sound of {frames} frames")
        if impl != "lanes" and not row["mel_rel_l2_vs_lanes"] <= CLASSIC_MEL_REL_L2_TOL:
            raise AssertionError(f"{impl} synthesis: mel {row['mel_rel_l2_vs_lanes']} from lanes")
        if impl != "lanes":
            add(counts)
    del mels

    # training: CFM.loss -> backward -> guarded_update on attn_impl="flash", as
    # bench.py does with ORON_TRAIN_IMPL=flash; the lanes loss on the same
    # batch and generator seed first
    rng = np.random.default_rng(7)
    batch = {"mel": (0.5 * rng.standard_normal((TRAIN_B, cfg.audio.n_mels, TRAIN_T))
                     ).astype(np.float32),
             "text_ids": rng.integers(0, 65, (TRAIN_B, TRAIN_T)).astype(np.int32),
             "mel_lengths": np.asarray(train_clip_frames()[:TRAIN_B], np.int32)}
    kept = int(batch["mel_lengths"].sum())
    with_attn_impl(torch, model, "lanes", state)
    dev_batch = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
    with torch.no_grad():
        lanes_loss = model.cfm.loss(dev_batch["mel"], dev_batch["text_ids"],
                                    dev_batch["mel_lengths"], torch.Generator().manual_seed(0),
                                    train=True).item()
    del dev_batch
    with_attn_impl(torch, model, "flash", state)
    config = {"learning_rate": 1e-4, "warmup_steps": 2, "num_epochs": 1, "use_tqdm": False}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = F5Trainer(config, model, [batch], log_dir=f"{tmp}/logs",
                            checkpoint_dir=f"{tmp}/ckpt")
        step_ms, want = [], {"flash_attention": depth, "flash_attention_bwd": depth,
                             "gelu_dropout_fwd": depth, "gelu_dropout_bwd": depth}
        for step in range(5):
            zero_counts(wrappers)
            t0 = time.perf_counter()
            m = trainer.train_step(batch, torch.Generator().manual_seed(step))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts(wrappers)
            add(counts)
            if step >= 2:
                step_ms.append(ms)
            if step == 0:
                loss_rel = abs(m["loss"] - lanes_loss) / abs(lanes_loss)
            emit({"phase": "classic_train", "step": step, "timed": step >= 2,
                  "batch": [TRAIN_B, TRAIN_T], "kept_frames": kept, "loss": m["loss"],
                  "grad_norm": m["grad_norm"], "ok": m["ok"], "step_ms": ms,
                  "frames_per_s": kept / ms * 1e3, "launches": {n: c for n, c in counts.items() if c},
                  "card": smi})
            if not (m["ok"] and math.isfinite(m["loss"])):
                raise AssertionError(f"classic training step {step} not finite: {m}")
            if {n: c for n, c in counts.items() if c} != want:
                raise AssertionError(f"classic training step {step}: launches {counts}, "
                                     f"expected {want}")
        del trainer
    mean = sum(step_ms) / len(step_ms)
    emit({"phase": "classic_train_summary", "impl": "flash", "step_ms_mean": mean,
          "step_ms_min": min(step_ms), "frames_per_s": kept / mean * 1e3,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "first_step_loss_vs_lanes_rel": loss_rel, "lanes_loss": lanes_loss,
          "tol": CLASSIC_LOSS_REL_TOL, "card": smi})
    if not loss_rel <= CLASSIC_LOSS_REL_TOL:
        raise AssertionError(f"the flash step's loss is {loss_rel} from the lanes loss")
    del model
    torch.cuda.empty_cache()

    # the two bench entry points, as a user runs them
    zero_counts(wrappers)
    res = bench_attention.main(["--t", "1664", "--backward"])
    counts = read_counts(wrappers)
    add(counts)
    emit({"phase": "bench_attention", "ms": {k: v * 1e3 for k, v in res.items()},
          "launches": {n: c for n, c in counts.items() if c}, "card": smi})
    if counts["flash_nosm"] == 0 or counts["flash_attention_bwd"] == 0:
        raise AssertionError(f"bench_attention did not run kernels 12 and 7: {counts}")
    torch.cuda.empty_cache()
    zero_counts(wrappers)
    res = bench_model_ablation.main([])
    counts = read_counts(wrappers)
    add(counts)
    deep = {impl: res["device"][(22, impl)] for impl in ("flash", "einsum", "packed", "skip")}
    emit({"phase": "bench_model_ablation",
          **{f"{kind}_ms_per_forward": {f"depth{d}_{impl}": v * 1e3 for (d, impl), v in r.items()}
             for kind, r in res.items()},
          "attention_device_share_flash": (deep["flash"] - deep["skip"]) / deep["flash"],
          "launches": {n: c for n, c in counts.items() if c}, "card": smi})
    torch.cuda.empty_cache()
    return totals


def run_widths(torch, smi: str) -> dict[str, int]:
    """The Small config's synthesis and configs/test.yaml's training on the card."""
    import json
    import signal

    import numpy as np

    from oron_tts_tpu_torch.cli import train as cli_train
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.data.wav import write_wav
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.ops.flash_attention import (
        flash_lanes_bwd,
        flash_lanes_fwd,
        flash_lanes_fwd_stats,
    )
    from oron_tts_tpu_torch.ops.grouped_conv import grouped_conv1d_mish
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params

    repo = Path(__file__).resolve().parent
    wrappers = {f.__name__: f for f in (flash_lanes_fwd, flash_lanes_fwd_stats, flash_lanes_bwd,
                                        grouped_conv1d_mish)}
    cfg = F5Config.from_file(repo / "configs" / "local.yaml")
    model = F5TTS(cfg)  # the card, bf16
    model.load_params(seeded_dit_params(cfg.model, seed=0))
    model.load_vocoder()
    conv = model.backbone.input_embed.conv_pos_embed
    model.synthesize(MN_TEXT, n_steps=2, seed=0)
    zero_counts(wrappers)
    t0 = time.perf_counter()
    wav = model.synthesize(MN_TEXT, lang="mn", n_steps=8, cfg_strength=2.0,
                           sway_sampling_coef=-1.0, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    synth_counts = read_counts(wrappers)
    m = cfg.model
    emit({"phase": "widths_synthesis", "config": "configs/local.yaml", "dim": m.dim,
          "heads": m.heads, "depth": m.depth, "conv_route": conv.route,
          "conv_group_width": m.dim // conv.groups, "attn_impl": model.backbone.attn_impl,
          "steps": 8, "wall_s": wall, "samples": len(wav), "launches": synth_counts, "card": smi})
    want = {"flash_lanes_fwd": 8 * m.depth, "flash_lanes_fwd_stats": 0, "flash_lanes_bwd": 0,
            "grouped_conv1d_mish": 8 * 2}
    if synth_counts != want or conv.route != "kernel" or m.dim // conv.groups != 32:
        raise AssertionError(f"Small synthesis: launches {synth_counts}, expected {want}, "
                             f"conv route {conv.route}")
    if not (np.isfinite(wav).all() and np.abs(wav).max() > 0):
        raise AssertionError("Small synthesis: no finite sound")
    del model
    torch.cuda.empty_cache()

    # two epochs of the train CLI on configs/test.yaml (dim 64, heads 2: D = 32, f32)
    with tempfile.TemporaryDirectory() as tmp:
        records = []
        for i in range(5):
            t = np.arange(int(24000 * (1.0 + 0.3 * i))) / 24000
            path = Path(tmp) / f"clip{i}.wav"
            write_wav(path, (0.4 * np.sin(2 * np.pi * (200 + 20 * i) * t)).astype(np.float32),
                      24000)
            records.append({"audio_path": str(path), "text": "сайн байна уу", "lang": "mn"})
        (Path(tmp) / "metadata.json").write_text(json.dumps(records))
        zero_counts(wrappers)
        prev = signal.getsignal(signal.SIGTERM)
        t0 = time.perf_counter()
        try:
            cli_train.main(["--config", str(repo / "configs" / "test.yaml"), "--from-local",
                            "--data-dir", tmp, "--log-dir", f"{tmp}/logs",
                            "--checkpoint-dir", f"{tmp}/ckpt", "--num-epochs", "2"])
        finally:
            signal.signal(signal.SIGTERM, prev)
        wall = time.perf_counter() - t0
        train_counts = read_counts(wrappers)
        ckpts = sorted(p.name for p in Path(f"{tmp}/ckpt").glob("f5tts_step_*.npz"))
    emit({"phase": "widths_train", "config": "configs/test.yaml", "epochs": 2, "wall_s": wall,
          "checkpoints": ckpts, "launches": train_counts, "card": smi})
    if not (train_counts["flash_lanes_fwd_stats"] > 0 and train_counts["flash_lanes_bwd"] > 0
            and train_counts["grouped_conv1d_mish"] == 0 and ckpts):
        raise AssertionError(f"test.yaml training: launches {train_counts}, checkpoints {ckpts}")
    return {n: synth_counts[n] + train_counts[n] for n in wrappers}


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

    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t
        return out

    rows = timed("kernels", check_kernels, torch, F)
    timed("reference", check_reference, torch)
    timed("reference_train", check_train_reference, torch)
    timed("reference_serve", check_reference_serve, torch)
    launches: dict[str, int] = {}
    for name, phase in (("slice", run_slice), ("train", run_train), ("serve", run_serve),
                        ("batch_knee", run_batch_knee), ("classic", run_classic),
                        ("widths", run_widths)):
        for kernel, n in (timed(name, phase, torch, smi) or {}).items():
            launches[kernel] = launches.get(kernel, 0) + n
    emit({"phase": "phase_seconds", **seconds, "total_s": time.perf_counter() - t0})
    emit({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches[row["name"]]}
        | {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}
        | {"library": row.get("library"), "shape": row.get("shape")}
        for row in rows
    ], "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
