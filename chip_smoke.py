#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis slice on one NVIDIA GPU.

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
   CPU (plain versions), same weights and noise: mel and waveform agree.
5. slice: ``F5TTS.synthesize`` at the Base width in bf16 with seeded DiT
   weights and the bundled vocoder, ref-free and voice-cloned, 32 steps,
   CFG 2; launch counts are zeroed just before each and read just after.
6. profile: one more synthesis of each kind under ``torch.profiler``: the
   device time by kernel kind, the device's idle share of the wall time and
   the number of kernels launched.

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
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask)),
                bound_ms=b_ms, bound_by=b_by,
                route="cuda", source="oron_tts_tpu_torch/csrc/flash_lanes.cu",
                replaces="oron_tts_tpu/ops/flash_attention.py:387",
            )
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


PROFILE_KINDS = (
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
    launches = run_slice(torch, smi)
    emit({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches[row["name"]]}
        | {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}
        for row in rows
    ], "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
