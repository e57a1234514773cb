"""Inference CLI of the PyTorch port.

    python -m oron_tts_tpu_torch.cli.infer --checkpoint <dir-or-.npz> \\
        --text "Сайн байна уу" --output out.wav [--device cpu]

Counterpart of the JAX package's ``cli/infer.py``: native ``.npz``
checkpoints (either package's) and the reference's torch ``.pt`` and
``.safetensors`` files (``utils/torch_compat.py``, EMA weights first); the
bundled Vocos, a Vocos ``.npz`` or torch-layout file, or ``--vocoder
griffin_lim``. It runs on the card unless ``--device cpu`` is given. A
calibrated ``duration_stats`` table in ``config.json`` sets the length of
every ref-free solve, as in the JAX package.

``--mesh DPxTP`` runs SPMD, one process per rank under ``torchrun``
(``python -m torch.distributed.run --nproc-per-node N -m
oron_tts_tpu_torch.cli.infer ... --mesh DPxTP``): every rank loads the
checkpoint, shards the DiT (``F5TTS.set_mesh``) and runs the same texts
and seeds; rank 0 writes the WAVs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from oron_tts_tpu_torch.cli import mesh_or_exit, validate_quantize_mesh


def load_model(checkpoint_path: str, use_ema: bool = True, precision: str | None = None,
               quantize: str | None = None, device: str | None = None):
    """Load ``F5TTS`` from an ``.npz``, ``.pt`` or ``.safetensors`` file or a directory.

    A directory holds ``f5tts_step_*.npz`` (the newest is taken, else
    ``f5tts_best.npz``) and ``config.json``; a file reads the ``config.json``
    beside it. A torch file holds the reference F5TTS's keys
    (``cfm.backbone.*``, or the DiT's own), converted by
    ``utils/torch_compat.py``; ``use_ema`` prefers its EMA weights.
    ``precision=None`` is the facade's default (bf16 on the card,
    f32 on the CPU: the parameters are stored in the compute type);
    ``"float32"`` forces f32. ``quantize`` (``"int8"`` w8a16, ``"int8_dynamic"``
    w8a8) converts the attention and FFN projections in memory after loading.
    ``device=None`` is the card.
    """
    import torch

    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.checkpoint import CheckpointManager, load_pytree_npz

    path = Path(checkpoint_path)
    if not path.exists():
        raise SystemExit(
            f"error: checkpoint path does not exist: {path}\n"
            "Pass a checkpoint directory (with f5tts_step_*.npz + config.json) "
            "or a .npz/.pt/.safetensors file."
        )
    cm = CheckpointManager(path if path.is_dir() else path.parent)
    config = cm.load_config() or {}
    model = F5TTS.from_config(
        F5Config.from_dict(config), device=device,
        dtype=torch.float32 if precision == "float32" else None)
    # per-token duration calibration fitted at training time
    # (data/duration_stats.py); absent → chars·13
    model.set_duration_stats(config.get("duration_stats"))

    if path.is_dir():
        found = cm.latest_checkpoint() or (cm.best_path() if cm.best_path().exists() else None)
        if found is None:
            raise FileNotFoundError(f"no checkpoint found in {path}")
        path = found
    if path.suffix == ".npz":
        trees, meta = load_pytree_npz(path)
        if use_ema and trees.get("ema") is not None:
            params = trees["ema"]
            print("Loading EMA weights (smoothed)")
        else:
            params = trees.get("params")
            print("[WARN] EMA weights not found in checkpoint, using raw weights" if use_ema
                  else "Loading raw training weights (--no-ema)")
        if params is None:
            raise ValueError(f"{path} holds no 'params' tree")
        model.load_params(params)
        print(f"Checkpoint step: {meta.get('step', '?')}")
    else:  # the reference's torch .pt / .safetensors
        from oron_tts_tpu_torch.utils.torch_compat import (
            convert_f5tts_state_dict,
            load_torch_checkpoint,
        )

        sd = load_torch_checkpoint(path, prefer_ema=use_ema)
        m = model.config.model
        model.load_params(convert_f5tts_state_dict(sd, depth=m.depth, conv_layers=m.conv_layers))
        print(f"Loaded torch-format checkpoint ({'EMA' if use_ema else 'raw'} weights preferred)")
    if quantize:
        model.quantize_for_serving(quantize)
        print(f"DiT attention/FFN projections quantized for serving: {quantize} "
              "(in-memory only; checkpoint unchanged)")
    return model


def parse_cfg_interval(parser: argparse.ArgumentParser, text: str | None):
    """``"LO,HI"`` → ``(lo, hi)``, or a usage error."""
    if not text:
        return None
    try:
        lo, hi = (float(v) for v in text.split(","))
    except ValueError:
        parser.error("--cfg-interval must be LO,HI (e.g. 0.0,0.75)")
    if not 0.0 <= lo <= hi:
        parser.error("--cfg-interval needs 0 <= LO <= HI")
    return lo, hi


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="OronTTS F5-TTS inference (PyTorch)")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Path to an .npz/.pt/.safetensors checkpoint or a checkpoint "
                             "directory")
    parser.add_argument("--text", type=str, default=None, help="Cyrillic text to synthesize")
    parser.add_argument("--text-file", type=str, default=None,
                        help="File with one utterance per line: batched synthesis, "
                             "outputs <output-stem>_000.wav ...")
    parser.add_argument("--lang", type=str, default="mn", choices=["mn", "kz"])
    parser.add_argument("--output", type=str, default="output.wav")
    parser.add_argument("--ref-audio", type=str, default=None,
                        help="3-10 s reference WAV for voice cloning")
    parser.add_argument("--ref-text", type=str, default=None, help="Transcript of --ref-audio")
    parser.add_argument("--steps", type=int, default=32, help="ODE integration steps")
    parser.add_argument("--cfg-strength", type=float, default=2.0)
    parser.add_argument("--sway-sampling-coef", type=float, default=-1.0,
                        help="Sway sampling coefficient; use 0 for uniform")
    parser.add_argument("--ode-method", type=str, default="euler", choices=["euler", "midpoint"],
                        help="euler, or midpoint (second order, two DiT forwards per step)")
    parser.add_argument("--cfg-interval", type=str, default=None, metavar="LO,HI",
                        help="Apply guidance only at the steps whose time lies in [LO,HI]; the "
                             "others run one cond-only forward. Default: every step")
    parser.add_argument("--duration", type=float, default=None, help="Target duration in seconds")
    parser.add_argument("--speed", type=float, default=1.0,
                        help="Speaking-rate multiplier; ignored if --duration is set")
    parser.add_argument("--max-chars-per-chunk", type=int, default=120,
                        help="Split long text into chunks; 0 disables chunking")
    parser.add_argument("--pause-ms", type=int, default=250, help="Silence between chunks")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--no-ema", action="store_true", help="Use raw weights instead of EMA")
    parser.add_argument("--vocoder", type=str, default=None,
                        help="Vocos .npz or torch-layout file, or griffin_lim")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--fp32", action="store_true",
                        help="Force float32 compute and parameters (default: bf16 on the card)")
    parser.add_argument("--quantize", type=str, default=None, choices=["int8", "int8_dynamic"],
                        help="Serve the DiT projections in int8: 'int8' = w8a16 through the "
                             "hand-written kernel, 'int8_dynamic' = w8a8")
    parser.add_argument("--mesh", type=str, default=None,
                        help="Multi-GPU mesh as DPxTP (e.g. 2x2), one process per rank under "
                             "torchrun: rows shard over DP, attention/FFN projections over TP")
    args = parser.parse_args(argv)
    validate_quantize_mesh(parser, args.quantize, args.mesh)
    cfg_interval = parse_cfg_interval(parser, args.cfg_interval)
    if (args.text is None) == (args.text_file is None):
        parser.error("provide exactly one of --text or --text-file")
    if args.text_file and args.duration:
        parser.error("--duration is per-utterance: use --text for an explicit "
                     "duration (--text-file estimates per line)")

    from oron_tts_tpu_torch.data.wav import write_wav
    from oron_tts_tpu_torch.models.f5tts import split_text_for_synthesis

    mesh = mesh_or_exit(parser, args.mesh, args.device) if args.mesh else None
    model = load_model(args.checkpoint, use_ema=not args.no_ema,
                       precision="float32" if args.fp32 else None, quantize=args.quantize,
                       device=args.device if mesh is None else mesh.device)
    if args.vocoder:
        model.load_vocoder(args.vocoder)
    if mesh is not None:
        model.set_mesh(mesh)
        print(f"Serving mesh: {mesh.shape} (rank {mesh.rank} of {mesh.world})")
    main_rank = mesh is None or mesh.is_main
    print(f"Model loaded on {model.device}. Parameters: {model.num_params():,}")

    out = Path(args.output)
    if main_rank:
        out.parent.mkdir(parents=True, exist_ok=True)
    sampler = dict(
        lang=args.lang, n_steps=args.steps, cfg_strength=args.cfg_strength,
        sway_sampling_coef=args.sway_sampling_coef, speed=args.speed, seed=args.seed,
        max_chars_per_chunk=args.max_chars_per_chunk, pause_s=args.pause_ms / 1000,
        ref_audio_path=args.ref_audio, ref_text=args.ref_text,
        cfg_interval=cfg_interval, method=args.ode_method,
    )
    if args.text_file:
        texts = [line.strip() for line in Path(args.text_file).read_text().splitlines()
                 if line.strip()]
        print(f"Batch synthesis: {len(texts)} utterances [{args.lang}]")
        for i, wav in enumerate(model.synthesize_batch(texts, **sampler)):
            if main_rank:
                path = out.with_name(f"{out.stem}_{i:03d}{out.suffix or '.wav'}")
                write_wav(path, wav, model.sample_rate)
                print(f"Saved: {path} ({len(wav) / model.sample_rate:.2f} s)")
        return

    print(f"Synthesising [{args.lang}]: {args.text}")
    if args.max_chars_per_chunk > 0:
        n_chunks = len(split_text_for_synthesis(args.text, args.max_chars_per_chunk))
        if n_chunks > 1:
            print(f"Long text split into {n_chunks} chunks "
                  f"(max {args.max_chars_per_chunk} chars each)")
    waveform = model.synthesize(text=args.text, target_duration_s=args.duration, **sampler)
    if main_rank:
        write_wav(out, waveform, model.sample_rate)
        print(f"Saved: {out} ({len(waveform) / model.sample_rate:.2f} s)")


if __name__ == "__main__":
    main()
