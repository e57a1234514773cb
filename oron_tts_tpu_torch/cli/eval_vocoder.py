"""Score a vocoder checkpoint on held-out clips, and optionally ship it.

    python -m oron_tts_tpu_torch.cli.eval_vocoder --checkpoint output/vocoder \\
        --data-dir data/synth_speech --clips 32 [--griffin-lim] [--ship-to DIR]

Counterpart of the JAX package's ``scripts/eval_vocoder.py``. The scored
pool is the tail ``int(len(corpus) · --holdout-frac)`` of ``metadata.json``,
exactly what ``cli.train_vocoder`` leaves out with the same fraction;
``--clips`` is clamped to it. Each clip is cut (or zero-padded) to
``--seconds``, rounded down to whole hops; the vocoder resynthesizes it from
its own log-mel, and the result is scored by the multi-resolution STFT loss
and the log-mel L1. ``--griffin-lim`` scores the Griffin-Lim fallback on the
same clips (32 iterations, one clip at a time) as the floor to beat.
``--hf-dataset`` streams real clips instead (the ``datasets`` library and
the network). Scoring is f32 with TF32 off, so the card reproduces the
reference numbers.

``--ship-to DIR`` writes ``vocos_default.npz`` (parameters only),
``config.json`` and ``EVAL.json`` into DIR; point ``ORON_VOCOS_CKPT`` at
the npz to use it. (The JAX script's ``--ship`` writes into the JAX
package's asset directory, which this package does not touch.)
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Evaluate a vocoder checkpoint (PyTorch)")
    ap.add_argument("--checkpoint", type=str, required=True,
                    help=".npz file or checkpoint dir (latest vocos_step_*)")
    ap.add_argument("--data-dir", type=str, default=None,
                    help="metadata.json corpus for held-out evaluation")
    ap.add_argument("--hf-dataset", type=str, default=None,
                    help="Real-speech eval: stream clips from a HuggingFace dataset instead "
                         "of --data-dir (--holdout-frac is ignored). Needs the network.")
    ap.add_argument("--hf-split", type=str, default="train")
    ap.add_argument("--hf-audio-column", type=str, default="audio")
    ap.add_argument("--clips", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=2.0, help="evaluated length per clip")
    ap.add_argument("--holdout-frac", type=float, default=0.05,
                    help="last fraction of the corpus treated as held out")
    ap.add_argument("--griffin-lim", action="store_true",
                    help="also measure the Griffin-Lim fallback")
    ap.add_argument("--ship-to", type=str, default=None,
                    help="write vocos_default.npz + config.json + EVAL.json into this directory")
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return ap


def resolve_checkpoint(path: str) -> Path:
    ckpt = Path(path)
    if ckpt.is_dir():
        steps = sorted(ckpt.glob("vocos_step_*.npz"))
        if not steps:
            raise SystemExit(f"no vocos_step_*.npz in {ckpt}")
        ckpt = steps[-1]
    return ckpt


def hf_clips(args, crop: int, sample_rate: int) -> list:
    """Full-length real clips streamed from a HuggingFace dataset (network)."""
    import numpy as np
    from datasets import Audio, load_dataset

    from oron_tts_tpu_torch.data.wav import decode_audio_bytes, normalize_peak

    ds = load_dataset(args.hf_dataset, split=args.hf_split, streaming=True)
    ds = ds.cast_column(args.hf_audio_column, Audio(decode=False))
    wavs = []
    for item in ds:
        raw = item[args.hf_audio_column].get("bytes")
        if not raw:
            continue
        try:
            wav = decode_audio_bytes(raw, sample_rate)
        except Exception:
            continue
        wav = normalize_peak(wav.astype(np.float32))
        if len(wav) >= crop:
            wavs.append(wav[:crop])
        if len(wavs) >= args.clips:
            break
    if not wavs:
        raise SystemExit(f"no usable clips streamed from {args.hf_dataset}")
    print(f"evaluating on {len(wavs)} real clips from {args.hf_dataset}")
    return wavs


def held_out_clips(args, crop: int, sample_rate: int) -> list:
    """The held-out tail of ``--data-dir``, each clip cut or zero-padded to ``crop``."""
    import numpy as np

    from oron_tts_tpu_torch.data.wav import normalize_peak, read_wav, resample

    metadata = json.loads((Path(args.data_dir) / "metadata.json").read_text())
    # exactly what cli.train_vocoder excluded with the same --holdout-frac:
    # widening it to satisfy --clips would score training clips
    n_hold = int(len(metadata) * args.holdout_frac)
    if n_hold == 0:
        raise SystemExit(f"holdout pool is empty ({len(metadata)} clips x --holdout-frac "
                         f"{args.holdout_frac}); nothing to evaluate")
    if args.clips > n_hold:
        print(f"[WARN] --clips {args.clips} > holdout pool {n_hold}; clamping to {n_hold} "
              f"to keep the eval held-out")
        args.clips = n_hold
    wavs = []
    for m in metadata[-n_hold:][: args.clips]:
        wav, sr = read_wav(m["audio_path"])
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        if sr != sample_rate:
            wav = resample(wav, sr, sample_rate)
        wav = normalize_peak(wav.astype(np.float32))
        if len(wav) < crop:
            wav = np.pad(wav, (0, crop - len(wav)))
        wavs.append(wav[:crop])
    return wavs


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from oron_tts_tpu_torch.models.vocos import VocosDecoder
    from oron_tts_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram
    from oron_tts_tpu_torch.train.checkpoint import load_pytree_npz, save_pytree_npz
    from oron_tts_tpu_torch.train.vocoder import mel_l1, multi_resolution_stft_loss
    from oron_tts_tpu_torch.utils.device import resolve_device
    from oron_tts_tpu_torch.utils.weights import from_flax_params

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt = resolve_checkpoint(args.checkpoint)
    trees, meta = load_pytree_npz(ckpt)
    params = trees.get("ema") or trees.get("params") or trees
    cfg_path = ckpt.parent / "config.json"
    voc_cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
    print(f"checkpoint: {ckpt} (step {meta.get('step', '?')}) config={voc_cfg}")

    mel_cfg = MelConfig()
    vocoder = VocosDecoder(
        dim=voc_cfg.get("dim", 512), n_layers=voc_cfg.get("n_layers", 8),
        intermediate_dim=voc_cfg.get("intermediate_dim", 1536),
        head_mode=voc_cfg.get("head_mode", "real_imag"),
        layer_scale=bool(voc_cfg.get("layer_scale", False)),
    )
    vocoder.load_state_dict(from_flax_params(params), strict=True)
    vocoder.to(device).eval()

    crop = int(args.seconds * mel_cfg.sample_rate)
    crop -= crop % mel_cfg.hop_length
    if args.hf_dataset:
        wavs = hf_clips(args, crop, mel_cfg.sample_rate)
    elif args.data_dir:
        wavs = held_out_clips(args, crop, mel_cfg.sample_rate)
    else:
        raise SystemExit("pass --data-dir or --hf-dataset")
    target = torch.from_numpy(np.stack(wavs)).to(device)
    t_frames = crop // mel_cfg.hop_length
    with torch.no_grad():
        mel = log_mel_spectrogram(target, mel_cfg)[..., :t_frames]
        pred = vocoder(mel)
        n = min(pred.shape[-1], target.shape[-1])
        mr = float(multi_resolution_stft_loss(pred[:, :n], target[:, :n]))
        ml1 = float(mel_l1(pred[:, :n], target[:, :n], mel_cfg))
    print(f"vocoder: MR-STFT {mr:.4f}  mel-L1 {ml1:.4f} "
          f"({len(wavs)} held-out clips x {args.seconds:.1f}s)")
    result = {"checkpoint": str(ckpt), "step": int(meta.get("step", 0)),
              "source": args.hf_dataset or args.data_dir, "clips": len(wavs),
              "mr_stft": round(mr, 4), "mel_l1": round(ml1, 4),
              "mr_stft_exact": mr, "mel_l1_exact": ml1}

    if args.griffin_lim:
        from oron_tts_tpu_torch.ops.griffin_lim import griffin_lim

        gl_mr, gl_mel = [], []
        with torch.no_grad():
            for i in range(len(wavs)):
                gl = griffin_lim(mel[i][None], mel_cfg, n_iter=32)[0]
                n = min(gl.shape[-1], crop)
                gl_c, tgt_c = gl[None, :n], target[i:i + 1, :n]
                gl_mr.append(float(multi_resolution_stft_loss(gl_c, tgt_c)))
                gl_mel.append(float(mel_l1(gl_c, tgt_c, mel_cfg)))
        print(f"griffin-lim floor: MR-STFT {np.mean(gl_mr):.4f}  mel-L1 {np.mean(gl_mel):.4f}")
        result["griffin_lim_mr_stft"] = round(float(np.mean(gl_mr)), 4)
        result["griffin_lim_mel_l1"] = round(float(np.mean(gl_mel)), 4)

    if args.ship_to:
        out_dir = Path(args.ship_to)
        out_dir.mkdir(parents=True, exist_ok=True)
        out = out_dir / "vocos_default.npz"
        save_pytree_npz(out, {"params": params},
                        meta={"step": int(meta.get("step", 0)), "eval_mr_stft": mr,
                              "eval_mel_l1": ml1})
        (out_dir / "config.json").write_text(json.dumps(voc_cfg))
        (out_dir / "EVAL.json").write_text(json.dumps(result, indent=1))
        print(f"shipped the vocoder -> {out} ({out.stat().st_size / 1e6:.1f} MB); "
              f"use it with ORON_VOCOS_CKPT={out}")

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
