"""Dataset preparation CLI of the PyTorch port (host code, no GPU).

    python -m oron_tts_tpu_torch.cli.prepare --datasets common_voice \\
        --output-dir data/processed [--no-denoise] [--max-samples N]

Counterpart of the JAX package's ``cli/prepare.py``. Per sample: clean the
text, decode the audio bytes (WAV in-process, other containers through
``ffmpeg``), denoise, peak-normalize, trim silence, drop clips under 1,024
samples, write a 16-bit WAV; then ``metadata.json`` for ``cli.train
--from-local``. The sources are HuggingFace hub datasets (``data/hf.py``), so
``main`` needs ``datasets`` and the network; ``process_dataset`` takes any
``datasets.Dataset`` (an in-memory one too) or a plain list of records with
the same columns (``{"sentence": ..., "audio": {"bytes": ...}}``), which
needs no ``datasets`` at all. ``--upload-repo`` pushes the result to the hub
with ``--hf-token`` or ``HF_TOKEN``.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

MIN_SAMPLES = 1024


def process_dataset(
    hf_dataset,
    out_dir: Path,
    lang: str,
    denoise: bool = True,
    text_column: str = "sentence",
    audio_column: str = "audio",
    sample_rate: int = 24000,
    start_index: int = 0,
) -> list[dict]:
    """Clean, denoise, normalize and trim every record; write its WAV; return the metadata."""
    from oron_tts_tpu_torch.data import wav as wavio
    from oron_tts_tpu_torch.data.denoiser import AudioDenoiser
    from oron_tts_tpu_torch.text import TextCleaner

    cleaner = TextCleaner()
    denoiser = AudioDenoiser(target_sample_rate=sample_rate) if denoise else None
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "wavs").mkdir(exist_ok=True)
    if hasattr(hf_dataset, "cast_column"):
        from datasets import Audio

        # keep the raw bytes: the library's own decoder needs packages this one does not
        hf_dataset = hf_dataset.cast_column(audio_column, Audio(decode=False))

    metadata: list[dict] = []
    skipped = 0
    for i, item in enumerate(hf_dataset):
        try:
            text = cleaner.clean(str(item[text_column]), lang=lang)
            if not text:
                skipped += 1
                continue
            info = item[audio_column]
            raw = info.get("bytes") if isinstance(info, dict) else None
            if not raw:
                path = info.get("path") if isinstance(info, dict) else None
                if path and Path(path).exists():
                    raw = Path(path).read_bytes()
            if not raw:
                skipped += 1
                continue
            audio = wavio.decode_audio_bytes(raw, sample_rate)  # mono, at sample_rate
            if denoiser is not None:
                audio = denoiser.denoise(audio, sample_rate)
            audio = wavio.trim_silence(wavio.normalize_peak(audio))
            if len(audio) < MIN_SAMPLES:
                skipped += 1
                continue
            wav_path = out_dir / "wavs" / f"{start_index + len(metadata):06d}.wav"
            wavio.write_wav(wav_path, audio, sample_rate)
            metadata.append({
                "audio_path": str(wav_path),
                "text": text,
                "lang": lang,
                "speaker_id": str(item.get("client_id", item.get("speaker_id", "0"))),
            })
        except Exception as exc:  # noqa: BLE001 - one bad record must not stop the corpus
            print(f"[WARN] sample {i} failed: {exc}")
            skipped += 1
    print(f"Processed {len(metadata)} samples, skipped {skipped}")
    return metadata


def create_metadata(out_dir: Path, metadata: list[dict]) -> Path:
    path = out_dir / "metadata.json"
    path.write_text(json.dumps(metadata, ensure_ascii=False, indent=2))
    print(f"Wrote {path} ({len(metadata)} entries)")
    return path


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Prepare TTS training data")
    parser.add_argument("--output-dir", type=str, default="data/processed")
    parser.add_argument("--datasets", nargs="+", default=["common_voice"],
                        choices=["common_voice", "mbspeech"],
                        help="Which source datasets to process")
    parser.add_argument("--lang", type=str, default="mn", choices=["mn", "kz"])
    parser.add_argument("--no-denoise", action="store_true")
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--upload-repo", type=str, default=None,
                        help="Optional HF dataset repo to upload to")
    parser.add_argument("--hf-token", type=str, default=None)
    args = parser.parse_args(argv)

    from oron_tts_tpu_torch.data.hf import CommonVoiceWrapper, HFDatasetWrapper, MBSpeechWrapper

    out_dir = Path(args.output_dir)
    all_meta: list[dict] = []
    for name in args.datasets:
        if name == "common_voice":
            wrapper, text_column = CommonVoiceWrapper(), "sentence"
        else:
            wrapper, text_column = MBSpeechWrapper(), "sentence_norm"
        ds = wrapper.load(split="train")
        if args.max_samples:
            ds = ds.select(range(min(args.max_samples, len(ds))))
        all_meta.extend(process_dataset(
            ds, out_dir, args.lang, denoise=not args.no_denoise, text_column=text_column,
            start_index=len(all_meta)))
    create_metadata(out_dir, all_meta)

    if args.upload_repo:
        ds = HFDatasetWrapper.create_from_files(
            [m["audio_path"] for m in all_meta], [m["text"] for m in all_meta],
            [m["speaker_id"] for m in all_meta])
        ds.push_to_hub(args.upload_repo, token=args.hf_token or os.environ.get("HF_TOKEN"))
        print(f"Uploaded to {args.upload_repo}")


if __name__ == "__main__":
    main()
