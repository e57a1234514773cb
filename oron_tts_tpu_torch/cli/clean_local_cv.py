"""Process a local Common Voice archive without the HuggingFace hub (host code, no GPU).

    python -m oron_tts_tpu_torch.cli.clean_local_cv --archive cv-corpus-mn.tar.gz \\
        --output-dir data/processed [--denoise] [--max-samples N]

Counterpart of the JAX package's ``scripts/clean_local_cv.py``: find the TSV
and the clips inside the tar, decode each clip, clean the text, optionally
denoise, peak-normalize, trim silence, keep clips of 0.5–15 s, write WAVs and
a ``metadata.json`` with a ``client_id`` → ``speaker_id`` mapping. Clips are
decoded by :func:`load_clip_bytes`: WAV in-process, MP3 (Common Voice's own
format) and any other container through an ``ffmpeg`` subprocess.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import tarfile
from pathlib import Path

import numpy as np

MIN_DUR_S = 0.5
MAX_DUR_S = 15.0
CLIP_SUFFIXES = (".mp3", ".wav")


def load_clip_bytes(raw: bytes, target_sr: int) -> np.ndarray:
    """A clip's bytes → mono float32 at ``target_sr``."""
    from oron_tts_tpu_torch.data.wav import decode_audio_bytes

    return decode_audio_bytes(raw, target_sr)


def extract_and_process_cv(
    archive_path: Path,
    out_dir: Path,
    lang: str = "mn",
    denoise: bool = False,
    sample_rate: int = 24000,
    max_samples: int | None = None,
) -> list[dict]:
    from oron_tts_tpu_torch.data import wav as wavio
    from oron_tts_tpu_torch.data.denoiser import AudioDenoiser
    from oron_tts_tpu_torch.text import TextCleaner

    cleaner = TextCleaner()
    denoiser = AudioDenoiser(target_sample_rate=sample_rate) if denoise else None
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "wavs").mkdir(exist_ok=True)

    with tarfile.open(archive_path, "r:*") as tar:
        members = {m.name: m for m in tar.getmembers() if m.isfile()}
        tsv_name = next((n for n in members if n.endswith("validated.tsv")),
                        next((n for n in members if n.endswith(".tsv")), None))
        if tsv_name is None:
            raise RuntimeError("no TSV found in archive")
        tsv_file = tar.extractfile(members[tsv_name])
        rows = list(csv.DictReader(io.TextIOWrapper(tsv_file, encoding="utf-8"),
                                   delimiter="\t"))
        print(f"TSV: {tsv_name} ({len(rows)} rows)")
        clip_dirs = {str(Path(n).parent) for n in members if n.endswith(CLIP_SUFFIXES)}
        clip_dir = next(iter(sorted(clip_dirs)), "clips")

        speaker_ids: dict[str, int] = {}
        metadata: list[dict] = []
        skipped = 0
        for row in rows:
            if max_samples and len(metadata) >= max_samples:
                break
            try:
                clip = row.get("path", "")
                member = members.get(f"{clip_dir}/{clip}") or members.get(clip)
                if member is None:
                    skipped += 1
                    continue
                text = cleaner.clean(row.get("sentence", ""), lang=lang)
                if not text:
                    skipped += 1
                    continue
                audio = load_clip_bytes(tar.extractfile(member).read(), sample_rate)
                if denoiser is not None:
                    audio = denoiser.denoise(audio, sample_rate)
                audio = wavio.trim_silence(wavio.normalize_peak(audio))
                dur = len(audio) / sample_rate
                if not (MIN_DUR_S <= dur <= MAX_DUR_S):
                    skipped += 1
                    continue
                spk = speaker_ids.setdefault(row.get("client_id", "0"), len(speaker_ids))
                wav_path = out_dir / "wavs" / f"{len(metadata):06d}.wav"
                wavio.write_wav(wav_path, audio, sample_rate)
                metadata.append({"audio_path": str(wav_path), "text": text, "lang": lang,
                                 "speaker_id": str(spk)})
            except Exception as exc:  # noqa: BLE001 - one bad row must not stop the archive
                print(f"[WARN] row failed: {exc}")
                skipped += 1
        print(f"Kept {len(metadata)}, skipped {skipped}")

    (out_dir / "metadata.json").write_text(json.dumps(metadata, ensure_ascii=False, indent=2))
    return metadata


def main(argv: list[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description="Clean a local Common Voice tar.gz")
    parser.add_argument("--archive", type=str, required=True)
    parser.add_argument("--output-dir", type=str, default="data/processed")
    parser.add_argument("--lang", type=str, default="mn", choices=["mn", "kz"])
    parser.add_argument("--denoise", action="store_true")
    parser.add_argument("--max-samples", type=int, default=None)
    args = parser.parse_args(argv)
    return extract_and_process_cv(Path(args.archive), Path(args.output_dir), lang=args.lang,
                                  denoise=args.denoise, max_samples=args.max_samples)


if __name__ == "__main__":
    main()
