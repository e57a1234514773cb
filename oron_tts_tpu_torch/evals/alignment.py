"""Tone-code alignment protocol: does a trained model speak its text?

Counterpart of the JAX package's ``evals/alignment.py``, with the same
constants, rendering and decoding. Each Mongolian letter is a pure tone whose
fundamental sits on one mel filterbank peak (two bins apart per letter), so
per-frame argmax over the 100-mel features separates the letters. A corpus
is rendered where the audio is a deterministic function of the characters: 9
frames of tone and 4 of gap per letter, 13 frames of silence per space or
punctuation mark, which matches the facade's ref-free rule of 13 frames per
character. A model trained on it must learn both the alignment (which frames
belong to which character) and the acoustics (which tone each character is).
``decode_logmel`` inverts a generated log-mel back to letters by frame-wise
argmax and silence-gap segmentation; ``char_error_rate`` scores it against
the cleaned text. An untrained model scores about 1, one that learned
text-conditioned generation approaches 0.

Used by ``cli/make_tone_corpus.py`` (the corpus) and ``cli/eval_alignment.py``
(training and scoring). Decoding runs on the host: ``decode_waveform`` takes
the plain log-mel on a CPU tensor. As a script it scores synthesized WAVs::

    python -m oron_tts_tpu_torch.evals.alignment --text "<sentence>" out.wav [...]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from oron_tts_tpu_torch.ops.mel import MelConfig, _mel_to_hz_htk, log_mel_spectrogram
from oron_tts_tpu_torch.text.cleaner import TextCleaner
from oron_tts_tpu_torch.text.tokenizer import MN_CHARS

SR = 24000
HOP = 256
FRAMES_PER_CHAR = 13  # the ref-free duration rule: chars·13 frames
TONE_FRAMES = 9       # per letter 9 frames of tone and a 4-frame gap: the gap
#                       (1,024 samples, one STFT window) lets its centre frame
#                       reach silence, so repeated letters stay separable
AMPLITUDE = 0.5
RAMP = 128            # raised-cosine fade samples at the tone edges

# Letter i → mel filterbank bin 12 + 2i (bins 12..80 for the 35 letters).
# Triangle k peaks at mel (k + 1)·mel_max/(n_mels + 1) (ops/mel.py
# mel_filterbank), so a fundamental on that peak puts the argmax on its bin.
FIRST_BIN = 12
BIN_STEP = 2
LETTERS = MN_CHARS  # 35 letters, index = tone order


def letter_bins() -> dict[str, int]:
    return {ch: FIRST_BIN + BIN_STEP * i for i, ch in enumerate(LETTERS)}


def letter_frequencies(cfg: MelConfig | None = None) -> dict[str, float]:
    """Fundamental per letter: the Hz of its mel bin's peak."""
    cfg = cfg or MelConfig()
    mel_max = float(np.asarray(2595.0 * np.log10(1.0 + (cfg.sample_rate / 2) / 700.0)))
    return {
        ch: float(_mel_to_hz_htk(np.asarray((b + 1) * mel_max / (cfg.n_mels + 1))))
        for ch, b in letter_bins().items()
    }


def expected_letters(text: str, lang: str = "mn") -> str:
    """The decode target: the cleaned text restricted to the letters."""
    return "".join(c for c in TextCleaner().clean(text, lang) if c in LETTERS)


def render_text(text: str, lang: str = "mn") -> np.ndarray:
    """Deterministic waveform of a sentence (cleaned here).

    A letter: TONE_FRAMES frames of its f0 (+ 0.25 × the 2nd harmonic below
    10 kHz), then the gap, which keeps repeated letters apart. Anything else
    (space, punctuation): FRAMES_PER_CHAR frames of silence.
    """
    cleaned = TextCleaner().clean(text, lang)
    freqs = letter_frequencies()
    char_samps = FRAMES_PER_CHAR * HOP
    tone_samps = TONE_FRAMES * HOP
    ramp = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, RAMP, dtype=np.float32))

    pieces: list[np.ndarray] = []
    for ch in cleaned:
        seg = np.zeros(char_samps, dtype=np.float32)
        f0 = freqs.get(ch)
        if f0 is not None:
            t = np.arange(tone_samps, dtype=np.float32) / SR
            tone = np.sin(2 * np.pi * f0 * t)
            if 2 * f0 < 10000.0:
                tone = tone + 0.25 * np.sin(2 * np.pi * 2 * f0 * t)
            tone *= AMPLITUDE
            tone[:RAMP] *= ramp
            tone[-RAMP:] *= ramp[::-1]
            seg[:tone_samps] = tone
        pieces.append(seg)
    if not pieces:
        return np.zeros(char_samps, dtype=np.float32)
    return np.concatenate(pieces)


def decode_waveform(
    wav: np.ndarray,
    cfg: MelConfig | None = None,
    voiced_threshold: float = -2.0,
    min_run: int = 3,
) -> str:
    """Invert audio to a letter string (see :func:`decode_logmel`)."""
    cfg = cfg or MelConfig()
    logmel = log_mel_spectrogram(torch.from_numpy(np.asarray(wav, dtype=np.float32)), cfg)
    return decode_logmel(logmel.numpy(), voiced_threshold, min_run)


def decode_logmel(
    logmel: np.ndarray,
    voiced_threshold: float = -2.0,
    min_run: int = 3,
) -> str:
    """Invert a [n_mels, T] log-mel to a letter string (a CTC-style collapse).

    Per frame: the letter nearest the mel argmax when the frame is voiced,
    else silence. Letter runs of at least ``min_run`` frames emit their
    letter; equal neighbours merge unless silence separates them (every
    rendered letter ends in a gap, so true repeats like "уу" stay two). Only
    the order of the tones must survive generation: boundaries come from
    symbol changes and energy gaps, not fixed slots.

    It takes the log-mel, the model's own output, so the score is not
    confounded with a speech vocoder's error on pure tones.
    """
    logmel = np.asarray(logmel, dtype=np.float32)
    peak = logmel.max(axis=0)
    argmax = logmel.argmax(axis=0)

    bins = letter_bins()
    bin_list = np.asarray(list(bins.values()))
    chars = list(bins.keys())

    silence = -1
    syms = np.where(
        peak > voiced_threshold,
        np.abs(bin_list[None, :] - argmax[:, None]).argmin(axis=1),
        silence,
    )

    out: list[str] = []
    sep_since_emit = True  # silence seen since the last emitted letter
    run_sym, run_len = silence, 0
    for s in list(syms) + [silence - 1]:  # the sentinel flushes the last run
        if s == run_sym:
            run_len += 1
            continue
        if run_sym == silence:
            if run_len >= 1:
                sep_since_emit = True
        elif run_sym >= 0 and run_len >= min_run:
            letter = chars[int(run_sym)]
            if sep_since_emit or not out or out[-1] != letter:
                out.append(letter)
            sep_since_emit = False
        run_sym, run_len = s, 1
    return "".join(out)


def char_error_rate(ref: str, hyp: str) -> float:
    """Levenshtein distance / len(ref); ``ref`` must not be empty."""
    if not ref:
        raise ValueError("empty reference")
    prev = list(range(len(hyp) + 1))
    for i, rc in enumerate(ref, 1):
        cur = [i]
        for j, hc in enumerate(hyp, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (rc != hc)))
        prev = cur
    return prev[-1] / len(ref)


def main(argv: list[str] | None = None) -> list[dict]:
    """Decode each WAV and print its letters and CER against ``--text``, one JSON line each."""
    from oron_tts_tpu_torch.data.wav import read_wav

    ap = argparse.ArgumentParser(description="Score synthesized WAVs of a tone-code sentence")
    ap.add_argument("--text", required=True, help="the sentence the WAVs were synthesized from")
    ap.add_argument("wavs", nargs="+")
    args = ap.parse_args(argv)
    ref = expected_letters(args.text)
    rows = []
    for path in args.wavs:
        wav, sr = read_wav(path)
        if sr != SR:
            raise SystemExit(f"{path}: {sr} Hz, the protocol's mels are at {SR} Hz")
        hyp = decode_waveform(wav)
        rows.append({"wav": path, "expected": ref, "decoded": hyp,
                     "cer": char_error_rate(ref, hyp)})
        print(json.dumps(rows[-1], ensure_ascii=False))
    return rows


if __name__ == "__main__":
    main()
