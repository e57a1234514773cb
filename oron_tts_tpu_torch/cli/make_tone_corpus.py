"""Generate the tone-code alignment corpus (``evals/alignment.py``).

    python -m oron_tts_tpu_torch.cli.make_tone_corpus --out data/tone [--sentences 512]

Each sentence is random words of Mongolian letters; its waveform is the
letter→tone rendering of ``evals.alignment.render_text``, a pure function of
the characters, so a model trained on the corpus can be scored by inverting
its mels back to letters (``cli/eval_alignment.py``). Counterpart of the JAX
package's ``scripts/make_tone_corpus.py``: the same texts and waveforms for
the same arguments.

Library use: ``build_corpus(n, seed)`` returns (texts, wavs) in memory. The
CLI writes ``wav/%05d.wav`` and ``metadata.json`` under ``--out``, the layout
``cli/train.py --from-local`` reads.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from oron_tts_tpu_torch.evals.alignment import LETTERS, SR, render_text


def sample_sentence(rng: np.random.Generator, min_words: int = 3, max_words: int = 5,
                    min_len: int = 2, max_len: int = 6) -> str:
    """Random words of uniformly drawn letters (the protocol tests alignment,
    not language).

    Sentences keep at least 9 cleaned characters: a character renders 13
    frames (0.139 s) and ``TTSDataset`` drops clips under 1.0 s.
    """
    n_words = int(rng.integers(min_words, max_words + 1))
    words = []
    for _ in range(n_words):
        n = int(rng.integers(min_len, max_len + 1))
        words.append("".join(rng.choice(list(LETTERS), size=n)))
    while len(" ".join(words)) < 9:
        n = int(rng.integers(min_len, max_len + 1))
        words.append("".join(rng.choice(list(LETTERS), size=n)))
    return " ".join(words)


def build_corpus(n_sentences: int, seed: int = 0, **kw) -> tuple[list[str], list[np.ndarray]]:
    """(texts, wavs), deterministic in (n_sentences, seed).

    The first sentences (the letters in pairs, four pairs a sentence) cover
    the whole alphabet, so every tone bin is trained; that takes
    ``n_sentences >= 5`` for the 35 letters.
    """
    rng = np.random.default_rng(seed)
    texts: list[str] = []
    # groups are padded with wrap-around pairs so every cover sentence clears
    # the same 9-character floor as the sampled ones
    pairs = [LETTERS[i:i + 2] for i in range(0, len(LETTERS), 2)]
    cover = []
    for i in range(0, len(pairs), 4):
        group = pairs[i:i + 4]
        j = 0
        while len(" ".join(group)) < 9:
            group.append(pairs[j % len(pairs)])
            j += 1
        cover.append(" ".join(group))
    texts.extend(cover[: min(len(cover), n_sentences)])
    while len(texts) < n_sentences:
        texts.append(sample_sentence(rng, **kw))
    return texts, [render_text(t) for t in texts]


def write_corpus(out: Path, texts: list[str], wavs: list[np.ndarray]) -> list[dict]:
    """``out/wav/%05d.wav`` and ``out/metadata.json``; returns the records."""
    from oron_tts_tpu_torch.data.wav import write_wav

    (out / "wav").mkdir(parents=True, exist_ok=True)
    meta = []
    for i, (text, wav) in enumerate(zip(texts, wavs)):
        rel = f"wav/{i:05d}.wav"
        write_wav(out / rel, wav, SR)
        meta.append({"audio_path": str((out / rel).resolve()), "text": text, "lang": "mn",
                     "duration": len(wav) / SR})
    (out / "metadata.json").write_text(json.dumps(meta, ensure_ascii=False, indent=1))
    return meta


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Generate the tone-code alignment corpus")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--sentences", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-words", type=int, default=3,
                    help="min words per sentence (13 frames ≈ 0.139 s per char incl. "
                         "spaces; raise for longer clips)")
    ap.add_argument("--max-words", type=int, default=5)
    args = ap.parse_args(argv)

    texts, wavs = build_corpus(args.sentences, args.seed, min_words=args.min_words,
                               max_words=args.max_words)
    meta = write_corpus(args.out, texts, wavs)
    total_s = sum(m["duration"] for m in meta)
    print(f"wrote {len(meta)} clips ({total_s:.1f}s audio) to {args.out}")


if __name__ == "__main__":
    main()
