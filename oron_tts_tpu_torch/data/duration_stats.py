"""Per-token duration calibration for ref-free synthesis.

The reference estimates ref-free duration as ``chars * 13 / speed``
(the reference F5-TTS facade, f5tts.py:365-375) — a fixed constant that is
~3.7x worse on the repo's own alignment eval than synthesizing at the true
duration (ALIGNMENT.json r4: CER 0.33 vs 0.089). This module learns the
constant from the training corpus instead: a ridge least-squares fit of

    n_frames(clip) ~= sum_i fpc[token_id_i]

over the tokenized training texts, giving every vocabulary token its own
frames-per-occurrence. The language tag and attribute tokens participate
like any other id, so they absorb per-language/per-speaker bias terms.
Tokens seen fewer than ``min_count`` times fall back to the global mean;
with no calibration at all the facade keeps the reference's 13.

The fitted table rides the training config (``duration_stats``) into
``config.json`` next to every checkpoint, so inference picks it up with
zero user action (cli/infer.load_model -> F5TTS.set_duration_stats).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

REFERENCE_FPC = 13.0  # reference fallback: chars*13 (f5tts.py:373)
FPC_MIN, FPC_MAX = 2.0, 64.0  # sane per-token bounds (≈21 ms .. 683 ms)


def fit_duration_table(
    id_seqs: Sequence[Sequence[int]],
    frames: Sequence[float],
    vocab_size: int = 65,
    ridge: float = 1.0,
    min_count: int = 5,
) -> dict[str, Any]:
    """Fit per-token frames-per-occurrence from (token ids, mel frames).

    Returns ``{"fpc": [vocab_size floats], "global": float, "n": int}``.
    ``global`` is total frames / total tokens — the fallback for rare or
    unseen tokens. Ridge regularization pulls ill-determined ids toward
    the global mean instead of zero (the target is centered before the
    solve), so collinear token counts stay stable.
    """
    n = len(id_seqs)
    if n == 0 or n != len(frames):
        raise ValueError("id_seqs and frames must be equal-length, nonempty")
    counts = np.zeros((n, vocab_size), np.float64)
    for row, ids in enumerate(id_seqs):
        for t in ids:
            if 0 <= t < vocab_size:
                counts[row, t] += 1.0
    y = np.asarray(frames, np.float64)
    tok_totals = counts.sum(axis=0)
    total_tokens = float(tok_totals.sum())
    if total_tokens <= 0:
        raise ValueError("no tokens in id_seqs")
    global_fpc = float(np.clip(y.sum() / total_tokens, FPC_MIN, FPC_MAX))

    # center on the global-mean prediction; ridge then shrinks deltas to 0
    resid = y - counts @ np.full(vocab_size, global_fpc)
    gram = counts.T @ counts + ridge * np.eye(vocab_size)
    delta = np.linalg.solve(gram, counts.T @ resid)
    fpc = np.clip(global_fpc + delta, FPC_MIN, FPC_MAX)
    fpc = np.where(tok_totals >= min_count, fpc, global_fpc)
    return {
        "fpc": [round(float(v), 3) for v in fpc],
        "global": round(global_fpc, 3),
        "n": n,
    }


def estimate_frames(
    ids: Sequence[int], stats: dict[str, Any] | None, speed: float = 1.0
) -> int | None:
    """Calibrated duration for a token sequence; None without stats.

    Matches the reference cascade's contract: integer frames, floor 50
    (f5tts.py:373-375).
    """
    if not stats or not stats.get("fpc"):
        return None
    fpc = stats["fpc"]
    fallback = float(stats.get("global", REFERENCE_FPC))
    total = 0.0
    for t in ids:
        total += fpc[t] if 0 <= t < len(fpc) else fallback
    return max(50, int(total / max(speed, 1e-6)))


def stats_from_texts(
    texts: Sequence[str],
    langs: Sequence[str] | str,
    durations_s: Sequence[float],
    sample_rate: int,
    hop_length: int,
    cleaner: Any | None = None,
    max_samples: int = 50_000,
) -> dict[str, Any] | None:
    """Tokenize training texts and fit the table; None on failure.

    Failure-tolerant by design: duration calibration is an enhancement on
    top of reference behavior, and a corpus quirk (all-empty texts, an
    unknown language tag) must never kill a training run.
    """
    try:
        from oron_tts_tpu_torch.text.cleaner import TextCleaner

        cleaner = cleaner or TextCleaner()
        if isinstance(langs, str):
            langs = [langs] * len(texts)
        ids_seqs, frames = [], []
        for text, lang, dur in list(zip(texts, langs, durations_s))[
            :max_samples
        ]:
            ids = cleaner.text_to_sequence(text, lang=lang or "mn")
            if ids:
                ids_seqs.append(ids)
                frames.append(dur * sample_rate / hop_length)
        if len(ids_seqs) < 8:
            return None
        return fit_duration_table(ids_seqs, frames)
    except Exception:  # noqa: BLE001 — calibration must never break training
        return None
