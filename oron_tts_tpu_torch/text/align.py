"""Text-to-frame alignment: the single home of the stretching contract.

Token j appears at frames [j·T/N, (j+1)·T/N) so every mel frame carries a
real text token (F5-TTS convention; reference src/data/dataset.py:63-76).
Used identically by training (dataset) and inference (facade) — keep ONE
definition so the two paths can never drift.
"""

from __future__ import annotations


def stretch_text_to_len(token_ids: list[int], target_len: int) -> list[int]:
    n = len(token_ids)
    if n == 0:
        return [-1] * target_len
    if n >= target_len:
        return token_ids[:target_len]
    return [token_ids[i * n // target_len] for i in range(target_len)]
