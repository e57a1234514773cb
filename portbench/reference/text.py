"""Text front end of the plain reference: cleaning, tokens, chunks, durations, alignment.

A frozen copy of the contract the served model follows (F5-TTS over a
65-entry Cyrillic character vocabulary): NFC, typographic punctuation
folded, abbreviations expanded, characters outside the vocabulary dropped,
whitespace collapsed, repeated punctuation folded, lower case, then
``[LANG] chars...`` ids. The benchmark's texts hold Cyrillic letters,
spaces, commas and full stops only, so number normalisation never fires;
:func:`clean` refuses a text with a digit or a Latin letter rather than
guess at it.

Durations: ``max(50, letters·13 / speed)`` frames without a reference, and
``max(50, ref_frames·len(ids) / len(ref_ids) / speed)`` with one. Long
texts are split at 120 characters near punctuation or a space, and chunks
are joined with 0.25 s of silence.
"""

from __future__ import annotations

import re
import unicodedata

SPECIAL = ["<PAD>", "<BOS>", "<EOS>", "<UNK>", "[LANG_MN]", "[LANG_KZ]",
           "[FEMALE]", "[MALE]", "[YOUNG]", "[MIDDLE]", "[ELDERLY]"]
MN_CHARS = "абвгдеёжзийклмноөпрстуүфхцчшщъыьэюя"
KZ_EXTRA_CHARS = "әғқңұһі"
PUNCT_CHARS = " .,!?-:;\"'()"
VOCAB = SPECIAL + list(MN_CHARS + KZ_EXTRA_CHARS + PUNCT_CHARS)
ID_OF = {t: i for i, t in enumerate(VOCAB)}
LANG_TOKEN = {"mn": "[LANG_MN]", "kz": "[LANG_KZ]"}

ALLOWED = frozenset(MN_CHARS + MN_CHARS.upper() + KZ_EXTRA_CHARS + KZ_EXTRA_CHARS.upper()
                    + PUNCT_CHARS)
PUNCTUATION_MAP = {"…": "...", "–": "-", "—": "-", "«": '"', "»": '"', "“": '"', "”": '"',
                   "‘": "'", "„": '"'}
ABBREVIATIONS = {
    "mn": {"г.": "оны", "км": "километр", "см": "сантиметр", "кг": "килограмм",
           "мл": "миллилитр", "т.": "товч", "тов.": "товч", "ж.": "жил", "сар.": "сар",
           "өд.": "өдөр", "мин.": "минут", "сек.": "секунд", "цаг.": "цаг"},
    "kz": {"ж.": "жыл", "км": "километр", "см": "сантиметр", "кг": "килограмм",
           "мл": "миллилитр", "мин.": "минут", "сек.": "секунд", "сағ.": "сағат"},
}

MAX_CHARS_PER_CHUNK = 120
PAUSE_S = 0.25
FRAMES_PER_LETTER = 13
MIN_FRAMES = 50


def clean(text: str, lang: str) -> str:
    if re.search(r"[0-9A-Za-z]", text):
        raise ValueError("the reference front end takes no digits or Latin letters")
    text = unicodedata.normalize("NFC", text)
    for src, dst in PUNCTUATION_MAP.items():
        text = text.replace(src, dst)
    for abbr, full in ABBREVIATIONS[lang].items():
        text = re.sub(rf"(?<!\w){re.escape(abbr)}(?!\w)", full, text, flags=re.IGNORECASE)
    text = "".join(c for c in text if c in ALLOWED)
    text = re.sub(r"\s+", " ", text).strip()
    text = re.sub(r"([.!?,]){2,}", r"\1", text)
    return text.lower()


def token_ids(text: str, lang: str) -> list[int]:
    return [ID_OF[LANG_TOKEN[lang]]] + [ID_OF.get(c, ID_OF["<UNK>"]) for c in clean(text, lang)]


def split_text(text: str, max_chars: int = MAX_CHARS_PER_CHUNK) -> list[str]:
    """Chunks near a full stop, then a comma, then a space, of at most ``max_chars``."""
    rest = re.sub(r"\s+", " ", text).strip()
    chunks = []
    while len(rest) > max_chars:
        upper, lower = min(max_chars, len(rest)), max(1, int(max_chars * 0.55))
        cut = upper
        for breaks in (".!?…", ",;:", " "):
            hit = next((i for i in range(upper, lower, -1) if rest[i - 1] in breaks), None)
            if hit is not None:
                cut = hit
                break
        if rest[:cut].strip():
            chunks.append(rest[:cut].strip())
        rest = rest[cut:].strip()
    if rest:
        chunks.append(rest)
    return chunks


def target_frames(chunk: str, ids: list[int], ref_frames: int = 0,
                  ref_ids: list[int] | None = None, speed: float = 1.0) -> int:
    if ref_frames > 0 and ref_ids:
        return max(MIN_FRAMES, int(ref_frames * len(ids) / len(ref_ids) / speed))
    return max(MIN_FRAMES, int(max(1, len(chunk.replace(" ", ""))) * FRAMES_PER_LETTER / speed))


def stretch(ids: list[int], length: int) -> list[int]:
    """Token j covers frames [j·T/N, (j+1)·T/N)."""
    n = len(ids)
    if n == 0:
        return [-1] * length
    if n >= length:
        return ids[:length]
    return [ids[i * n // length] for i in range(length)]
