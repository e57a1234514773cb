"""Character-level Cyrillic tokenizer for Mongolian (Khalkha) and Kazakh.

Vocabulary contract (65 entries, parity with reference
the reference's src/utils/tokenizer.py:16-55):

  IDs 0-10   special tokens: <PAD> <BOS> <EOS> <UNK> [LANG_MN] [LANG_KZ]
             [FEMALE] [MALE] [YOUNG] [MIDDLE] [ELDERLY]
  IDs 11-45  Mongolian Khalkha Cyrillic lowercase (35 chars)
  IDs 46-52  Kazakh-only additions (7 chars)
  IDs 53-64  punctuation + space (12 chars)

Encoding layout: ``[LANG_*] [attr tokens...] [chars...]``; BOS/EOS are
reserved IDs but never emitted. Unknown characters map to <UNK>.
"""

from __future__ import annotations

from typing import Final

SUPPORTED_LANGS: Final[frozenset[str]] = frozenset({"mn", "kz"})

PAD_TOKEN: Final[str] = "<PAD>"
BOS_TOKEN: Final[str] = "<BOS>"
EOS_TOKEN: Final[str] = "<EOS>"
UNK_TOKEN: Final[str] = "<UNK>"
LANG_TOKENS: Final[dict[str, str]] = {"mn": "[LANG_MN]", "kz": "[LANG_KZ]"}

#: Attribute tags usable for programmatic speaker conditioning.
ATTR_TOKEN_NAMES: Final[tuple[str, ...]] = (
    "[FEMALE]",
    "[MALE]",
    "[YOUNG]",
    "[MIDDLE]",
    "[ELDERLY]",
)

SPECIAL_TOKENS: Final[list[str]] = [
    PAD_TOKEN,
    BOS_TOKEN,
    EOS_TOKEN,
    UNK_TOKEN,
    LANG_TOKENS["mn"],
    LANG_TOKENS["kz"],
    *ATTR_TOKEN_NAMES,
]

MN_CHARS: Final[str] = "абвгдеёжзийклмноөпрстуүфхцчшщъыьэюя"
KZ_EXTRA_CHARS: Final[str] = "әғқңұһі"
PUNCT_CHARS: Final[str] = " .,!?-:;\"'()"

VOCAB: Final[tuple[str, ...]] = tuple(
    SPECIAL_TOKENS + list(MN_CHARS + KZ_EXTRA_CHARS + PUNCT_CHARS)
)

VOCAB_SIZE: Final[int] = len(VOCAB)
assert VOCAB_SIZE == 65, f"vocabulary contract broken: {VOCAB_SIZE} != 65"


def validate_language(lang: str) -> str:
    """Return ``lang`` if supported, else raise ValueError."""
    if lang not in SUPPORTED_LANGS:
        supported = ", ".join(sorted(SUPPORTED_LANGS))
        raise ValueError(f"Unsupported language '{lang}'. Expected one of: {supported}")
    return lang


class CyrillicTokenizer:
    """Bidirectional char <-> ID mapping over the fixed 65-token vocabulary."""

    __slots__ = ("_id_of", "_tok_of", "pad_id", "bos_id", "eos_id", "unk_id")

    def __init__(self) -> None:
        self._id_of: dict[str, int] = {t: i for i, t in enumerate(VOCAB)}
        self._tok_of: dict[int, str] = {i: t for i, t in enumerate(VOCAB)}
        self.pad_id = self._id_of[PAD_TOKEN]
        self.bos_id = self._id_of[BOS_TOKEN]
        self.eos_id = self._id_of[EOS_TOKEN]
        self.unk_id = self._id_of[UNK_TOKEN]

    @property
    def vocab_size(self) -> int:
        return VOCAB_SIZE

    def encode(
        self,
        text: str,
        lang: str = "mn",
        attr_tokens: list[str] | None = None,
    ) -> list[int]:
        """Encode normalized lowercase text as ``[lang, attrs..., chars...]``."""
        lang = validate_language(lang)
        out = [self._id_of[LANG_TOKENS[lang]]]
        if attr_tokens:
            out.extend(self._id_of.get(a, self.unk_id) for a in attr_tokens)
        out.extend(self._id_of.get(c, self.unk_id) for c in text)
        return out

    def decode(self, ids: list[int]) -> str:
        pieces = (self._tok_of.get(i, UNK_TOKEN) for i in ids)
        return "".join(p for p in pieces if p not in SPECIAL_TOKENS)

    def token_to_id(self, token: str) -> int:
        return self._id_of.get(token, self.unk_id)

    def id_to_token(self, idx: int) -> str:
        return self._tok_of.get(idx, UNK_TOKEN)
