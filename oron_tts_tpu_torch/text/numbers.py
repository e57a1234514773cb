"""Number-to-words normalization for Mongolian (Khalkha) and Kazakh Cyrillic.

Behavioral parity with the reference's src/utils/number_norm.py
(verified by tests/test_text_parity.py). Mongolian numerals carry a
standalone/attributive distinction ("тав" vs "таван мянга"); Kazakh forms are
invariant. The :meth:`NumberNormalizer.normalize_text` cascade runs, in order:
thousands separators, dates, times, temperatures, currency (suffix then
prefix), percents, decimals, fractions, phone numbers, ranges, ordinal
suffixes, genitive markers, Roman numerals, math symbols,
number-before-Cyrillic-noun (attributive), then bare cardinals.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Final

# A pair is (standalone, attributive). Kazakh pairs repeat the same word.
Pair = tuple[str, str]


def _same(w: str) -> Pair:
    return (w, w)


@dataclass(frozen=True)
class _NumSpec:
    ones: dict[int, Pair]
    ten: Pair
    tens: dict[int, Pair]
    hundred: Pair
    large: dict[int, Pair]
    ordinal_by_vowel: dict[str, str]
    ordinal_default: str
    zero: str
    minus: str
    point: str
    percent: str
    year_suffix: str
    month_suffix: str
    hour: str
    minute: str
    second: str
    degree: str
    half: str
    frac_template: str  # how to phrase n/d when not 1/2
    range_sep: str
    range_to: str
    sym_idx: int  # column in the bilingual symbol tables
    celsius: str = "цельсий"
    fahrenheit: str = "фаренгейт"


_MN_SPEC: Final[_NumSpec] = _NumSpec(
    ones={
        0: ("", ""),
        1: _same("нэг"),
        2: _same("хоёр"),
        3: ("гурав", "гурван"),
        4: ("дөрөв", "дөрвөн"),
        5: ("тав", "таван"),
        6: ("зургаа", "зургаан"),
        7: ("долоо", "долоон"),
        8: ("найм", "найман"),
        9: ("ес", "есөн"),
    },
    ten=("арав", "арван"),
    tens={
        2: ("хорь", "хорин"),
        3: ("гуч", "гучин"),
        4: ("дөч", "дөчин"),
        5: ("тавь", "тавин"),
        6: ("жар", "жаран"),
        7: ("дал", "далан"),
        8: ("ная", "наян"),
        9: ("ер", "ерэн"),
    },
    hundred=("зуу", "зуун"),
    large={
        1_000: ("мянга", "мянган"),
        1_000_000: _same("сая"),
        1_000_000_000: _same("тэрбум"),
        1_000_000_000_000: _same("их наяд"),
    },
    ordinal_by_vowel={
        "а": "дугаар", "о": "дугаар", "у": "дугаар", "ь": "дугаар",
        "э": "дүгээр", "ө": "дүгээр", "ү": "дүгээр", "и": "дүгээр", "е": "дүгээр",
    },
    ordinal_default="дугаар",
    zero="тэг",
    minus="хасах",
    point="цэг",
    percent="хувь",
    year_suffix="оны",
    month_suffix="сарын",
    hour="цаг",
    minute="минут",
    second="секунд",
    degree="градус",
    half="хагас",
    frac_template="mn_ordinal_genitive",
    range_sep="аас",
    range_to="хүртэл",
    sym_idx=0,
)

_KZ_SPEC: Final[_NumSpec] = _NumSpec(
    ones={
        0: ("", ""),
        1: _same("бір"),
        2: _same("екі"),
        3: _same("үш"),
        4: _same("төрт"),
        5: _same("бес"),
        6: _same("алты"),
        7: _same("жеті"),
        8: _same("сегіз"),
        9: _same("тоғыз"),
    },
    ten=_same("он"),
    tens={
        2: _same("жиырма"),
        3: _same("отыз"),
        4: _same("қырық"),
        5: _same("елу"),
        6: _same("алпыс"),
        7: _same("жетпіс"),
        8: _same("сексен"),
        9: _same("тоқсан"),
    },
    hundred=_same("жүз"),
    large={
        1_000: _same("мың"),
        1_000_000: _same("миллион"),
        1_000_000_000: _same("миллиард"),
    },
    ordinal_by_vowel={v: "нші" for v in "аеыіоөұү"},
    ordinal_default="нші",
    zero="нөл",
    minus="минус",
    point="бүтін",
    percent="пайыз",
    year_suffix="жылдың",
    month_suffix="айдың",
    hour="сағат",
    minute="минут",
    second="секунд",
    degree="градус",
    half="жарты",
    frac_template="kz_den",
    range_sep="ден",
    range_to="дейін",
    sym_idx=1,
)

SUPPORTED_LANGS: Final[frozenset[str]] = frozenset({"mn", "kz"})
_SPECS: Final[dict[str, _NumSpec]] = {"mn": _MN_SPEC, "kz": _KZ_SPEC}

# symbol -> (MN word, KZ word)
CURRENCY_SYMBOLS: Final[dict[str, Pair]] = {
    "₮": _same("төгрөг"),
    "₸": _same("теңге"),
    "$": _same("доллар"),
    "€": _same("евро"),
    "£": _same("фунт"),
    "¥": _same("иен"),
    "₽": _same("рубль"),
}

CURRENCY_CODES: Final[dict[str, Pair]] = {
    "MNT": _same("төгрөг"),
    "KZT": _same("теңге"),
    "USD": _same("доллар"),
    "EUR": _same("евро"),
    "GBP": _same("фунт"),
    "JPY": _same("иен"),
    "CNY": _same("юань"),
    "RUB": _same("рубль"),
    "KRW": _same("вон"),
}

MATH_SYMBOLS: Final[dict[str, Pair]] = {
    "+": ("нэмэх", "қосу"),
    "×": ("үржүүлэх", "көбейту"),
    "÷": ("хуваах", "бөлу"),
    "=": ("тэнцүү", "тең"),
    "≠": ("тэнцүү биш", "тең емес"),
    "<": ("бага", "кіші"),
    ">": ("их", "үлкен"),
    "≤": ("бага буюу тэнцүү", "кіші немесе тең"),
    "≥": ("их буюу тэнцүү", "үлкен немесе тең"),
    "±": ("нэмэх хасах", "плюс минус"),
    "~": ("ойролцоогоор", "шамамен"),
}

_ROMAN_TABLE: Final[tuple[tuple[str, int], ...]] = (
    ("M", 1000), ("CM", 900), ("D", 500), ("CD", 400),
    ("C", 100), ("XC", 90), ("L", 50), ("XL", 40),
    ("X", 10), ("IX", 9), ("V", 5), ("IV", 4), ("I", 1),
)
_ROMAN_RE: Final[re.Pattern[str]] = re.compile(
    r"\b(M{0,3}(?:CM|CD|D?C{0,3})(?:XC|XL|L?X{0,3})(?:IX|IV|V?I{0,3}))\b"
)

_CURRENCY_SYM_ALT: Final[str] = "|".join(re.escape(s) for s in CURRENCY_SYMBOLS)
_CURRENCY_CODE_ALT: Final[str] = "|".join(CURRENCY_CODES)


def roman_to_int(s: str) -> int | None:
    """Greedy Roman-numeral parse; None if ``s`` is empty or malformed."""
    if not s:
        return None
    total, pos = 0, 0
    for prefix, value in _ROMAN_TABLE:
        while s[pos: pos + len(prefix)] == prefix:
            total += value
            pos += len(prefix)
    return total if pos == len(s) and total > 0 else None


def _validate(lang: str) -> str:
    if lang not in SUPPORTED_LANGS:
        supported = ", ".join(sorted(SUPPORTED_LANGS))
        raise ValueError(f"Unsupported language '{lang}'. Expected one of: {supported}")
    return lang


def _cardinal_words(n: int, spec: _NumSpec, attr: bool) -> str:
    """Cardinal for n >= 1 (0 handled by callers)."""
    idx = 1 if attr else 0

    def under_100(m: int) -> str:
        if m == 0:
            return ""
        if m < 10:
            return spec.ones[m][idx]
        if m == 10:
            return spec.ten[idx]
        if m < 20:
            return f"{spec.ten[1]} {spec.ones[m - 10][idx]}"
        t, o = divmod(m, 10)
        if o == 0:
            return spec.tens[t][idx]
        return f"{spec.tens[t][1]} {spec.ones[o][idx]}"

    def under_1000(m: int) -> str:
        if m < 100:
            return under_100(m)
        h, r = divmod(m, 100)
        head = spec.hundred[1] if h == 1 else f"{spec.ones[h][1]} {spec.hundred[1]}"
        if r == 0:
            # terminal hundreds take the requested form
            return spec.hundred[idx] if h == 1 else f"{spec.ones[h][1]} {spec.hundred[idx]}"
        return f"{head} {under_100(r)}"

    if n < 1000:
        return under_1000(n)

    parts: list[str] = []
    remaining = n
    for scale in sorted(spec.large, reverse=True):
        if remaining < scale:
            continue
        count, remaining = divmod(remaining, scale)
        base, attr_form = spec.large[scale]
        # the scale word is attributive only when it terminates the number
        scale_word = attr_form if (attr and remaining == 0) else base
        if count == 1:
            parts.append(scale_word)
        else:
            parts.append(f"{_cardinal_words(count, spec, attr=True)} {scale_word}")
    if remaining > 0:
        parts.append(under_1000(remaining))
    return " ".join(parts)


class NumberNormalizer:
    """Convert digits/dates/currency/etc. in text to spoken-form words."""

    def __init__(self, lang: str = "mn") -> None:
        self._lang = _validate(lang)
        self._spec = _SPECS[self._lang]
        self._memo: dict[tuple[str, int, bool], str] = {}

    @property
    def lang(self) -> str:
        return self._lang

    @lang.setter
    def lang(self, value: str) -> None:
        value = _validate(value)
        if value != self._lang:
            self._lang = value
            self._spec = _SPECS[value]

    # ── cardinal / ordinal forms ──────────────────────────────────────────

    def _convert(self, n: int, attr: bool) -> str:
        key = (self._lang, n, attr)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        if n == 0:
            result = self._spec.zero
        elif n < 0:
            result = f"{self._spec.minus} {self._convert(-n, attr)}"
        else:
            result = _cardinal_words(n, self._spec, attr)
        self._memo[key] = result
        return result

    def convert(self, n: int) -> str:
        """Standalone cardinal (terminal position)."""
        return self._convert(n, attr=False)

    def convert_attributive(self, n: int) -> str:
        """Attributive cardinal (before a noun / unit word)."""
        return self._convert(n, attr=True)

    def convert_ordinal(self, n: int) -> str:
        """Standalone cardinal + vowel-harmony ordinal suffix, attached."""
        word = self.convert(n)
        suffix = self._ordinal_suffix(word)
        return f"{word}{suffix}"

    def _ordinal_suffix(self, word: str) -> str:
        for ch in reversed(word.lower()):
            mapped = self._spec.ordinal_by_vowel.get(ch)
            if mapped is not None:
                return mapped
        return self._spec.ordinal_default

    # ── helpers ───────────────────────────────────────────────────────────

    def _digits_spoken(self, digits: str) -> str:
        return " ".join(self.convert(int(d)) for d in digits)

    def _currency_word(self, token: str) -> str:
        pair = CURRENCY_SYMBOLS.get(token) or CURRENCY_CODES.get(token.upper())
        return pair[self._spec.sym_idx] if pair else token

    # ── full-text cascade ─────────────────────────────────────────────────

    def normalize_text(self, text: str) -> str:  # noqa: C901
        spec = self._spec

        # thousands separators: "1,234,567" / "1 234 567" → "1234567".
        # Digit-boundary guards (absent in the reference,
        # number_norm.py:385) stop two ADJACENT independent numbers from
        # merging: "2023 150 хүн" must stay two numbers, and "+976 1234"
        # phone prefixes must not lose their grouping
        text = re.sub(
            r"(?<!\d)(\d{1,3})(?:[ ,](\d{3}))+(?!\d)",
            lambda m: m.group(0).replace(",", "").replace(" ", ""),
            text,
        )

        def spoken_date(y: int, mo: int, d: int) -> str:
            return (
                f"{self.convert_attributive(y)} {spec.year_suffix} "
                f"{self.convert_ordinal(mo)} {spec.month_suffix} "
                f"{self.convert(d)}"
            )

        text = re.sub(
            r"(\d{4})[/.\-](\d{1,2})[/.\-](\d{1,2})",
            lambda m: spoken_date(int(m.group(1)), int(m.group(2)), int(m.group(3))),
            text,
        )
        text = re.sub(
            r"(\d{1,2})[/.\-](\d{1,2})[/.\-](\d{4})",
            lambda m: spoken_date(int(m.group(3)), int(m.group(2)), int(m.group(1))),
            text,
        )

        def spoken_time(m: re.Match[str]) -> str:
            parts = [
                f"{self.convert_attributive(int(m.group(1)))} {spec.hour}",
                f"{self.convert_attributive(int(m.group(2)))} {spec.minute}",
            ]
            if m.group(3) is not None:
                parts.append(f"{self.convert_attributive(int(m.group(3)))} {spec.second}")
            return " ".join(parts)

        text = re.sub(r"(\d{1,2}):(\d{2})(?::(\d{2}))?", spoken_time, text)

        def spoken_temp(m: re.Match[str]) -> str:
            words: list[str] = []
            if m.group(1) == "-":
                words.append(spec.minus)
            words.append(f"{self.convert_attributive(int(m.group(2)))} {spec.degree}")
            unit = m.group(3)
            if unit and unit.upper() == "C":
                words.append(spec.celsius)
            elif unit and unit.upper() == "F":
                words.append(spec.fahrenheit)
            return " ".join(words)

        text = re.sub(r"(-?)(\d+)°\s*([CcFf])?", spoken_temp, text)

        # currency, number-first: 100₮ / 100 USD
        text = re.sub(
            rf"(\d+)\s*({_CURRENCY_SYM_ALT}|(?:{_CURRENCY_CODE_ALT})(?!\w))",
            lambda m: f"{self.convert_attributive(int(m.group(1)))} "
            f"{self._currency_word(m.group(2))}",
            text,
        )
        # currency, symbol-first: $100
        text = re.sub(
            rf"({_CURRENCY_SYM_ALT})\s*(\d+)",
            lambda m: f"{self.convert_attributive(int(m.group(2)))} "
            f"{self._currency_word(m.group(1))}",
            text,
        )

        text = re.sub(
            r"(\d+)%",
            lambda m: f"{self.convert_attributive(int(m.group(1)))} {spec.percent}",
            text,
        )

        # decimals: integer + point word + digit-by-digit fraction
        text = re.sub(
            r"(\d+)\.(\d+)",
            lambda m: f"{self.convert(int(m.group(1)))} {spec.point} "
            f"{self._digits_spoken(m.group(2))}",
            text,
        )

        def spoken_fraction(m: re.Match[str]) -> str:
            num, den = int(m.group(1)), int(m.group(2))
            if num == 1 and den == 2:
                return spec.half
            if spec.frac_template == "mn_ordinal_genitive":
                ordinal = self.convert_ordinal(den)
                genitive = ordinal + ("ийн" if ordinal.endswith("дүгээр") else "ын")
                return f"{genitive} {self.convert(num)}"
            return f"{self.convert(den)} ден {self.convert(num)}"

        text = re.sub(r"(\d{1,2})/(\d{1,2})", spoken_fraction, text)

        plus_word = MATH_SYMBOLS["+"][spec.sym_idx]
        text = re.sub(
            r"\+\d[\d\s\-]{6,15}\d",
            lambda m: f"{plus_word} "
            + self._digits_spoken(re.sub(r"\D", "", m.group(0)[1:])),
            text,
        )

        text = re.sub(
            r"(\d+)\s*[-–—]\s*(\d+)",
            lambda m: f"{self.convert(int(m.group(1)))} {spec.range_sep} "
            f"{self.convert(int(m.group(2)))} {spec.range_to}",
            text,
        )

        for pattern in (r"(\d+)-р\b", r"(\d+)-д(?:угаар|үгээр|ахь)", r"(\d+)-(?:ші|шы)"):
            text = re.sub(pattern, lambda m: self.convert_ordinal(int(m.group(1))), text)

        # genitive markers → attributive cardinal
        text = re.sub(
            r"(\d+)-(?:ны|ний|ын|ийн)\b",
            lambda m: self.convert_attributive(int(m.group(1))),
            text,
        )

        def spoken_roman(m: re.Match[str]) -> str:
            value = roman_to_int(m.group(1))
            return m.group(0) if value is None else self.convert_ordinal(value)

        text = _ROMAN_RE.sub(spoken_roman, text)

        for sym, words in MATH_SYMBOLS.items():
            if sym in text:
                text = text.replace(sym, f" {words[spec.sym_idx]} ")

        # number immediately before a Cyrillic word → attributive.
        # ө (U+04E9) and ү (U+04AF) sit OUTSIDE the а-я codepoint range;
        # the reference's class (number_norm.py:555) omits them, so "3
        # өдөр" fell through to a standalone cardinal — grammatically
        # wrong for every ө/ү-initial noun (өдөр, өглөө, үнэ, үй)
        text = re.sub(
            r"(\d+)(?=\s+[а-яёөүәғқңұһі])",
            lambda m: self.convert_attributive(int(m.group(1))),
            text,
        )

        # whatever digits remain → standalone cardinals
        text = re.sub(r"\d+", lambda m: self.convert(int(m.group(0))), text)

        return text
