"""Pure-Python text stack (cleaner, number normalizer, tokenizer, alignment).

A copy of the JAX package's framework-free text modules: the port imports
nothing of that package, so the two stay numerically identical by test
(tests/test_torch_slice.py), not by sharing code.
"""

from oron_tts_tpu_torch.text.cleaner import TextCleaner
from oron_tts_tpu_torch.text.numbers import NumberNormalizer
from oron_tts_tpu_torch.text.tokenizer import (
    SPECIAL_TOKENS,
    VOCAB,
    VOCAB_SIZE,
    CyrillicTokenizer,
    validate_language,
)

__all__ = [
    "TextCleaner",
    "NumberNormalizer",
    "CyrillicTokenizer",
    "validate_language",
    "SPECIAL_TOKENS",
    "VOCAB",
    "VOCAB_SIZE",
]
