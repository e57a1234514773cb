"""Shared pieces of the vocoder tests: the same Vocos and discriminators in both
packages (carried weights), a seeded corpus, and tree comparisons."""

from __future__ import annotations

import functools

import jax
import numpy as np

from oron_tts_tpu.models.discriminators import VocoderDiscriminator as JaxDisc
from oron_tts_tpu.models.vocos import VocosDecoder as JaxVocos
from oron_tts_tpu.ops.mel import MelConfig as JaxMelConfig
from oron_tts_tpu_torch.models.discriminators import VocoderDiscriminator
from oron_tts_tpu_torch.models.vocos import VocosDecoder
from oron_tts_tpu_torch.ops.mel import MelConfig
from oron_tts_tpu_torch.utils.weights import from_flax_params

CFG, JCFG = MelConfig(), JaxMelConfig()
CROP = 8 * 256


def host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def tiny_vocoder(seed: int = 0):
    """A width-32 mag/phase Vocos in both packages with the JAX init's weights."""
    jm = JaxVocos(n_mels=100, dim=32, n_layers=1, intermediate_dim=96, head_mode="mag_phase")
    params = host(jm.init(jax.random.PRNGKey(seed), np.zeros((1, 100, 8), np.float32))["params"])
    tm = VocosDecoder(dim=32, n_layers=1, intermediate_dim=96, head_mode="mag_phase")
    tm.load_state_dict(from_flax_params(params), strict=True)
    return jm, params, tm


@functools.lru_cache(maxsize=1)
def bundled() -> tuple[dict, np.ndarray]:
    """The bundled Vocos's flax tree (dim 512, 8 blocks, mag/phase), and a seeded
    speech-like corpus of three 1 s clips."""
    from oron_tts_tpu_torch.cli.make_synthetic_speech import speech_clip
    from oron_tts_tpu_torch.models.f5tts import BUNDLED_VOCODER
    from oron_tts_tpu_torch.utils.weights import load_npz_tree

    params = load_npz_tree(BUNDLED_VOCODER)["params"]
    rng = np.random.default_rng(12)
    flat = np.concatenate([speech_clip(rng, 1.0) for _ in range(3)])
    return params, flat


def bundled_pair(params):
    jm = JaxVocos(n_mels=100, head_mode="mag_phase")
    tm = VocosDecoder(head_mode="mag_phase")
    tm.load_state_dict(from_flax_params(params), strict=True)
    return jm, tm


def tiny_disc(seed: int = 1):
    jd = JaxDisc(periods=(2,), resolutions=((512, 128),))
    params = host(jd.init(jax.random.PRNGKey(seed), np.zeros((2, CROP), np.float32))["params"])
    td = VocoderDiscriminator(periods=(2,), resolutions=((512, 128),))
    td.load_state_dict(from_flax_params(params), strict=True)
    return jd, params, td


def max_tree_diff(a, b) -> float:
    return max(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x, y: float(np.abs(np.asarray(x) - y).max()), a, b)))


def corpus(seed: int, n_crops: int = 6) -> np.ndarray:
    """Speech-like noise: a few decaying harmonics under an envelope, plus a floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_crops * CROP) / 24000
    x = sum(np.sin(2 * np.pi * rng.uniform(100, 3000) * t) / k for k in range(1, 5))
    x = x * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.05 * rng.standard_normal(t.shape)
    return (0.3 * x).astype(np.float32)
