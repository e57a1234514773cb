"""PyTorch port, Griffin-Lim and the torch-layout Vocos against the JAX package (CPU).

``oron_tts_tpu_torch/ops/griffin_lim.py`` is the JAX op on ``torch.fft``:
with the JAX initial phase passed in, the waveform must be JAX's. Then the
facade's vocoder choices: ``"griffin_lim"`` (by argument or
``ORON_VOCOS_CKPT``), a torch Vocos file in the official layout (written here
from seeded tensors), a missing path and a hub id.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oron_tts_tpu.evals.alignment import render_text
from oron_tts_tpu.models import f5tts as jf5
from oron_tts_tpu.ops import griffin_lim as jgl
from oron_tts_tpu.ops.mel import MelConfig as JMelConfig
from oron_tts_tpu.ops.mel import log_mel_numpy
from oron_tts_tpu_torch.models import f5tts as tf5
from oron_tts_tpu_torch.ops import griffin_lim as tgl
from oron_tts_tpu_torch.ops.mel import MelConfig

TINY = {
    "sample_rate": 24000, "n_fft": 1024, "hop_length": 256, "n_mels": 100,
    "model": {"vocab_size": 65, "dim": 64, "depth": 2, "heads": 2, "ff_mult": 2,
              "text_dim": 32, "conv_layers": 2, "p_dropout": 0.0},
}
MAG_RTOL = 1e-5   # of the largest magnitude: one f32 product over 100 mels
WAV_RTOL = 1e-4   # of the waveform's largest value: f32 FFTs in another order, iterated
VOC_RTOL = 1e-5   # of the waveform's largest value: the same f32 network on the CPU


def _log_mel() -> np.ndarray:
    """[1, 100, T] log-mel of a rendered sentence (tones, silence, edges)."""
    return log_mel_numpy(render_text("сайн уу"), JMelConfig())[None, :, :60]


def _rel_err(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def test_mel_to_linear_matches_jax():
    mel = _log_mel()
    got = tgl.mel_to_linear(torch.from_numpy(mel), MelConfig()).numpy()
    ref = np.asarray(jgl.mel_to_linear(jnp.asarray(mel), JMelConfig()))
    assert got.shape == ref.shape == (1, 513, 60)
    assert _rel_err(got, ref) <= MAG_RTOL
    assert got.min() >= 0.0


@pytest.mark.parametrize("n_iter", [0, 1, 4])
def test_griffin_lim_with_the_jax_phase_matches_jax(n_iter):
    mel = _log_mel()
    shape = (1, 513, mel.shape[-1])
    phase = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape,
                                          minval=-np.pi, maxval=np.pi))
    ref = np.asarray(jgl.griffin_lim(jnp.asarray(mel), JMelConfig(), n_iter=n_iter, seed=0))
    got = tgl.griffin_lim(torch.from_numpy(mel), MelConfig(), n_iter=n_iter,
                          init_phase=torch.from_numpy(phase)).numpy()
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= WAV_RTOL


def test_griffin_lim_lengths_and_seeded_phase():
    """Iteration at (T−1)·hop, whose re-STFT has T frames; the render at T·hop."""
    mel = torch.from_numpy(_log_mel())
    T, hop = mel.shape[-1], 256
    re, im = tgl._stft_re_im(torch.zeros(1, (T - 1) * hop), MelConfig())
    assert re.shape == im.shape == (1, 513, T)
    out = tgl.griffin_lim(mel, MelConfig(), n_iter=2, seed=3)
    assert out.shape == (1, T * hop) and torch.isfinite(out).all()
    assert torch.equal(out, tgl.griffin_lim(mel, MelConfig(), n_iter=2, seed=3))
    assert not torch.equal(out, tgl.griffin_lim(mel, MelConfig(), n_iter=2, seed=4))
    # the explicit phase is the seeded draw
    g = torch.Generator().manual_seed(3)
    phase = torch.rand((1, 513, T), generator=g) * (2 * math.pi) - math.pi
    assert torch.equal(out, tgl.griffin_lim(mel, MelConfig(), n_iter=2, init_phase=phase))


def _model():
    model = tf5.F5TTS.from_config(TINY, device="cpu")
    model.init_params(0)
    return model


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_load_vocoder_griffin_lim(how, monkeypatch):
    model = _model()
    if how == "argument":
        model.load_vocoder("griffin_lim")
    else:
        monkeypatch.setenv("ORON_VOCOS_CKPT", "griffin_lim")
        model.load_vocoder()
    assert model.vocoder == "griffin_lim"
    mel = torch.from_numpy(np.concatenate([_log_mel(), _log_mel()[..., ::-1].copy()]))
    lens = [60, 37]
    out = model._decode_mel_group(mel, lens)
    assert out.shape == (2, model._bucket(60) * 256)
    for i, n in enumerate(lens):
        ref = tgl.griffin_lim(mel[i: i + 1, :, :n], MelConfig(), n_iter=32)[0]
        assert torch.equal(out[i, : n * 256], ref)
        assert not out[i, n * 256:].any()
    wav = model._decode_mel(mel[:1])
    assert wav.shape == (60 * 256,) and np.array_equal(wav, out[0, : 60 * 256].numpy())


def _official_vocos(dim=64, inter=128, n_layers=2, n_fft=1024) -> dict:
    """Seeded tensors in the official Vocos layout (layer-scale gamma included)."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape, std=0.1):
        return torch.randn(*shape, generator=g) * std

    sd = {"backbone.embed.weight": rand(dim, 100, 7), "backbone.embed.bias": rand(dim),
          "backbone.norm.weight": 1 + rand(dim), "backbone.norm.bias": rand(dim),
          "backbone.final_layer_norm.weight": 1 + rand(dim),
          "backbone.final_layer_norm.bias": rand(dim),
          "head.out.weight": rand(n_fft + 2, dim, std=0.05), "head.out.bias": rand(n_fft + 2)}
    for i in range(n_layers):
        b = f"backbone.convnext.{i}"
        sd |= {f"{b}.dwconv.weight": rand(dim, 1, 7), f"{b}.dwconv.bias": rand(dim),
               f"{b}.norm.weight": 1 + rand(dim), f"{b}.norm.bias": rand(dim),
               f"{b}.pwconv1.weight": rand(inter, dim), f"{b}.pwconv1.bias": rand(inter),
               f"{b}.pwconv2.weight": rand(dim, inter), f"{b}.pwconv2.bias": rand(dim),
               f"{b}.gamma": 0.5 + rand(dim)}
    return sd


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_torch_vocos_file_decodes_as_jax(tmp_path, suffix):
    from oron_tts_tpu_torch.utils.torch_compat import save_safetensors

    path = tmp_path / f"vocos{suffix}"
    sd = _official_vocos()
    if suffix == ".pt":
        torch.save(sd, path)
    else:
        save_safetensors(sd, path)
    mel = _log_mel()
    model = _model()
    model.load_vocoder(path)
    assert model.vocoder.head_mode == "mag_phase" and model.vocoder.block0.gamma is not None
    got = model._decode_mel(torch.from_numpy(mel))
    jmodel = jf5.F5TTS.from_config(TINY)
    jmodel.load_vocoder(str(tmp_path / "vocos.pt") if suffix == ".pt" else str(path))
    ref = np.asarray(jmodel._decode_mel(jnp.asarray(mel)))
    assert got.shape == ref.shape == (60 * 256,)
    assert _rel_err(got, ref) <= VOC_RTOL


def test_missing_vocoder_path_raises():
    model = _model()
    with pytest.raises(FileNotFoundError):
        model.load_vocoder("/nonexistent/vocos.npz")
    with pytest.raises(FileNotFoundError):
        model.load_vocoder("missing_dir/vocos.pt")


def test_hub_id_raises_and_asks_for_a_local_file():
    model = _model()
    with pytest.raises(FileNotFoundError, match="hub id"):
        model.load_vocoder("charactr/vocos-mel-24khz")
    assert model.vocoder is None


@pytest.mark.parametrize("spec", [
    "charactr/vocos-mel-24khz", "org/name", "./org/name", "/abs/path", "~/x/y", "a/b/c",
    "org/model.pt", "org/model.safetensors", "org/model.npz", "name", "org/model.bin",
])
def test_hub_id_rule_matches_jax(spec):
    assert tf5._looks_like_hub_id(spec) == jf5._looks_like_hub_id(spec)
