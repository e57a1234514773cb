"""PyTorch port, the facade's ``F5TTS.forward`` and ``F5TTS.set_vocoder`` against the JAX package.

``forward`` is the CFM loss behind the facade: lengths ``[B]`` or a bool mask
``[B, T]`` (its row sums), a default generator in place of JAX's default key
0, ``x0`` to inject the noise. ``set_vocoder`` installs a vocoder module with
its weights; what it decodes is what ``load_vocoder`` of the same weights
decodes, and a second call replaces the first. Tiny perturbed DiT, a seeded
two-layer Vocos in the official torch layout, f32 on the CPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oron_tts_tpu_torch.models.vocos import VocosDecoder, convert_vocos_state_dict
from oron_tts_tpu_torch.utils.weights import from_flax_params

from test_torch_griffin_lim import VOC_RTOL, _log_mel, _official_vocos, _rel_err
from test_torch_serve_load import one_thread  # noqa: F401 (autouse: tiny models)
from test_torch_slice import _jax_model, _port_model

B, T_MEL = 2, 64
LENS = np.asarray([T_MEL, 43], np.int32)


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, 100, T_MEL)).astype(np.float32)
    ids = rng.integers(1, 60, (B, T_MEL)).astype(np.int32)
    ids[1, LENS[1]:] = -1
    x0 = rng.standard_normal((B, T_MEL, 100)).astype(np.float32)
    mask = np.arange(T_MEL)[None, :] < LENS[:, None]
    return mel, ids, mask, x0


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_with_a_mask_equals_the_loss_with_its_lengths(train):
    pm = _port_model()
    mel, ids, mask, x0 = _batch()
    got = pm.forward(mel, ids, torch.from_numpy(mask), x0=torch.from_numpy(x0), train=train)
    want = pm.cfm.loss(torch.from_numpy(mel), torch.from_numpy(ids), torch.from_numpy(LENS),
                       torch.Generator().manual_seed(0), train=train, x0=torch.from_numpy(x0))
    assert torch.equal(got, want)
    # the default generator is seeded with 0, as JAX's default key is 0
    again = pm.forward(mel, ids, torch.from_numpy(LENS), x0=torch.from_numpy(x0), train=train)
    assert torch.equal(got, again)
    assert got.shape == () and torch.isfinite(got)


def test_forward_matches_the_jax_facade(monkeypatch):
    jm, pm = _jax_model(), _port_model()
    mel, ids, mask, x0 = _batch()
    # the JAX facade draws x0 from its key inside; the same noise goes in here
    monkeypatch.setattr(jm.cfm, "loss", functools.partial(jm.cfm.loss, x0=jnp.asarray(x0)))
    ref = jm.forward(jnp.asarray(mel), jnp.asarray(ids), jnp.asarray(mask), train=False)
    got = pm.forward(mel, ids, torch.from_numpy(mask), x0=torch.from_numpy(x0), train=False)
    # one f32 eval loss of the same weights and noise: test_torch_cfm_loss.py's tolerance
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_forward_needs_parameters():
    from oron_tts_tpu_torch.config import F5Config, ModelConfig
    from oron_tts_tpu_torch.models.f5tts import F5TTS

    model = F5TTS(F5Config(model=ModelConfig(dim=64, depth=1, heads=1, text_dim=32)),
                  device="cpu")
    mel, ids, _, _ = _batch()
    with pytest.raises(RuntimeError, match="init_params"):
        model.forward(mel, ids)


def _vocoder(seed: int):
    """A seeded two-layer Vocos module and its official-layout tensors."""
    sd = {k: v * (1 + 0.1 * seed) for k, v in _official_vocos().items()}
    module = VocosDecoder(n_mels=100, dim=64, n_layers=2, intermediate_dim=128,
                          head_mode="mag_phase", layer_scale=True)
    return module, from_flax_params(convert_vocos_state_dict(sd, n_layers=2)), sd


def test_set_vocoder_decodes_as_load_vocoder_and_as_jax(tmp_path):
    from oron_tts_tpu.models import f5tts as jf5

    from test_torch_griffin_lim import TINY

    mel = torch.from_numpy(_log_mel())
    module, state, sd = _vocoder(0)
    torch.save(sd, tmp_path / "vocos.pt")
    installed = _port_model()
    installed.set_vocoder(module, state)
    assert installed.vocoder is module and not module.training
    loaded = _port_model()
    loaded.load_vocoder(tmp_path / "vocos.pt")
    got = installed._decode_mel(mel)
    np.testing.assert_array_equal(got, loaded._decode_mel(mel))
    jmodel = jf5.F5TTS.from_config(TINY)
    jmodel.load_vocoder(str(tmp_path / "vocos.pt"))
    assert _rel_err(got, np.asarray(jmodel._decode_mel(jnp.asarray(mel.numpy())))) <= VOC_RTOL


def test_a_second_set_vocoder_replaces_the_first(tmp_path):
    mel = torch.from_numpy(_log_mel())
    model = _port_model()
    first, state, _ = _vocoder(0)
    model.set_vocoder(first, state)
    wav_first = model._decode_mel(mel)
    second, state2, sd2 = _vocoder(1)
    model.set_vocoder(second, state2)
    assert model.vocoder is second
    wav_second = model._decode_mel(mel)
    assert not np.array_equal(wav_first, wav_second)
    torch.save(sd2, tmp_path / "second.pt")
    fresh = _port_model()
    fresh.load_vocoder(tmp_path / "second.pt")
    np.testing.assert_array_equal(wav_second, fresh._decode_mel(mel))
    # a module already holding its weights needs no state dict
    model.set_vocoder(first)
    np.testing.assert_array_equal(model._decode_mel(mel), wav_first)
