"""PyTorch port, the synthesis slice end to end against the JAX package.

Both packages get the same perturbed tiny DiT, the bundled vocoder and the
same numpy noise: the JAX facade through a monkeypatched
``oron_tts_tpu.models.cfm.per_sample_noise``, the port through its
``per_row_noise``. Also: identical text ids from the copied text stack, the
port's imports stay free of JAX, and its entry points refuse to fall back
to the CPU silently.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oron_tts_tpu.models.cfm as jcfm
import oron_tts_tpu_torch.models.cfm as tcfm
from oron_tts_tpu.config import F5Config as JF5Config
from oron_tts_tpu.config import ModelConfig as JModelConfig
from oron_tts_tpu.data.wav import write_wav
from oron_tts_tpu.models.f5tts import F5TTS as JF5TTS
from oron_tts_tpu.text import TextCleaner as JTextCleaner
from oron_tts_tpu_torch.config import F5Config, ModelConfig
from oron_tts_tpu_torch.models.f5tts import F5TTS
from oron_tts_tpu_torch.text import TextCleaner

from test_torch_models import DEPTH, DIM, HEADS, TEXT_DIM, tiny_params

REPO = Path(__file__).resolve().parent.parent
NOISE = np.random.default_rng(123).standard_normal((1, 512, 100)).astype(np.float32)


def _jax_model():
    model = JF5TTS(JF5Config(model=JModelConfig(
        dim=DIM, depth=DEPTH, heads=HEADS, text_dim=TEXT_DIM, conv_layers=1)))
    model.variables = {"params": tiny_params()}
    return model


def _port_model():
    model = F5TTS(F5Config(model=ModelConfig(
        dim=DIM, depth=DEPTH, heads=HEADS, text_dim=TEXT_DIM, conv_layers=1)), device="cpu")
    model.load_params(tiny_params())
    return model


@pytest.fixture
def shared_noise(monkeypatch):
    monkeypatch.setattr(
        jcfm, "per_sample_noise",
        lambda key, batch, length, n_mels, dtype=jnp.float32: jnp.asarray(
            NOISE[:batch, :length, :n_mels], dtype),
    )
    monkeypatch.setattr(
        tcfm, "per_row_noise",
        lambda seeds, length, n_mels, device, rows=None: torch.from_numpy(
            NOISE[:len(seeds), :length, :n_mels].copy()).to(device),
    )


@pytest.mark.parametrize("ref_len", [0, 20])
def test_cfm_sample_with_injected_noise(ref_len):
    T = 64
    rng = np.random.default_rng(5)
    cond = np.zeros((1, T, 100), np.float32)
    cond[0, :ref_len] = rng.standard_normal((ref_len, 100))
    ids = rng.integers(1, 64, size=(1, T)).astype(np.int32)
    ids[0, 57:] = -1
    duration, lens = np.asarray([57]), np.asarray([ref_len])
    jm, pm = _jax_model(), _port_model()
    ref, _ = jm.cfm.sample(jm.variables, cond, ids, duration, lens, steps=4,
                           cfg_strength=2.0, sway_sampling_coef=-1.0,
                           noise=NOISE[:, :T])
    out, _ = pm.cfm.sample(torch.from_numpy(cond), torch.from_numpy(ids),
                           torch.from_numpy(duration), torch.from_numpy(lens), steps=4,
                           cfg_strength=2.0, sway_sampling_coef=-1.0,
                           noise=torch.from_numpy(NOISE[:, :T].copy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("voice_cloned", [False, True])
def test_synthesize_matches_jax_facade(shared_noise, tmp_path, voice_cloned):
    kwargs = dict(lang="mn", n_steps=4, cfg_strength=2.0, seed=0)
    if voice_cloned:
        wav = 0.3 * np.random.default_rng(6).standard_normal(24000).astype(np.float32)
        write_wav(tmp_path / "ref.wav", wav, 24000, subtype="float32")
        kwargs.update(ref_audio_path=tmp_path / "ref.wav", ref_text="Өглөөний мэнд")
    text = "Сайн байна уу"
    jm, pm = _jax_model(), _port_model()
    mel_ref = jm.synthesize_mel(text, **kwargs)
    mel_out = pm.synthesize_mel(text, **kwargs)
    assert mel_out.shape == mel_ref.shape
    np.testing.assert_allclose(mel_out, mel_ref, atol=1e-3)
    wav_ref = jm.synthesize(text, **kwargs)
    wav_out = pm.synthesize(text, **kwargs)
    assert wav_out.shape == wav_ref.shape and wav_out.dtype == np.float32
    peak = float(np.abs(wav_ref).max())
    assert float(np.abs(wav_out - wav_ref).max()) <= 1e-3 * peak


@pytest.mark.parametrize("lang,text", [
    ("mn", "2024 оны 3-р сарын 15-нд 1500₮ төлсөн. Утас: 99112233!"),
    ("mn", "Би 25 настай, 3.5 кг алим $20-оор авсан."),
    ("kz", "Қазақстан 1991 жылы 16 желтоқсанда тәуелсіздік алды; баға 500 ₸."),
    ("kz", "Бүгін 12.05.2023, сағат 14:30-да 7% жеңілдік бар."),
])
def test_text_stack_copy_gives_identical_ids(lang, text):
    jc, tc = JTextCleaner(), TextCleaner()
    assert tc.clean(text, lang=lang) == jc.clean(text, lang=lang)
    assert tc.text_to_sequence(text, lang=lang) == jc.text_to_sequence(text, lang=lang)


LONG_TEXT = ("Монгол хэл бол Төв Азийн өргөн уудам нутагт олон сая хүний ярьдаг хэл юм. "
             "Өнөөдөр цаг агаар сайхан байна, гэхдээ орой бороо орж магадгүй; "
             "маргааш   нартай\nбайна!")


@pytest.mark.parametrize("max_chars", [0, 20, 45, 120])
def test_text_split_and_pause_concat_match_jax(max_chars):
    from oron_tts_tpu.models import f5tts as jf
    from oron_tts_tpu_torch.models import f5tts as tf

    chunks = tf.split_text_for_synthesis(LONG_TEXT, max_chars)
    assert chunks == jf.split_text_for_synthesis(LONG_TEXT, max_chars)
    waves = [np.full(n, i + 1, np.float32) for i, n in enumerate(range(3, 3 + len(chunks)))]
    for pause in (0.0, 0.001):
        np.testing.assert_array_equal(tf.concat_with_pause(waves, 24000, pause),
                                      jf.concat_with_pause(waves, 24000, pause))


@pytest.mark.parametrize("duration_s,ref_len,n_ref_ids,speed", [
    (3.2, 0, 0, 1.0),      # explicit duration wins
    (None, 300, 20, 1.0),  # ratio to the reference
    (None, 300, 20, 1.3),
    (None, 300, 0, 1.0),   # reference without text: chars·13
    (None, 0, 0, 0.8),
    (None, 0, 0, 50.0),    # floor of 50 frames
])
def test_target_len_cascade_and_bucket_match_jax(duration_s, ref_len, n_ref_ids, speed):
    text = "Сайн байна уу, найзаа"
    ids = TextCleaner().text_to_sequence(text, lang="mn")
    ref_ids = list(range(1, n_ref_ids + 1))
    jm = JF5TTS(JF5Config(model=JModelConfig(dim=DIM, depth=1, heads=HEADS,
                                             text_dim=TEXT_DIM, conv_layers=1)))
    pm = F5TTS(F5Config(model=ModelConfig(dim=DIM, depth=1, heads=HEADS,
                                          text_dim=TEXT_DIM, conv_layers=1)), device="cpu")
    n = pm._target_len(text, ids, duration_s, ref_len, ref_ids, speed)
    assert n == jm._target_len(text, ids, duration_s, ref_len, ref_ids, speed)
    assert pm._bucket(ref_len + n) == jm._bucket(ref_len + n)


@pytest.mark.parametrize("subtype,orig_sr", [("pcm16", 24000), ("float32", 22050),
                                             ("pcm16", 16000)])
def test_wav_copy_reads_resamples_and_normalizes_like_jax(tmp_path, subtype, orig_sr):
    import oron_tts_tpu.data.wav as jw
    import oron_tts_tpu_torch.data.wav as tw

    audio = (0.4 * np.random.default_rng(11).standard_normal((orig_sr // 10, 2))).astype(
        np.float32)
    tw.write_wav(tmp_path / "port.wav", audio, orig_sr, subtype=subtype)
    jw.write_wav(tmp_path / "jax.wav", audio, orig_sr, subtype=subtype)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    (a, sr_a), (b, sr_b) = tw.read_wav(tmp_path / "jax.wav"), jw.read_wav(tmp_path / "port.wav")
    assert sr_a == sr_b == orig_sr
    np.testing.assert_array_equal(a, b)
    mono = a.mean(axis=1)
    np.testing.assert_array_equal(tw.resample(mono, orig_sr, 24000),
                                  jw.resample(mono, orig_sr, 24000))
    np.testing.assert_array_equal(tw.normalize_peak(mono), jw.normalize_peak(mono))


def test_port_imports_no_jax():
    code = f"""
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
import oron_tts_tpu_torch
for m in pkgutil.walk_packages(oron_tts_tpu_torch.__path__, "oron_tts_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(REPO / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "oron_tts_tpu"))
print("BAD", bad)
print("N", sum(n.startswith("oron_tts_tpu_torch.") for n in sys.modules))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert int(res.stdout.split("N ")[1]) >= 31
    for module in ("ops.gelu_dropout", "train.trainer", "train.checkpoint", "data.dataset",
                   "data.loader", "cli.train", "ops.quantized_matmul", "cli.infer", "cli.serve"):
        assert (REPO / "oron_tts_tpu_torch" / (module.replace(".", "/") + ".py")).exists()


def test_entry_points_refuse_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        F5TTS(F5Config(model=ModelConfig(dim=DIM, depth=1, heads=HEADS,
                                         text_dim=TEXT_DIM, conv_layers=1)))
    from oron_tts_tpu_torch.ops.audio import AudioProcessor

    with pytest.raises(RuntimeError, match="CUDA"):
        AudioProcessor()
    # training: the trainer runs where its model lives, and the model refuses;
    # the CLI refuses before it reads its config or its data
    with pytest.raises(RuntimeError, match="CUDA"):
        F5TTS.from_config({"model": {"dim": DIM, "depth": 1, "heads": HEADS}})
    from oron_tts_tpu_torch.cli import train as cli_train

    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train.main(["--config", "no-such-file.yaml", "--from-local"])
