"""The plain reference against the port, at a tiny width on the CPU, in float32."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import traffic as tr
from portbench.reference import dit as R
from portbench.reference import text as RT
from portbench.reference import train as RTrain
from portbench.reference import vocos as V
from portbench.reference.mel import log_mel
from portbench.tests.tiny import ROOT, config, load_mix
from portbench.weights import dit_state


@pytest.fixture(scope="module")
def tiny():
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS

    cfg = config()
    cfg["model"]["p_dropout"] = 0.1
    model = F5TTS.from_config(F5Config.from_dict(cfg), device="cpu", dtype=torch.float32)
    shapes = {k: tuple(v.shape) for k, v in model.backbone.state_dict().items()}
    state = dit_state(shapes, 2**33 + 1, "cpu", torch.float32, R)
    model.backbone.load_state_dict(state)
    model.params_loaded = True
    return model, R.Params(state, cfg["model"]["heads"]), cfg


def test_text_front_end_matches_the_port():
    from oron_tts_tpu_torch.models.f5tts import split_text_for_synthesis
    from oron_tts_tpu_torch.text import TextCleaner
    from oron_tts_tpu_torch.text.align import stretch_text_to_len

    cleaner = TextCleaner()
    for name in ("open_loop", "clients"):
        for r in tr.generate(load_mix(name), 4, 10.0).requests[:40]:
            assert RT.split_text(r.text) == split_text_for_synthesis(r.text, 120)
            for chunk in RT.split_text(r.text):
                ids = cleaner.text_to_sequence(chunk, lang=r.lang)
                assert RT.token_ids(chunk, r.lang) == ids
                assert RT.stretch(ids, 300) == stretch_text_to_len(ids, 300)
    abbreviated = "Км. ТОВ. сар, тов."
    assert RT.token_ids(abbreviated, "mn") == cleaner.text_to_sequence(abbreviated)
    with pytest.raises(ValueError):
        RT.clean("5 км", "mn")


def test_noise_matches_the_port():
    from oron_tts_tpu_torch.models.cfm import per_row_noise

    for seed in (0, 7, 2**31 + 3, 2**40 + 9):
        assert torch.equal(R.row_noise(seed, 70, 100), per_row_noise([seed], 70, 100, "cpu")[0])


def test_velocity_matches_the_port(tiny):
    model, P, _ = tiny
    g = torch.Generator().manual_seed(0)
    T = 96
    x, cond = torch.randn(2, T, 100, generator=g), torch.randn(2, T, 100, generator=g)
    ids = torch.randint(-1, 64, (2, T), generator=g)
    mask = torch.arange(T)[None] < torch.tensor([96, 70])[:, None]
    t = torch.tensor([0.2, 0.9])
    with torch.no_grad():
        got = model.backbone(x, cond, ids, t, mask=mask)
        want = R.dit_forward(P, x, cond, R.text_embedding(P, ids, T, False), t, mask)
    keep = mask[..., None].expand_as(want)
    assert (got - want)[keep].abs().max() < 1e-4 * want.abs().max()


@pytest.mark.parametrize("voice", [False, True])
def test_solve_matches_the_port_at_its_padded_length(tiny, voice):
    model, P, _ = tiny
    from oron_tts_tpu_torch.text.align import stretch_text_to_len

    ids = RT.token_ids("сайн байна уу энэ бол туршилт", "mn")
    ref, rf = torch.zeros(0, 100), 0
    if voice:
        ref = torch.from_numpy(log_mel(0.1 * np.sin(np.arange(24000) * 0.05)).T.copy())
        rf = ref.shape[0]
    total = rf + 150
    stretched = ((stretch_text_to_len(ids[:3], rf) if rf else [])
                 + stretch_text_to_len(ids, total - rf))
    bucket = 256
    cond = torch.zeros(2, bucket, 100)
    cond[:, :rf] = ref
    text = torch.full((2, bucket), -1)
    text[0, :total] = torch.tensor(stretched)
    text[1, :60] = 5
    got, _ = model.cfm.sample(cond, text, torch.tensor([total, 60]), torch.tensor([rf, 0]),
                              steps=3, cfg_strength=2.0, sway_sampling_coef=-1.0, seed=[11, 12])
    want, noise = R.sample(P, stretched, ref, rf, total, 11, 3, 2.0, -1.0, bucket=bucket)
    assert (got[0, rf:total] - want[rf:]).norm() < 1e-5 * (want[rf:] - noise[rf:]).norm()


def test_vocoder_matches_the_port():
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS

    model = F5TTS.from_config(F5Config.from_dict(config()), device="cpu")
    model.load_vocoder()
    mel = torch.randn(1, 100, 120, generator=torch.Generator().manual_seed(1)) - 4.0
    got = model._decode_mel_group(mel, [120])[0, : 120 * 256]
    want = V.vocode(V.load_vocos(ROOT), mel[0].T)
    assert (got - want).norm() < 1e-4 * want.norm()


def test_log_mel_matches_the_port():
    from oron_tts_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram

    x = np.random.default_rng(0).standard_normal(30001).astype(np.float32) * 0.3
    got = log_mel_spectrogram(torch.from_numpy(x), MelConfig()).numpy()
    assert np.abs(np.exp(got) - np.exp(log_mel(x))).max() < 1e-4 * np.exp(log_mel(x)).max()


def test_training_loss_and_gradients_match_the_port(tiny):
    model, P, cfg = tiny
    m = cfg["model"]
    g = torch.Generator().manual_seed(5)
    B, T = 8, 128
    mel = torch.randn(B, 100, T, generator=g) - 4
    ids = torch.randint(0, 64, (B, T), generator=g)
    lens = torch.tensor([128, 100, 90, 64, 50, 128, 0, 0], dtype=torch.int32)
    for p in model.backbone.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss = model.cfm.loss(mel, ids, lens, torch.Generator().manual_seed(3), train=True)
    loss.backward()
    d = RTrain.draws(torch.Generator().manual_seed(3), B, T, 100, m["depth"],
                     (m["audio_drop_prob"], m["cond_drop_prob"]))
    want, grads = RTrain.loss_and_grads(P, mel, ids, lens, d, (0.7, 1.0), m["p_dropout"], 3,
                                         velocity=R.velocity)
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    for (name, p), gr in zip(model.backbone.named_parameters(), grads):
        assert (p.grad - gr).norm() <= 1e-4 * gr.norm() + 1e-9, name
