"""PyTorch port, batched and streamed synthesis on the CPU.

The sampler's ``cfg_interval`` segmentation and ``midpoint`` solver and the
length grouping are held against the JAX package; the per-row noise and the
"a batch row equals its solo run" contracts are the port's own and are held
against the port's solo calls. Same tiny perturbed DiT on both sides
(``test_torch_models.tiny_params``), bundled vocoder, f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oron_tts_tpu.models.cfm as jcfm
import oron_tts_tpu_torch.models.cfm as tcfm
from oron_tts_tpu.models.f5tts import F5TTS as JF5TTS
from oron_tts_tpu_torch.models.f5tts import F5TTS, _chunk_seeds
from oron_tts_tpu.models.f5tts import _chunk_seeds as j_chunk_seeds

from test_torch_models import tiny_params
from test_torch_slice import _jax_model, _port_model

B, T = 3, 64
DURATIONS, LENS = np.asarray([64, 41, 52]), np.asarray([0, 9, 20])


def _sample_inputs():
    rng = np.random.default_rng(21)
    cond = np.zeros((B, T, 100), np.float32)
    ids = rng.integers(1, 64, size=(B, T)).astype(np.int32)
    for b in range(B):
        cond[b, :LENS[b]] = rng.standard_normal((LENS[b], 100))
        ids[b, DURATIONS[b]:] = -1
    noise = rng.standard_normal((B, T, 100)).astype(np.float32)
    return cond, ids, noise


@pytest.fixture(scope="module")
def models():
    return _jax_model(), _port_model()


def _both(models, **kw):
    jm, pm = models
    cond, ids, noise = _sample_inputs()
    ref, _ = jm.cfm.sample(jm.variables, cond, ids, DURATIONS, LENS, steps=6, cfg_strength=2.0,
                           sway_sampling_coef=-1.0, noise=noise, **kw)
    out, _ = pm.cfm.sample(torch.from_numpy(cond), torch.from_numpy(ids),
                           torch.from_numpy(DURATIONS), torch.from_numpy(LENS), steps=6,
                           cfg_strength=2.0, sway_sampling_coef=-1.0,
                           noise=torch.from_numpy(noise.copy()), **kw)
    return out.numpy(), np.asarray(ref)


# f32 on both sides; 6 steps of a two-block model, ragged batch of three:
# the unquantized parity tolerance of tests/test_torch_slice.py
@pytest.mark.parametrize("kw", [
    dict(cfg_interval=(0.1, 0.7)),
    dict(method="midpoint"),
    dict(cfg_interval=(0.1, 0.7), method="midpoint"),
], ids=["interval", "midpoint", "interval+midpoint"])
def test_cfm_sample_interval_and_midpoint_match_jax(models, kw):
    out, ref = _both(models, **kw)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_cfg_interval_full_range_is_identical_to_none(models):
    _, pm = models
    cond, ids, noise = _sample_inputs()
    args = (torch.from_numpy(cond), torch.from_numpy(ids), torch.from_numpy(DURATIONS),
            torch.from_numpy(LENS))
    kw = dict(steps=6, cfg_strength=2.0, sway_sampling_coef=-1.0)
    base, _ = pm.cfm.sample(*args, noise=torch.from_numpy(noise.copy()), **kw)
    full, _ = pm.cfm.sample(*args, noise=torch.from_numpy(noise.copy()),
                            cfg_interval=(0.0, 1.0), **kw)
    assert torch.equal(base, full)
    part, _ = pm.cfm.sample(*args, noise=torch.from_numpy(noise.copy()),
                            cfg_interval=(0.1, 0.7), **kw)
    assert not torch.equal(base, part)


@pytest.mark.parametrize("steps,sway,interval", [
    (32, -1.0, (0.1, 0.7)), (32, None, (0.1, 0.7)), (8, -1.0, (0.0, 0.75)),
    (6, -1.0, (0.5, 0.5)), (16, 0.5, (0.3, 1.0)), (4, -1.0, (0.0, 1.0)),
])
def test_cfg_segments_equal_jax_bounds(steps, sway, interval):
    """JAX decides membership inline (cfm.py, "Segment the step range"); same rule here."""
    t = jcfm.sway_timesteps_host(steps, sway)[:-1]
    inside = (t >= interval[0]) & (t <= interval[1])
    bounds = [0] + [i for i in range(1, steps) if inside[i] != inside[i - 1]] + [steps]
    want = [(a, b, bool(inside[a])) for a, b in zip(bounds, bounds[1:])]
    got = tcfm.cfg_segments(steps, sway, interval, use_cfg=True)
    assert got == want and len(got) <= 3
    assert sum(b - a for a, b, _ in got) == steps
    assert tcfm.cfg_segments(steps, sway, interval, use_cfg=False) == [(0, steps, False)]
    assert tcfm.cfg_segments(steps, sway, None, use_cfg=True) == [(0, steps, True)]


def test_sample_rejects_bad_solver_settings(models):
    _, pm = models
    cond, ids, _ = _sample_inputs()
    args = (torch.from_numpy(cond), torch.from_numpy(ids), torch.from_numpy(DURATIONS),
            torch.from_numpy(LENS))
    with pytest.raises(ValueError, match="method"):
        pm.cfm.sample(*args, steps=2, method="heun")
    with pytest.raises(ValueError, match="cfg_interval"):
        pm.cfm.sample(*args, steps=2, cfg_interval=(0.8, 0.2))
    with pytest.raises(ValueError, match="one entry per row"):
        pm.cfm.sample(*args, steps=2, seed=[1, 2])


# ── per-row noise ────────────────────────────────────────────────────────


def test_per_row_noise_depends_on_seed_frame_and_bin_only():
    solo = tcfm.per_row_noise([7], 40, 100, "cpu")
    batch = tcfm.per_row_noise([3, 7, 11], 96, 100, "cpu")
    assert torch.equal(batch[1, :40], solo[0])           # batch, position and length
    assert torch.equal(tcfm.per_row_noise([11, 7], 50, 100, "cpu")[1, :40], solo[0])
    assert not torch.equal(batch[0, :40], solo[0])       # another seed, another draw
    shared = tcfm.per_row_noise([5, 5], 40, 100, "cpu", rows=[0, 1])
    assert not torch.equal(shared[0], shared[1])         # one seed for a batch: rows differ
    assert torch.equal(shared[0], tcfm.per_row_noise([5], 40, 100, "cpu")[0])
    big = tcfm.per_row_noise([2 ** 40 + 3, -1], 8, 100, "cpu")  # wide and negative seeds
    assert torch.isfinite(big).all() and not torch.equal(big[0], big[1])


def test_per_row_noise_is_standard_normal():
    z = tcfm.per_row_noise(list(range(16)), 512, 100, "cpu").double()
    assert z.dtype == torch.float64 and torch.isfinite(z).all()
    n = z.numel()  # 819,200 draws: the mean's standard error is 1.1e-3
    assert abs(z.mean().item()) < 6e-3
    assert abs(z.var().item() - 1.0) < 6e-3
    assert abs((z ** 3).mean().item()) < 2e-2            # skewness
    assert abs((z ** 4).mean().item() - 3.0) < 5e-2      # kurtosis
    assert abs((z.abs() > 1.96).double().mean().item() - 0.05) < 2e-3
    # neighbours along each axis are uncorrelated (standard error 1.1e-3)
    for a, b in ((z[:, 1:], z[:, :-1]), (z[..., 1:], z[..., :-1]), (z[1:], z[:-1])):
        assert abs((a * b).mean().item()) < 6e-3
    assert n == 16 * 512 * 100


# ── length groups ────────────────────────────────────────────────────────


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_batch,budget", [(16, 3072), (4, 3072), (16, 6656)])
def test_length_groups_match_jax_and_hold_their_caps(monkeypatch, seed, max_batch, budget):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    lens = [int(v) for v in rng.integers(50, 1700, size=n)]
    # JAX pads rows for jit keys and the mesh; the port solves exactly the
    # rows a group has, so JAX's padding is switched off for the comparison
    monkeypatch.setattr(JF5TTS, "_pad_rows", staticmethod(lambda n, row_multiple=1: n))
    monkeypatch.setattr(JF5TTS, "GROUP_FRAME_BUDGET", budget)
    monkeypatch.setattr(F5TTS, "GROUP_FRAME_BUDGET", budget)
    groups = F5TTS._length_groups(lens, 64, max_batch)
    assert groups == JF5TTS._length_groups(lens, 64, max_batch)
    assert sorted(i for g in groups for i in g) == list(range(n))
    for g in groups:
        bucket = -(-max(lens[i] for i in g) // 64) * 64
        assert len(g) <= max_batch
        assert len(g) == 1 or len(g) * bucket <= budget


def test_chunk_seeds_rule_matches_jax():
    for seed, n in ((None, 3), (0, 1), (41, 4)):
        assert _chunk_seeds(seed, n) == j_chunk_seeds(seed, n)


# ── the facade's contracts ───────────────────────────────────────────────

TEXTS = [
    "Сайн байна уу",
    "Өнөөдөр цаг агаар сайхан байна, гэхдээ орой бороо орж магадгүй.",
    "За",
    "Монгол хэл бол Төв Азийн өргөн уудам нутагт олон сая хүний ярьдаг хэл юм.",
    "Баярлалаа, дараа уулзъя",
]
SEEDS = [5, 9, 2, 14, 30]
PARAGRAPH = ("Нэг өгүүлбэр энд байна. Хоёр дахь өгүүлбэр арай урт байгаа шүү. "
             "Гурав дахь нь богино.")


def close_wav(got, want):
    """Equal up to f32 rounding: within 1e-3 of the waveform's peak.

    A row's noise is bit-equal in any batch and its mel agrees to ~2e-6 (the
    matmuls sum over other shapes); the vocoder's exp(log-magnitude) and
    phase head turn that into up to a few 1e-4 of the peak on single samples.
    The same bound holds the port to the JAX facade in test_torch_slice.py.
    """
    assert got.shape == want.shape and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 1e-3 * float(np.abs(want).max())


def pad_silent_params():
    """``tiny_params`` with the text blocks' GRN ``gamma`` at zero, as at initialisation.

    The GRN of the text ConvNeXt blocks normalises by a sum over the whole
    padded sequence, in both packages as in upstream F5-TTS, and padding
    positions are not zero inside a block (biases, and the depthwise conv's
    spill from the last valid frames). So with a non-zero ``gamma`` a row
    feels how much padding its bucket adds, in JAX and in the port alike
    (``test_text_embedding_feels_the_bucket_exactly_as_jax_does``). With
    ``gamma`` at zero the GRN couples no positions and a row is free of
    its bucket, which is what the row-equals-solo tests need.
    """
    tree = dict(tiny_params())
    text = dict(tree["text_embed"])
    for name, block in text.items():
        if name.startswith("block"):
            grn = {**block["grn"], "gamma": np.zeros_like(block["grn"]["gamma"])}
            text[name] = {**block, "grn": grn}
    tree["text_embed"] = text
    return tree


def pad_silent_model():
    model = _port_model()
    model.load_params(pad_silent_params())
    return model


@pytest.fixture(scope="module")
def port_model():
    return pad_silent_model()


def test_text_embedding_feels_the_bucket_exactly_as_jax_does(models):
    """Not a fault of the port: the JAX text embedding has the same dependence."""
    jm, pm = models
    ids = np.full((1, 160), -1, np.int32)
    ids[0, :70] = np.random.default_rng(3).integers(1, 60, size=70)
    outs = {}
    for bucket in (96, 160):
        ref = jm.backbone.apply(jm.variables, jnp.asarray(ids), bucket, False,
                                method="embed_text")
        with torch.no_grad():
            out = pm.backbone.embed_text(torch.from_numpy(ids), bucket, drop_text=False)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
        outs[bucket] = out[0, :70]
    assert float((outs[96] - outs[160]).abs().max()) > 1e-3
    silent = pad_silent_model()
    with torch.no_grad():
        a, b = (silent.backbone.embed_text(torch.from_numpy(ids), n, drop_text=False)[0, :70]
                for n in (96, 160))
    assert float((a - b).abs().max()) < 1e-5


def test_batch_rows_equal_solo_whatever_the_batch_order_and_bucket(port_model):
    kw = dict(n_steps=2, cfg_strength=2.0)
    solo = [port_model.synthesize(t, seed=s, **kw) for t, s in zip(TEXTS, SEEDS)]
    batch = port_model.synthesize_batch(TEXTS, seeds=SEEDS, **kw)
    order = [3, 0, 4, 2, 1]
    shuffled = port_model.synthesize_batch([TEXTS[i] for i in order],
                                           seeds=[SEEDS[i] for i in order], **kw)
    pair = port_model.synthesize_batch([TEXTS[2], TEXTS[3]], seeds=[SEEDS[2], SEEDS[3]],
                                       max_batch=1, **kw)
    for i, want in enumerate(solo):
        close_wav(batch[i], want)
        close_wav(shuffled[order.index(i)], want)
    close_wav(pair[0], solo[2])
    close_wav(pair[1], solo[3])
    # seeds default to (seed or 0) + i
    default = port_model.synthesize_batch(TEXTS[:2], seed=5, **kw)
    close_wav(default[0], solo[0])
    close_wav(default[1], port_model.synthesize(TEXTS[1], seed=6, **kw))


def test_batch_splits_paragraphs_and_clones_one_voice(port_model, tmp_path):
    from oron_tts_tpu_torch.data.wav import write_wav

    ref = 0.3 * np.random.default_rng(6).standard_normal(12000).astype(np.float32)
    write_wav(tmp_path / "ref.wav", ref, 24000, subtype="float32")
    kw = dict(n_steps=2, max_chars_per_chunk=40, ref_audio_path=tmp_path / "ref.wav",
              ref_text="Өглөөний мэнд")
    out = port_model.synthesize_batch([PARAGRAPH, TEXTS[0]], seeds=[3, 8], **kw)
    close_wav(out[0], port_model.synthesize(PARAGRAPH, seed=3, **kw))
    close_wav(out[1], port_model.synthesize(TEXTS[0], seed=8, **kw))


def test_batch_guards(port_model):
    assert port_model.synthesize_batch([]) == []
    with pytest.raises(ValueError, match="one entry per text"):
        port_model.synthesize_batch(TEXTS[:2], seeds=[1])
    with pytest.raises(ValueError, match=r"texts\[1\] must not be empty"):
        port_model.synthesize_batch(["сайн", "   "], n_steps=1)
    with pytest.raises(ValueError, match="speed"):
        port_model.synthesize_batch(["сайн"], speed=0.0)
    fresh = F5TTS(port_model.config, device="cpu")
    with pytest.raises(RuntimeError, match="load DiT parameters"):
        fresh.synthesize_batch(["сайн"])


@pytest.mark.parametrize("kw", [
    dict(), dict(cfg_interval=(0.1, 0.7)), dict(method="midpoint"), dict(pause_s=0.0),
], ids=["euler", "interval", "midpoint", "no-pause"])
def test_stream_joined_equals_synthesize(port_model, kw):
    kw = dict(n_steps=2, seed=4, max_chars_per_chunk=40, **kw)
    pieces = list(port_model.synthesize_stream(PARAGRAPH, **kw))
    want = port_model.synthesize(PARAGRAPH, **kw)
    n_chunks = 3
    assert len(pieces) == (2 * n_chunks - 1 if kw.get("pause_s", 0.25) > 0 else n_chunks)
    joined = np.concatenate(pieces)
    assert joined.shape == want.shape
    close_wav(joined, want)


def test_stream_solves_the_first_chunk_alone_before_the_rest(port_model, monkeypatch):
    solved = []
    real = port_model._solve_group

    def spy(group, *a, **k):
        solved.append(list(group))
        return real(group, *a, **k)

    monkeypatch.setattr(port_model, "_solve_group", spy)
    gen = port_model.synthesize_stream(PARAGRAPH, n_steps=1, seed=0, max_chars_per_chunk=40)
    first = next(gen)
    assert solved == [[0]] and len(first) > 0   # audio is out before chunk 1 is launched
    list(gen)
    assert sorted(i for g in solved for i in g) == [0, 1, 2] and solved[0] == [0]
    with pytest.raises(ValueError, match="n_steps"):
        next(port_model.synthesize_stream("сайн", n_steps=0))


def test_lengths_match_the_jax_facade(port_model):
    """Same texts → same chunking, target frames and output samples as JAX."""
    jm = _jax_model()
    kw = dict(n_steps=1, seed=0, max_chars_per_chunk=40)
    for text in (TEXTS[1], PARAGRAPH):
        assert port_model.synthesize(text, **kw).shape == jm.synthesize(text, **kw).shape
    ours = port_model.synthesize_batch(TEXTS, n_steps=1, seed=0)
    theirs = jm.synthesize_batch(TEXTS, n_steps=1, seed=0)
    assert [len(w) for w in ours] == [len(w) for w in theirs]
    streamed = sum(len(p) for p in port_model.synthesize_stream(PARAGRAPH, **kw))
    assert streamed == sum(len(p) for p in jm.synthesize_stream(PARAGRAPH, **kw))


@pytest.mark.parametrize("mode,tol", [("int8", 0.01), ("int8_dynamic", 0.03)])
def test_quantize_for_serving_keeps_the_mel_close(mode, tol):
    """The bounds of tests/test_quantized.py::test_quantized_sampling_deviation."""
    model = pad_silent_model()
    kw = dict(n_steps=4, cfg_strength=2.0, seed=0)
    ref = model.synthesize_mel("Сайн байна уу", **kw)
    n_before, bytes_before = model.num_params(), model.weight_bytes()
    model.quantize_for_serving(mode)
    assert model.quant_mode == mode and model.backbone.quant == mode
    assert model.num_params() > n_before and model.weight_bytes() < bytes_before
    out = model.synthesize_mel("Сайн байна уу", **kw)
    rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    assert 0 < rel < tol, f"{mode} rel err {rel}"
    with pytest.raises(ValueError, match="unknown quant mode"):
        model.quantize_for_serving("int4")
    with pytest.raises(RuntimeError, match="before quantizing"):
        F5TTS(model.config, device="cpu").quantize_for_serving("int8")
