"""The port's vocoder training (train/vocoder.py) against the JAX package.

Same numpy-seeded inputs and carried weights through both packages: the
MR-STFT, vocoder, LSGAN and feature-matching losses (1e-4 relative), three
guarded MR-STFT steps under optax's chain (loss and gradient norm per step,
1e-4 relative), a non-finite step, a K=2 GAN superstep and the unguarded
GAN steps, and the host-side crops and packing (bit for bit).

Parameters after Adam steps differ by more than the losses do: Adam's first
update is about lr·sign(g), so an element whose gradient is near zero in
both packages can move by +lr in one and -lr in the other. Parameters are
held to ``2·Σ lr`` of the steps taken.

The steps run the bundled (trained) Vocos on crops of a seeded speech-like
corpus. At a random init the log-magnitude term's gradient is dominated by
a few near-zero bins of the prediction's first frame, and its norm moves by
~1e-3 when the input moves by 1e-7 (measured), which is below what two f32
FFTs agree to; with trained weights it moves by ~6e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oron_tts_tpu.train import vocoder as jv
from oron_tts_tpu_torch.models.vocos import VocosDecoder
from oron_tts_tpu_torch.train import vocoder as tv
from oron_tts_tpu_torch.utils.weights import from_flax_params, to_flax_params

from _torch_vocoder_pair import (
    CFG,
    CROP,
    JCFG,
    bundled,
    bundled_pair,
    corpus,
    host,
    max_tree_diff,
    rel,
    tiny_vocoder,
)

@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models on one intra-op thread: on a CPU shared by several test workers,
    each op's thread team would otherwise wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vocoder_and_discriminator_trees_round_trip():
    """``to_flax_params(from_flax_params(t)) == t`` for the bundled Vocos and a
    seeded discriminator (4-D kernels stay in flax's layout)."""
    from oron_tts_tpu_torch.models.discriminators import VocoderDiscriminator
    from oron_tts_tpu_torch.utils.weights import init_module_params

    params, _ = bundled()
    disc = init_module_params(VocoderDiscriminator(), seed=1)
    assert disc["mpd_2"]["conv0"]["kernel"].shape == (5, 1, 1, 32)
    assert disc["mrd_512"]["conv1"]["kernel"].shape == (3, 9, 32, 32)
    for tree in (params, disc):
        back = to_flax_params(from_flax_params(tree))
        flat = jax.tree_util.tree_leaves_with_path(tree)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for (path, a), b in zip(flat, jax.tree_util.tree_leaves(back)):
            assert np.array_equal(a, b), path


# ── losses ──────────────────────────────────────────────────────────────


@pytest.mark.parametrize("length", [6000, 4096])
def test_mrstft_and_mel_l1_match_jax(length):
    rng = np.random.default_rng(length)
    pred = (0.3 * rng.standard_normal((2, length))).astype(np.float32)
    target = corpus(1)[: 2 * length].reshape(2, length)
    got = float(tv.multi_resolution_stft_loss(torch.from_numpy(pred), torch.from_numpy(target)))
    want = float(jax.jit(jv.multi_resolution_stft_loss)(jnp.asarray(pred), jnp.asarray(target)))
    assert rel(got, want) < 1e-4, (got, want)
    assert float(tv.multi_resolution_stft_loss(torch.from_numpy(target),
                                               torch.from_numpy(target))) < 1e-5
    from oron_tts_tpu.ops.mel import log_mel_spectrogram as jax_log_mel

    got = float(tv.mel_l1(torch.from_numpy(pred), torch.from_numpy(target), CFG))
    want = float(jax.jit(lambda p, t: jnp.mean(jnp.abs(jax_log_mel(p, JCFG) - jax_log_mel(
        t, JCFG))))(jnp.asarray(pred), jnp.asarray(target)))
    assert rel(got, want) < 1e-4, (got, want)


@pytest.mark.parametrize("mel_weight", [1.0, 0.0])
def test_vocoder_loss_matches_jax(mel_weight):
    jm, params, tm = tiny_vocoder()
    wav = corpus(2)[: 2 * CROP].reshape(2, CROP)
    mels, _ = tv.crop_batch(list(wav), CFG, crop_frames=8, rng=np.random.default_rng(0))
    with torch.no_grad():
        got = float(tv.vocoder_loss(tm, torch.from_numpy(mels), torch.from_numpy(wav), CFG,
                                    mel_weight))
    want = float(jax.jit(lambda p, m, w: jv.vocoder_loss({"params": p}, jm, m, w, JCFG,
                                                         mel_weight))(params, mels, wav))
    assert rel(got, want) < 1e-4, (got, want)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(7)
    shapes = [(2, 5), (2, 9), (2, 3)]
    real = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    fake = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    feats_r = [[rng.standard_normal((2, 4, c)).astype(np.float32) for c in (3, 5)] for _ in shapes]
    feats_f = [[rng.standard_normal((2, 4, c)).astype(np.float32) for c in (3, 5)] for _ in shapes]
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    j = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    pairs = [
        (tv.lsgan_d_loss(t(real), t(fake)), jv.lsgan_d_loss(j(real), j(fake))),
        (tv.lsgan_g_loss(t(fake)), jv.lsgan_g_loss(j(fake))),
        (tv.feature_matching_loss([t(f) for f in feats_r], [t(f) for f in feats_f]),
         jv.feature_matching_loss([j(f) for f in feats_r], [j(f) for f in feats_f])),
    ]
    for got, want in pairs:
        assert rel(float(got), float(want)) < 1e-5, (float(got), float(want))


# ── the optimizer and the guarded steps ─────────────────────────────────


def test_schedule_is_optax_warmup_cosine():
    for lr, steps in ((2e-4, 100000), (1e-3, 100), (5e-4, 7)):
        want = optax.warmup_cosine_decay_schedule(
            lr * 1e-2, lr, min(500, max(steps // 20, 1)), steps)
        got = tv.warmup_cosine_schedule(lr, steps)
        for count in (0, 1, 2, 4, steps // 2, steps - 1, steps, steps + 3):
            # to f32 rounding of the peak
            assert abs(got(count) - float(want(count))) <= 1e-5 * lr, (lr, steps, count)


def mrstft_pair(params, lr: float, steps: int, k: int):
    jm, tm = bundled_pair(params)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(lr * 1e-2, lr, min(500, max(steps // 20, 1)), steps)))
    jstep = jv.make_vocoder_superstep(jm, tx, JCFG, CROP, k)
    opt = tv.OptaxAdamW(list(tm.parameters()), tv.warmup_cosine_schedule(lr, steps))
    tstep = tv.make_vocoder_superstep(tm, opt, CFG, CROP, k)
    return (jstep, tx), (tstep, opt, tm)


def test_three_guarded_steps_match_jax():
    params, flat = bundled()
    lr, steps = 1e-4, 100
    (jstep, tx), (tstep, opt, tm) = mrstft_pair(params, lr, steps, 3)
    starts = np.random.default_rng(3).integers(0, len(flat) - CROP, size=(3, 2))
    jp, jopt, jl, jg = jstep(params, tx.init(params), jnp.asarray(flat),
                             jnp.asarray(starts, jnp.int32))
    tl, tg = tstep(torch.from_numpy(flat), starts)
    for i in range(3):
        assert rel(tl[i], float(jl[i])) < 1e-4, (i, tl, jl)
        assert rel(tg[i], float(jg[i])) < 1e-4, (i, tg, jg)
    assert opt.count == 3 == int(jopt[1][0].count) == int(jopt[1][2].count)
    lrs = sum(tv.warmup_cosine_schedule(lr, steps)(c) for c in range(3))
    assert max_tree_diff(host(jp), to_flax_params(tm.state_dict())) <= 2 * lrs


@pytest.mark.parametrize("form", ["mel", "wav"])
def test_single_train_steps_match_jax(form):
    """``make_vocoder_train_step`` (a given mel) and ``_wav`` (the crop's own mel, cut
    to ``crop_len // hop`` frames) under optax's chain: one guarded step."""
    params, flat = bundled()
    jm, tm = bundled_pair(params)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-4))
    opt = tv.OptaxAdamW(list(tm.parameters()), 1e-4)
    wav = flat[: 2 * CROP].reshape(2, CROP)
    if form == "mel":
        mels, _ = tv.crop_batch(list(wav), CFG, crop_frames=8, rng=np.random.default_rng(0))
        jp, _, jl, jg = jv.make_vocoder_train_step(jm, tx, JCFG)(
            params, tx.init(params), jnp.asarray(mels), jnp.asarray(wav))
        tl, tg = tv.make_vocoder_train_step(tm, opt, CFG)(torch.from_numpy(mels),
                                                          torch.from_numpy(wav))
    else:
        jp, _, jl, jg = jv.make_vocoder_train_step_wav(jm, tx, JCFG)(
            params, tx.init(params), jnp.asarray(wav))
        tl, tg = tv.make_vocoder_train_step_wav(tm, opt, CFG)(torch.from_numpy(wav))
    assert rel(tl, float(jl)) < 1e-4 and rel(tg, float(jg)) < 1e-4, (tl, jl, tg, jg)
    assert opt.count == 1
    assert max_tree_diff(host(jp), to_flax_params(tm.state_dict())) <= 2e-4


def test_nonfinite_step_keeps_parameters_moments_and_schedule_as_jax():
    params, flat = bundled()
    lr, steps = 1e-4, 100
    (jstep, tx), (tstep, opt, tm) = mrstft_pair(params, lr, steps, 2)
    flat = flat.copy()
    flat[:CROP] = np.nan  # the first step's crops are all NaN
    starts = np.array([[0, 0], [CROP, 3 * CROP]])
    jp, jopt, jl, jg = jstep(params, tx.init(params), jnp.asarray(flat),
                             jnp.asarray(starts, jnp.int32))
    tl, tg = tstep(torch.from_numpy(flat), starts)
    assert not np.isfinite(tl[0]) and not np.isfinite(float(jl[0]))
    assert rel(tl[1], float(jl[1])) < 1e-4 and rel(tg[1], float(jg[1])) < 1e-4
    # one update applied in both: its count, its lr(0), its moments
    assert opt.count == 1 == int(jopt[1][0].count) == int(jopt[1][2].count)
    lr0 = tv.warmup_cosine_schedule(lr, steps)(0)
    assert max_tree_diff(host(jp), to_flax_params(tm.state_dict())) <= 2 * lr0
    names = [n for n, _ in tm.named_parameters()]
    mu = to_flax_params(dict(zip(names, opt.mu)))
    nu = to_flax_params(dict(zip(names, opt.nu)))
    assert max_tree_diff(host(jopt[1][0].mu), mu) < 1e-5
    assert max_tree_diff(host(jopt[1][0].nu), nu) < 1e-7


def test_a_skipped_step_changes_nothing():
    from oron_tts_tpu_torch.utils.weights import init_module_params

    tm = VocosDecoder(dim=32, n_layers=1, intermediate_dim=96, head_mode="mag_phase")
    tm.load_state_dict(from_flax_params(init_module_params(tm, seed=0)))
    opt = tv.OptaxAdamW(list(tm.parameters()), tv.warmup_cosine_schedule(1e-3, 100))
    tstep = tv.make_vocoder_superstep(tm, opt, CFG, CROP, 1)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    flat = corpus(5)
    flat[: 2 * CROP] = np.inf
    losses, gnorms = tstep(torch.from_numpy(flat), np.array([[0, CROP]]))
    assert not np.isfinite(losses[0]) and opt.count == 0
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())
    assert all(not m.any() for m in opt.mu + opt.nu)


# ── host-side crops and packing ─────────────────────────────────────────


def test_crops_and_packing_match_jax():
    rng = np.random.default_rng(9)
    audios = [rng.standard_normal(n).astype(np.float32) for n in (24000, 1000, CROP, 9000)]
    mels_t, wavs_t = tv.crop_batch(audios, CFG, 16, np.random.default_rng(1))
    mels_j, wavs_j = jv.crop_batch(audios, JCFG, 16, np.random.default_rng(1))
    np.testing.assert_array_equal(wavs_t, wavs_j)
    np.testing.assert_array_equal(mels_t, mels_j)
    np.testing.assert_array_equal(tv.crop_wavs(audios, CROP, np.random.default_rng(2)),
                                  jv.crop_wavs(audios, CROP, np.random.default_rng(2)))
    for got, want in zip(tv.pack_corpus(audios, CROP), jv.pack_corpus(audios, CROP)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    flat, offsets, max_starts = tv.pack_corpus(audios, CROP)
    starts = offsets + max_starts  # the last crop of each clip
    crops = tv.gather_crops(torch.from_numpy(flat), torch.from_numpy(starts), CROP).numpy()
    np.testing.assert_array_equal(crops[0], audios[0][-CROP:])
    np.testing.assert_array_equal(crops[1, :1000], audios[1])
