"""The port's MPD and MRD discriminators and the GAN stage against the JAX package.

Carried flax weights (``utils/weights.py`` keeps the 4-D kernels in flax's
layout both ways), the same numpy-seeded waveforms. Logits and feature maps
are held within 1e-4 of the largest value (features: the port's NCHW
permuted to flax's NHWC) at every period 2 to 11, at a segment shorter than
the period (the constant pad) and one just longer (the reflect pad), and at
an MRD resolution whose frequency width is even, where lax's ``"SAME"`` pad
of the stride-2 convs is asymmetric.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oron_tts_tpu.models import discriminators as jd
from oron_tts_tpu.train import vocoder as jv
from oron_tts_tpu_torch.models import discriminators as td
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
    tiny_disc,
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


def carried(jax_module, torch_module, wav: np.ndarray, seed: int = 0):
    """Init the flax module, carry its tree into the torch one; both outputs."""
    params = host(jax_module.init(jax.random.PRNGKey(seed), jnp.asarray(wav))["params"])
    torch_module.load_state_dict(from_flax_params(params), strict=True)
    back = to_flax_params(torch_module.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back),
                                                    jax.tree_util.tree_leaves(params)))
    want = jax_module.apply({"params": params}, jnp.asarray(wav))
    with torch.no_grad():
        got = torch_module(torch.from_numpy(wav))
    return want, got


def assert_close(want, got) -> None:
    (j_logits, j_feats), (t_logits, t_feats) = want, got
    scale = float(np.abs(np.asarray(j_logits)).max())
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-4 * scale)
    assert len(t_feats) == len(j_feats)
    for j, t in zip(j_feats, t_feats):
        j = np.asarray(j)
        t = t.permute(0, 2, 3, 1).numpy()  # NCHW → flax's NHWC
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * float(np.abs(j).max()))


@pytest.mark.parametrize("period,length", [(2, 1000), (3, 1000), (5, 1000), (7, 1001),
                                           (11, 997), (11, 3), (7, 4)])
def test_period_discriminator_matches_jax(period, length):
    """length 3 at period 11 pads 8 ≥ 3 samples: the constant pad; 4 at period 7
    pads 3 < 4: the reflect pad of a segment shorter than the period."""
    wav = corpus(period)[: 2 * length].reshape(2, length)
    assert_close(*carried(jd.PeriodDiscriminator(period), td.PeriodDiscriminator(period), wav))


@pytest.mark.parametrize("n_fft,hop", [(510, 128), (512, 128), (254, 64)])
def test_resolution_discriminator_matches_jax(n_fft, hop):
    """n_fft 510 and 254: frequency widths 256 and 128, even through every stride-2
    conv, so lax's SAME pad is (3, 4) there; 512: the odd widths 257 → 129."""
    wav = corpus(n_fft)[: 2 * 3000].reshape(2, 3000)
    assert_close(*carried(jd.ResolutionDiscriminator(n_fft, hop),
                          td.ResolutionDiscriminator(n_fft, hop), wav))


@pytest.mark.parametrize("size,k,s", [(257, 9, 2), (256, 9, 2), (129, 9, 1), (5, 3, 1),
                                      (1, 9, 2), (64, 3, 2)])
def test_same_pad_is_lax(size, k, s):
    from jax import lax

    out = -(-size // s)
    (lo, hi), = lax.padtype_to_pads((size,), (k,), (s,), "SAME")
    assert td.same_pad(size, k, s) == (lo, hi)
    assert (size + lo + hi - k) // s + 1 == out


def test_vocoder_discriminator_matches_jax():
    """The full bundle: MPD (2, 3, 5, 7, 11) and MRD (512, 1024, 2048) on a 0.1 s crop."""
    wav = corpus(21)[: 2 * 2400].reshape(2, 2400)
    (j_logits, j_feats), (t_logits, t_feats) = carried(
        jd.VocoderDiscriminator(), td.VocoderDiscriminator(), wav, seed=3)
    assert len(t_logits) == len(j_logits) == 8
    for jl, jf, tl, tf in zip(j_logits, j_feats, t_logits, t_feats):
        assert_close((jl, jf), (tl, tf))


def test_gan_superstep_matches_jax():
    """K=2 (d-step, g-step) pairs with the bundled generator and a seeded
    discriminator under optax's chain(clip 1.0, adamw(1e-4, 0.8, 0.99)):
    metrics [2, 4] (g_loss, d_loss, mel_l1, g_gnorm) within 1e-4 relative,
    and both nets' parameters within 2·Σ lr."""
    params, flat = bundled()
    jm, tm = bundled_pair(params)
    jdisc, dp, tdisc = tiny_disc()
    lr = 1e-4

    def chain():
        return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, b1=0.8, b2=0.99))

    g_tx, d_tx = chain(), chain()
    jstep = jv.make_gan_superstep(jm, jdisc, g_tx, d_tx, JCFG, CROP, 2)
    g_opt = tv.OptaxAdamW(list(tm.parameters()), lr, b1=0.8, b2=0.99)
    d_opt = tv.OptaxAdamW(list(tdisc.parameters()), lr, b1=0.8, b2=0.99)
    tstep = tv.make_gan_superstep(tm, tdisc, g_opt, d_opt, CFG, CROP, 2)
    starts = np.array([[0, 2 * CROP], [CROP // 2, 4 * CROP]])
    jg, _, jdp, _, jmetrics = jstep(params, g_tx.init(params), dp, d_tx.init(dp),
                                    jnp.asarray(flat), jnp.asarray(starts, jnp.int32))
    m = tstep(torch.from_numpy(flat), starts)
    jmetrics = np.asarray(jmetrics)
    assert m.shape == (2, 4) and np.isfinite(m).all()
    for i in range(2):
        for c in range(4):
            assert rel(m[i, c], jmetrics[i, c]) < 1e-4, (i, c, m, jmetrics)
    assert g_opt.count == d_opt.count == 2
    assert max_tree_diff(host(jg), to_flax_params(tm.state_dict())) <= 4 * lr
    assert max_tree_diff(host(jdp), to_flax_params(tdisc.state_dict())) <= 4 * lr


def test_gan_train_steps_match_jax():
    """The unguarded pair under ``optax.adamw(1e-4)`` (no clip): the d-step's loss
    within 1e-4 relative; the g-step's total and its four parts, after the
    d-step moved the discriminator, within 1e-3 (a random-init generator,
    whose gradient is ill-conditioned; see test_torch_vocoder_training.py)."""
    jm, gp, tm = tiny_vocoder()
    jdisc, dp, tdisc = tiny_disc()
    g_tx, d_tx = optax.adamw(1e-4), optax.adamw(1e-4)
    j_g, j_d = jv.make_gan_train_steps(jm, jdisc, g_tx, d_tx, JCFG)
    g_opt = tv.OptaxAdamW(list(tm.parameters()), 1e-4, max_norm=math.inf)
    d_opt = tv.OptaxAdamW(list(tdisc.parameters()), 1e-4, max_norm=math.inf)
    t_g, t_d = tv.make_gan_train_steps(tm, tdisc, g_opt, d_opt, CFG)
    wav = corpus(8)[: 2 * CROP].reshape(2, CROP)
    mels, _ = tv.crop_batch(list(wav), CFG, crop_frames=8, rng=np.random.default_rng(0))
    dp2, _, jd_loss = j_d(dp, d_tx.init(dp), gp, jnp.asarray(mels), jnp.asarray(wav))
    d_loss = t_d(torch.from_numpy(mels), torch.from_numpy(wav))
    assert rel(d_loss, float(jd_loss)) < 1e-4
    _, _, jg_loss, jaux = j_g(gp, g_tx.init(gp), dp2, jnp.asarray(mels), jnp.asarray(wav))
    g_loss, aux = t_g(torch.from_numpy(mels), torch.from_numpy(wav))
    assert rel(g_loss, float(jg_loss)) < 1e-3, (g_loss, float(jg_loss))
    for got, want in zip(aux, jaux):
        assert rel(got, float(want)) < 1e-3, (aux, jaux)
    assert g_opt.count == d_opt.count == 1
    assert max_tree_diff(host(dp2), to_flax_params(tdisc.state_dict())) <= 2e-4
