"""PyTorch port, ``CFM.sample``'s ``(mel, trajectory)`` contract against the JAX package.

The JAX sampler returns ``(mel, trajectory)``: the trajectory is None unless
asked for, else ``[steps + 1, B, T, M]`` with the initial noise first and
one row per step (for either solver), stacked across the ``cfg_interval``
segments; ``cond`` longer than ``max_duration`` frames raises. Same tiny
perturbed DiT, ragged batch and injected noise on both sides, f32.
"""

import numpy as np
import pytest
import torch

from test_torch_batch import DURATIONS, LENS, _sample_inputs
from test_torch_serve_load import one_thread  # noqa: F401 (autouse: tiny models)
from test_torch_slice import _jax_model, _port_model

STEPS = 5


@pytest.fixture(scope="module")
def models():
    return _jax_model(), _port_model()


def _args(cond, ids):
    return (torch.from_numpy(cond), torch.from_numpy(ids), torch.from_numpy(DURATIONS),
            torch.from_numpy(LENS))


# f32 on both sides, five steps of a two-block model: the parity tolerance of
# tests/test_torch_slice.py
@pytest.mark.parametrize("kw", [
    dict(),
    dict(method="midpoint"),
    dict(cfg_interval=(0.1, 0.7)),
    dict(cfg_interval=(0.1, 0.7), method="midpoint"),
], ids=["euler", "midpoint", "interval", "interval+midpoint"])
def test_trajectory_matches_jax(models, kw):
    jm, pm = models
    cond, ids, noise = _sample_inputs()
    ref_mel, ref_traj = jm.cfm.sample(
        jm.variables, cond, ids, DURATIONS, LENS, steps=STEPS, cfg_strength=2.0,
        sway_sampling_coef=-1.0, noise=noise, return_trajectory=True, **kw)
    mel, traj = pm.cfm.sample(*_args(cond, ids), steps=STEPS, cfg_strength=2.0,
                              sway_sampling_coef=-1.0, noise=torch.from_numpy(noise.copy()),
                              return_trajectory=True, **kw)
    assert traj.shape == (STEPS + 1, *cond.shape) == np.asarray(ref_traj).shape
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj), atol=1e-4)
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), atol=1e-4)
    # the first row is the noise, zero past each row's duration; the last is
    # the final state, which the mel takes outside the conditioning frames
    valid = np.arange(cond.shape[1])[None, :, None] < DURATIONS[:, None, None]
    np.testing.assert_array_equal(traj[0].numpy(), np.where(valid, noise, 0.0))
    generated = np.arange(cond.shape[1])[None, :, None] >= LENS[:, None, None]
    np.testing.assert_array_equal(np.where(generated, traj[-1].numpy(), cond), mel.numpy())


def test_trajectory_is_none_by_default_and_the_mel_is_unchanged(models):
    _, pm = models
    cond, ids, noise = _sample_inputs()
    kw = dict(steps=STEPS, cfg_strength=2.0, sway_sampling_coef=-1.0)
    mel, traj = pm.cfm.sample(*_args(cond, ids), noise=torch.from_numpy(noise.copy()), **kw)
    assert traj is None
    mel_t, traj_t = pm.cfm.sample(*_args(cond, ids), noise=torch.from_numpy(noise.copy()),
                                  return_trajectory=True, **kw)
    assert torch.equal(mel, mel_t) and traj_t.device == mel.device


def test_max_duration_refused_before_any_work(models, monkeypatch):
    jm, pm = models
    cond, ids, noise = _sample_inputs()

    def no_launch(*args, **kwargs):
        raise AssertionError("the backbone ran")

    monkeypatch.setattr(pm.backbone, "forward", no_launch)
    monkeypatch.setattr(pm.backbone, "embed_text", no_launch)
    with pytest.raises(ValueError, match="max_duration=63"):
        pm.cfm.sample(*_args(cond, ids), steps=2, max_duration=63)
    with pytest.raises(ValueError, match="max_duration=63"):
        jm.cfm.sample(jm.variables, cond, ids, DURATIONS, LENS, steps=2, max_duration=63)
    # the bound is inclusive, as in JAX: T frames pass max_duration=T
    monkeypatch.undo()
    mel, _ = pm.cfm.sample(*_args(cond, ids), steps=1, noise=torch.from_numpy(noise.copy()),
                           max_duration=cond.shape[1])
    assert mel.shape == cond.shape
