"""PyTorch port, ``CFM.sample(hoist_t_mods=False)`` and ``cli.bench_sampler_levers``.

With the tables off the sampler runs the timestep MLP and every AdaLN
projection inside each forward, from the step's time (the midpoint's half
step as the JAX sampler computes it there: ``t + dt/2``). The contract of the
JAX package's ``tests/test_t_mods_hoist.py``: the per-step solve equals the
hoisted one within f32 rounding; and it equals the JAX package's per-step
solve on the same weights and injected noise. Same tiny perturbed DiT, ragged
batch and f32 as ``test_torch_sample_contract.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oron_tts_tpu.models.cfm import sway_timesteps
from oron_tts_tpu_torch.cli import bench_sampler_levers
from test_torch_batch import DURATIONS, LENS, _sample_inputs
from test_torch_serve_load import one_thread  # noqa: F401 (autouse: tiny models)
from test_torch_slice import _jax_model, _port_model

# five steps: the one count of 4, 5, 8, 16 and 32 at which the two half-step
# formulas, (t0 + t1) / 2 and t0 + (t1 - t0) / 2, differ in f32 (at one step)
STEPS = 5


@pytest.fixture(scope="module")
def models():
    return _jax_model(), _port_model()


def _solve(pm, **kw):
    cond, ids, noise = _sample_inputs()
    mel, _ = pm.cfm.sample(torch.from_numpy(cond), torch.from_numpy(ids),
                           torch.from_numpy(DURATIONS), torch.from_numpy(LENS), steps=STEPS,
                           sway_sampling_coef=-1.0, noise=torch.from_numpy(noise.copy()), **kw)
    return mel.numpy()


@pytest.mark.parametrize("method", ["euler", "midpoint"])
@pytest.mark.parametrize("cfg_strength,cfg_interval", [(2.0, None), (0.0, None), (2.0, (0.1, 0.7))],
                         ids=["cfg2", "cfg0", "cfg2-interval"])
def test_per_step_solve_matches_the_hoisted_one(models, method, cfg_strength, cfg_interval):
    _, pm = models
    kw = dict(cfg_strength=cfg_strength, cfg_interval=cfg_interval, method=method)
    np.testing.assert_allclose(_solve(pm, hoist_t_mods=False, **kw), _solve(pm, **kw), atol=1e-5)


# f32 on both sides, five steps of a two-block model: the parity tolerance of
# tests/test_torch_sample_contract.py
@pytest.mark.parametrize("kw", [
    dict(),
    dict(method="midpoint"),
    dict(method="midpoint", cfg_interval=(0.1, 0.7)),
], ids=["euler", "midpoint", "midpoint+interval"])
def test_per_step_solve_matches_jax(models, kw):
    jm, pm = models
    cond, ids, noise = _sample_inputs()
    ref, _ = jm.cfm.sample(jm.variables, cond, ids, DURATIONS, LENS, steps=STEPS,
                           cfg_strength=2.0, sway_sampling_coef=-1.0, noise=noise,
                           hoist_t_mods=False, **kw)
    out = _solve(pm, cfg_strength=2.0, hoist_t_mods=False, **kw)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4)


def test_midpoint_times_follow_each_jax_path_bit_for_bit(models):
    """Per step: ``t`` then JAX's ``t + dt/2``; hoisted: the grid, then ``(t0 + t1) / 2``."""
    _, pm = models
    seen = []
    hook = pm.backbone.time_embed.register_forward_pre_hook(
        lambda module, args: seen.append(args[0].numpy().copy()))
    try:
        _solve(pm, cfg_strength=2.0, method="midpoint", hoist_t_mods=False)
        per_step = np.stack(seen)
        seen.clear()
        _solve(pm, cfg_strength=2.0, method="midpoint")
        hoisted = seen[0]
    finally:
        hook.remove()
    g = sway_timesteps(STEPS, -1.0)
    half = np.asarray(g[:-1] + (g[1:] - g[:-1]) / 2)
    want = np.stack([np.asarray(g[:-1]), half], axis=1).reshape(-1)
    np.testing.assert_array_equal(per_step, np.repeat(want[:, None], len(DURATIONS), axis=1))
    table = np.asarray(jnp.concatenate([g[:-1], (g[:-1] + g[1:]) / 2]))
    np.testing.assert_array_equal(hoisted, table)
    assert (half != table[STEPS:]).any()  # the two formulas part somewhere at this count


def test_smoke_runs_every_lever():
    out = bench_sampler_levers.main(["--smoke"])
    assert out["device"] == "cpu" and out["frames"] == 104 and out["bucket"] == 128
    assert list(out["cases"]) == [label for label, *_ in bench_sampler_levers.CASES]
    assert len(out["cases"]) == 8
    for label, row in out["cases"].items():
        assert math.isfinite(row["mel_abs_mean"]) and row["solve_s"] > 0, label
        assert row["steps"] == (2 if "midpoint" in label else 4)
        assert row["vs"] is None or math.isfinite(row["rel_l2"])
    assert out["cases"]["no-hoist"]["rel_l2"] < 1e-5  # the same math in f32


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_sampler_levers.main([])
