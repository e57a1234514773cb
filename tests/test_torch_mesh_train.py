"""PyTorch port, mesh training on CPU gloo ranks against the single-process port and JAX.

DP 2, TP 2 and DP 2 × TP 2 (four ranks) run two ``F5Trainer`` steps on a
tiny DiT (4 heads, dim 64) over one global batch of four rows whose lengths
differ, so the ranks hold different span counts. Each mesh matches the
single-process port: loss at rtol 1e-5 and every parameter and moment after
two steps at atol 1e-5, with dropout 0 and with dropout 0.1 (the masks are
drawn by global index, so a shard draws its slice of the single-process
mask). The eval loss of the same weights and injected noise ``x0`` matches
the JAX package's ``CFM.loss`` (rtol 1e-5) on one process and on each mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_common import load_npz, rank_results, spawn
import _torch_mesh_worker as W

RUNS = [{"dropout": 0.0}, {"dropout": 0.1}]


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single-process port for each run (one thread, as the ranks have)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("single")
    try:
        return [W.train_two_steps(None, W.tiny_config(r["dropout"]), str(tmp / str(j)))
                for j, r in enumerate(RUNS)]
    finally:
        torch.set_num_threads(threads)


def _jax_eval_loss() -> float:
    from oron_tts_tpu.models import cfm as jcfm
    from oron_tts_tpu.models.dit import DiT as JDiT
    from oron_tts_tpu_torch.utils.weights import seeded_dit_params
    from oron_tts_tpu_torch.config import F5Config

    cfg = F5Config.from_dict(W.tiny_config())
    m = cfg.model
    params = seeded_dit_params(m, seed=0)
    j = jcfm.CFM(JDiT(dim=m.dim, depth=m.depth, heads=m.heads, dim_head=m.dim_head,
                      ff_mult=m.ff_mult, text_dim=m.text_dim, conv_layers=m.conv_layers,
                      dropout=0.0))
    b = W.global_batch()
    val = j.loss({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                 jnp.asarray(b["mel"]), jnp.asarray(b["text_ids"]),
                 jnp.asarray(b["mel_lengths"]), jax.random.PRNGKey(0), train=False,
                 x0=jnp.asarray(b["x0"]))
    return float(val)


def _check_against_single(out, world, single):
    ranks = rank_results(out, world)
    for j, ref in enumerate(single):
        got = ranks[0][j]
        # every rank reports the same global loss and norm
        for r in ranks[1:]:
            assert r[j]["loss"] == got["loss"] and r[j]["grad_norm"] == got["grad_norm"]
        assert got["ok"] == [True, True]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(got["eval_loss"], ref["eval_loss"], rtol=1e-5)
        trees = load_npz(out / f"trees_{j}.npz")
        assert set(trees) == set(ref["flat"])
        for key, want in ref["flat"].items():
            np.testing.assert_allclose(trees[key], want, atol=1e-5, err_msg=key)
    return ranks


def test_single_process_eval_loss_matches_jax(single):
    np.testing.assert_allclose(single[0]["eval_loss"], _jax_eval_loss(), rtol=1e-5)


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)], ids=["dp2", "tp2", "dp2xtp2"])
def test_mesh_steps_match_the_single_process(dp, tp, single, tmp_path):
    spawn("train", dp * tp, tmp_path, {"dp": dp, "tp": tp, "runs": RUNS})
    ranks = _check_against_single(tmp_path, dp * tp, single)
    # TP keeps heads/TP heads and a TP share of the projections on each rank
    full = single[0]["param_numel"]
    assert all(r[0]["param_numel"] == ranks[0][0]["param_numel"] for r in ranks)
    assert (ranks[0][0]["param_numel"] < full) == (tp > 1)
    np.testing.assert_allclose(ranks[0][0]["eval_loss"], _jax_eval_loss(), rtol=1e-5)

