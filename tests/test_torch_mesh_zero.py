"""PyTorch port, ZeRO-1 (``shard_opt_states: true``) on a CPU gloo mesh.

DP 2 × TP 2, two ``F5Trainer`` steps with the AdamW moments split over the
data group against the same mesh with replicated moments (and both against
one process): the same losses (rtol 1e-5) and parameters and moments after
two steps (atol 1e-5), and each rank holding half of every moment that
``opt_specs`` splits (the JAX package's ``test_zero1_opt_sharding_matches_replicated``).
The ZeRO-1 state saved by rank 0 resumes on every rank bit for bit; its
gradient collectives run in many small flat buckets.
"""

from __future__ import annotations

import numpy as np
import torch

from _torch_mesh_common import load_npz, rank_results, spawn
import _torch_mesh_worker as W


def test_zero1_matches_replicated_moments(tmp_path):
    # the ZeRO-1 run's collectives in buckets of 4,096 elements: many flat buffers
    runs = [{"zero": False}, {"zero": True, "dropout": 0.1, "resume": True, "bucket": 4096},
            {"zero": False, "dropout": 0.1}]
    spawn("train", 4, tmp_path, {"dp": 2, "tp": 2, "runs": runs})
    ranks = rank_results(tmp_path, 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = W.train_two_steps(None, W.tiny_config(0.1), str(tmp_path / "single"))
    finally:
        torch.set_num_threads(threads)
    rep, zero = ranks[0][2], ranks[0][1]
    np.testing.assert_allclose(zero["loss"], rep["loss"], rtol=1e-5)
    np.testing.assert_allclose(zero["grad_norm"], rep["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(zero["loss"], single["loss"], rtol=1e-5)
    t_rep, t_zero = load_npz(tmp_path / "trees_2.npz"), load_npz(tmp_path / "trees_1.npz")
    for key, want in single["flat"].items():
        np.testing.assert_allclose(t_zero[key], t_rep[key], atol=1e-5, err_msg=key)
        np.testing.assert_allclose(t_zero[key], want, atol=1e-5, err_msg=key)
    for r in ranks:
        # saved by rank 0 alone (ranks > 0 have no file), resumed on every rank by
        # broadcast, each rank taking its TP shards and ZeRO-1 blocks back
        assert r[1]["resume_equal"] is True
        split = r[1]["split_moment_numel"]
        assert r[0]["split_moment_numel"] == 0 and split > 0
        # each rank holds half of every split moment, the rest whole
        assert r[1]["moment_numel"] == r[0]["moment_numel"] - split
        assert any(a is not None for a in r[1]["zero_axes"])
        assert r[1]["zero_axes"] == ranks[0][1]["zero_axes"]
