"""``cli.bench_grad_accum --smoke``: the accumulation windows and the fused step on
a tiny CPU model, each timed, finite and applied."""

from __future__ import annotations

import math

import pytest
import torch

from oron_tts_tpu_torch.cli import bench_grad_accum


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models on one intra-op thread: on a CPU shared by several test workers,
    each op's thread team would otherwise wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_smoke_times_every_mode():
    out = bench_grad_accum.main(["--smoke"])
    assert out["device"] == "cpu" and out["micro_batch"] == [2, 128] and out["accum"] == 2
    assert out["fused_batch"] == [4, 128]
    for mode in ("pipelined", "per-micro host sync", "remat", "fused"):
        row = out[mode]
        assert row["ok"] and math.isfinite(row["loss"]) and row["ms"] > 0
        assert row["frames_per_s"] == pytest.approx(4 * 128 / row["ms"] * 1e3)
    assert out["window_over_fused"] > 0 and math.isfinite(out["sync_cost"])


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_grad_accum.main([])
