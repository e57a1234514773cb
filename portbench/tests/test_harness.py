"""The harness end to end on the CPU at a tiny width, and the faults ``correct`` must catch.

The program runs its plain (CPU) kernels in float32 here, so its readings are
far below the limits set on the card for bfloat16; each planted fault breaks
the timed path underneath and must turn ``correct`` false under the cell's
own limits.
"""

from __future__ import annotations

import copy
import json
import time

import numpy as np
import pytest
import torch

from portbench import check, serving, training
from portbench import run as prun
from portbench import traffic as tr
from portbench.tests import tiny

SEED = 2**31 + 12345


def serve(mix_name: str, cfg_name: str, seconds: float = 3.0, fault: str | None = None,
          rate: float | None = None) -> dict:
    cfg, mix = tiny.config(cfg_name), tiny.mix(mix_name)
    if rate:
        mix["rate_per_s"] = rate
    traffic = tr.generate(mix, SEED, seconds)
    stack = serving.Stack(cfg, SEED, "cpu", mix.get("server", {}))
    if fault:
        plant(stack.model, fault)
    try:
        out = serving.measure(stack, cfg, traffic, SEED, seconds, False, time.perf_counter())
    finally:
        stack.close()
    out["checks"] = check.serving(cfg, traffic, out["served"], out["checked"], out["mels"], SEED,
                                  stack.shapes, "cpu", root=tiny.ROOT)
    return out


def plant(model, fault: str) -> None:
    if fault == "unchanged":  # every Euler step returns the state it was given
        def still(x, *a, **k):
            z = torch.zeros_like(x)
            return z, z
        model.backbone.forward_cfg = still
    elif fault == "half_batch":  # half of a merged batch solved, its answers handed round
        batch = model.synthesize_batch

        def half(texts, *a, seeds=None, **k):
            n = max(1, -(-len(texts) // 2))
            wavs = batch(texts[:n], *a, seeds=seeds[:n], **k)
            return [wavs[i % n] for i in range(len(texts))]
        model.synthesize_batch = half
    elif fault == "answer_altered":  # the waveform changed where it is produced
        decode = model._decode_mel_group
        model._decode_mel_group = lambda mel, lens: decode(mel, lens) * 1.02
    else:
        raise ValueError(fault)


def limits(cell: str) -> dict:
    """A cell's limits; the serving test mixes, whose cells are not in BENCHMARK.json
    (PERF.md), are held to the serving check's limits kept beside them."""
    if cell in ("base.serve.poisson", "base.serve.bulk", "small.serve.cloned"):
        return copy.deepcopy(tiny.SERVE_LIMITS)
    return check.load_limits(tiny.ROOT, cell)


@pytest.mark.parametrize("mix_name,cfg_name,cell", [
    ("open_loop", "oron-base", "base.serve.poisson"),
    ("cloned_solo", "oron-base", "small.serve.cloned"),
    ("clients", "oron-base", "base.serve.bulk"),
])
def test_a_serving_cell_runs_and_is_correct(mix_name, cfg_name, cell):
    out = serve(mix_name, cfg_name)
    ok, compared = prun.verdict(out, limits(cell))
    assert ok, (compared, out["checks"]["problems"])
    assert out["attempted"] > 0 and out["failed"] == 0
    assert 0 < out["latency_p90_s"] < 60 and out["audio_s_per_s"] > 0
    assert len(out["checks"]["requests"]) >= 1
    assert set(compared) <= set(limits(cell))  # every number beside its limit


@pytest.mark.parametrize("fault,mix_name,cfg_name,cell", [
    ("unchanged", "open_loop", "oron-base", "base.serve.poisson"),
    ("half_batch", "open_loop", "oron-base", "base.serve.poisson"),
    ("answer_altered", "open_loop", "oron-base", "base.serve.poisson"),
    ("unchanged", "cloned_solo", "oron-base", "small.serve.cloned"),
    ("answer_altered", "cloned_solo", "oron-base", "small.serve.cloned"),
])
def test_a_serving_fault_is_not_correct(fault, mix_name, cfg_name, cell):
    out = serve(mix_name, cfg_name, fault=fault, rate=10.0 if fault == "half_batch" else None)
    ok, compared = prun.verdict(out, limits(cell))
    assert not ok, (compared, out["checks"])


def train(fault: str | None = None) -> dict:
    return training.run({"name": "t"}, tiny.train_config(), tiny.mix("runpod_frames"), SEED, 2.0,
                        False, "cpu", time.perf_counter(), tiny.ROOT, fault=fault)


def test_the_training_cell_runs_and_is_correct():
    out = train()
    ok, compared = prun.verdict(out, limits("base.train.48k"))
    assert ok, compared
    assert out["train_frames_per_s"] > 0 and out["attempted"] > 0
    assert out["checks"]["steps"]["loss"] == pytest.approx(
        out["checks"]["steps"]["reference_loss"], rel=1e-5)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "loss_altered", "skipped"])
def test_a_training_fault_is_not_correct(fault):
    ok, compared = prun.verdict(train(fault), limits("base.train.48k"))
    assert not ok, compared


def test_the_result_line_keeps_to_the_contract():
    rec = train()
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == "base.train.48k")
    metrics = prun.end_to_end(bench, cell, rec)
    assert set(metrics) == {"train_frames_per_s", "setup_s"}
    assert all(np.isfinite(m["value"]) and m["value"] > 0 for m in metrics.values())
