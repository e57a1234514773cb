"""On the card: the program passes its checks and the control fails them.

The training check is the cell's; the serving check (Small's widths under the
voice-cloned mix) is the one a serving cell will use once one is back in
``BENCHMARK.json`` (``PERF.md``, Open questions).

The control is the reference put in the program's place one precision below
the configuration's (float8 e4m3 products for the bfloat16 DiT, TF32 for the
float32 vocoder and mel). Run on the card with
``python -m pytest portbench/tests -m card``; here they skip. At the cells'
own sizes the same readings come from ``python3 -m portbench.calibrate``
(``PERF.md`` gives them); these hold them at a size a test run can hold.
"""

from __future__ import annotations

import json
import time

import pytest

from portbench import check, serving, training
from portbench import run as prun
from portbench import traffic as tr
from portbench.tests import tiny
from portbench.tests.tiny import ROOT


def _cfg(name: str, depth: int) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg["model"]["depth"] = depth
    return cfg


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_cloned_serving_passes_and_its_control_fails(card, seed):
    cfg = tiny.small(4)
    mix = tiny.load_mix("cloned_solo")
    traffic = tr.generate(mix, seed, 8.0)
    stack = serving.Stack(cfg, seed, "cuda", mix["server"])
    try:
        out = serving.measure(stack, cfg, traffic, seed, 8.0, False, time.perf_counter())
    finally:
        stack.close()
    lim = tiny.SERVE_LIMITS
    for control, want in ((False, True), (True, False)):
        out["checks"] = check.serving(cfg, traffic, out["served"], out["checked"], out["mels"],
                                      seed, stack.shapes, "cuda", control=control, root=ROOT)
        ok, compared = prun.verdict(out, lim)
        assert ok is want, compared


@pytest.mark.card
@pytest.mark.parametrize("fault", [None, "half_batch", "loss_altered", "unchanged"])
def test_training_passes_and_its_faults_and_control_fail(card, fault):
    cfg = _cfg("oron-base", 4)
    mix = tr.load_mix(ROOT, "runpod_frames")
    mix["corpus"]["clips"] = 120
    out = training.run({"name": "base.train.48k"}, cfg, mix, 2**31 + 9, 1.0, False, "cuda",
                       time.perf_counter(), ROOT, fault=fault, control=fault is None)
    lim = check.load_limits(ROOT, "base.train.48k")
    ok, compared = prun.verdict(out, lim)
    assert ok is (fault is None), compared
    if fault is None:
        ok, compared = prun.verdict({"checks": out["control"]}, lim)
        assert not ok, compared
