"""The program's spans beside the device trace (``portbench/program_trace.py``): the six
readings on a recorded trace with known answers, the reductions they rest on, the
clock the program and the benchmark share, and on the card a short traced run."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import program_trace as pt
from portbench import record

MS = 1_000_000  # ns
SHIFT = 1_000  # the device and runtime clock minus the host's, ns


def _ms(x: float) -> int:
    return round(x * MS)


def _span(i, name, a, b, parent=None, step=None):
    return {"id": i, "name": name, "t0": _ms(a), "t1": _ms(b), "parent": parent, "step": step}


# Host clock, ms. The trace runs [0, 100]; the stretch read starts with the first step (4)
# and holds two whole steps, a third cut by its end.
SPANS = [
    _span(1, "loader.wait", 1, 3),
    _span(2, "train.step", 4, 44, step=0),
    _span(3, "train.h2d", 5, 7, 2, 0), _span(4, "train.forward", 7, 20, 2, 0),
    _span(5, "cfm.draw", 8, 12, 4, 0), _span(6, "train.backward", 20, 30, 2, 0),
    _span(7, "train.grads", 30, 32, 2, 0), _span(8, "train.read", 32, 38, 2, 0),
    _span(9, "train.update", 38, 43, 2, 0),
    _span(10, "loader.wait", 45, 46),
    _span(11, "train.step", 50, 90, step=1),
    _span(12, "train.h2d", 51, 53, 11, 1), _span(13, "train.forward", 53, 70, 11, 1),
    _span(14, "cfm.draw", 54, 56, 13, 1), _span(15, "train.update", 80, 88, 11, 1),
    _span(16, "train.step", 95, 105, step=2),
]
# (name, device start, device end, launch or None), host clock, ms
OPS = [
    ("Memcpy HtoD", 6.1, 6.5, 6), ("k1", 13, 19, 9), ("k2", 22, 30.005, 21),
    ("k3", 30.01, 31, 30.5), ("spin_kernel", 33.5, 33.501, 32.5), ("k4", 39, 42, 39),
    ("k5", 60, 75, 55), ("k6", 81, 85, 81), ("k7", 96, 97, None),
]
BENCH_SPANS = [{"name": "data wait", "t0": _ms(0.5), "t1": _ms(3.5)},
               {"name": "step", "t0": _ms(3.5), "t1": _ms(47)},
               {"name": "update", "t0": _ms(31.5), "t1": _ms(43.5)},
               {"name": "step", "t0": _ms(47), "t1": _ms(90.2)}]
COUNTERS = {"collate.frames_kept": 750, "collate.frames_collated": 1000}


class _Event:
    def __init__(self, name, start, end, corr, cuda):
        self.v = (name, start, end, corr, cuda)

    def name(self):
        return self.v[0]

    def start_ns(self):
        return self.v[1]

    def end_ns(self):
        return self.v[2]

    def correlation_id(self):
        return self.v[3]

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self.v[4] else torch.autograd.DeviceType.CPU


def _profiler():
    """A finished profiler's events on the device's clock: each operation, and the runtime
    call that launched it under the same correlation id."""
    events = []
    for corr, (name, s, e, at) in enumerate(OPS, start=101):
        events.append(_Event(name, _ms(s) + SHIFT, _ms(e) + SHIFT, corr, True))
        if at is not None:
            events.append(_Event("cudaLaunchKernel", _ms(at) + SHIFT, _ms(at) + SHIFT + 3_000,
                                 corr, False))
    events.append(_Event("cudaStreamSynchronize", 0, 10, 999, False))  # launches nothing
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


@pytest.fixture
def traced() -> dict:
    ops = pt.launched(*pt.read_launches(_profiler()), lambda t: t - SHIFT, lambda t: t - SHIFT)
    rec = {"window_s": 0.1, "idle_gaps": {}}
    box = {"t0": 0, "t1": _ms(100)}
    return pt.extend(rec, box, BENCH_SPANS, {"spans": SPANS, "counters": COUNTERS}, ops)


CASES = [
    ("loader_wait_ms.train", 0.5),  # 1 ms over two whole steps; the stretch starts at 4 ms
    ("collate_pad_share.train", 25.0),
    ("feed_ms.train", 5.0),  # h2d (2 + 2) and draw (4 + 2) over two
    ("update_host_ms.train", 6.5),  # (5 + 8) over two
    ("launch_idle_share.train", 100 * 3.005 / 96),  # backward 3 ms and grads 5 us of 96
    ("launches_per_step.train", 3.5),  # seven matched launches inside the two steps
]


@pytest.mark.parametrize("name,want", CASES, ids=[c[0] for c in CASES])
def test_reading_on_a_recorded_trace(traced, name, want):
    assert pt.METRICS[name](traced) == pytest.approx(want)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reading_that_finds_nothing_returns_none(name):
    assert pt.METRICS[name]({"seconds": 40.0, "kernels": {}, "window_s": 10.0}) is None


def test_every_reading_has_a_case():
    assert set(pt.METRICS) == {c[0] for c in CASES}


def test_idle_by_span_gives_every_gap_to_the_innermost_own_time(traced):
    idle = traced["idle_by_span"]
    # [6.5, 13] ms lies inside train.forward; its midpoint is in cfm.draw's own interval
    assert idle["cfm.draw"] == pytest.approx(6.5e-3)
    assert "train.forward" not in idle
    # a 5 us gap, under the breakdown's 20 us, still goes to its span
    assert idle["train.grads"] == pytest.approx(5e-6)
    assert idle["train.backward"] == pytest.approx(3e-3)
    assert idle["train.read"] == pytest.approx(7.999e-3)
    assert idle["train.h2d"] == pytest.approx(20.1e-3)  # [4, 6.1] and [42, 60] ms
    assert idle["train.step"] == pytest.approx(9e-3)  # own time of step 1, and step 2 cut
    assert idle[pt.OUTSIDE] == pytest.approx(11e-3)
    busy = sum(e - s for _, s, e, _ in OPS) * 1e-3
    assert sum(idle.values()) == pytest.approx(0.096 - busy)
    assert traced["program_window_s"] == pytest.approx(0.096)


def test_a_kernel_is_credited_to_the_span_open_at_its_launch(traced):
    by = traced["launches_by_span"]
    # k1 and k5 were launched in cfm.draw and ran while the host was in train.forward
    assert by["cfm.draw"] == [2, pytest.approx(0.021)]
    assert "train.forward" not in by
    assert by["train.h2d"][0] == by["train.backward"][0] == by["train.grads"][0] == 1
    assert by["train.update"][0] == 2
    assert by["unmatched"][0] == 1  # k7: no runtime call carries its id
    assert sum(n for n, _ in by.values()) == len(OPS) - 1  # the marker left out
    assert traced["launches_matched"] == 7 and traced["launches_in_steps"] == 7


def test_breakdown_names_a_program_span_open_inside_a_benchmark_span(traced):
    gaps = traced["idle_gaps"]
    assert gaps["train.step"] == pytest.approx(9e-3)  # [75, 81] and [97, 100] ms
    assert gaps["train.read"] == pytest.approx(7.999e-3)  # inside the benchmark's update
    assert gaps["train.h2d"] == pytest.approx(20.1e-3)
    assert "data wait" not in gaps  # before the first step: out of the stretch
    assert gaps["between launches"] == pytest.approx(5e-6)
    assert "update" not in gaps
    assert gaps.get("step", 0.0) == 0.0


def test_clocks_follow_the_device_clock_wandering_against_the_calls():
    """Runtime calls sit a fixed offset off the host clock; the device clock drifts 3.3 us
    a ms off them, then jumps back. Each kernel below starts on an idle device, 80 us
    after the one before ends."""
    call_off, latency, end_host, n = 5_000, 8_000, 300 * MS, 2000
    ops, calls, truth = [], {}, []
    for i in range(n):
        host = i * 100_000
        wander = -330 * i if i < n // 2 else 0
        start = host + call_off + latency + wander
        ops.append(("k", start, start + 20_000, i + 1))
        calls[i + 1] = host + call_off
        truth.append(host)
    ops.append(("spin_kernel", end_host + call_off + latency, end_host + call_off + 30_000, 999_999))
    calls[999_999] = end_host + call_off + 2_000  # Python between the stamp and the call
    box = {"marker_host_end": end_host, "marker_host": 0}
    device, call = pt.clocks(ops, calls, box)
    # the anchor's launch lands on its stamp: every call reads the 2 us early
    assert call(calls[999_999]) == end_host
    assert [call(calls[i + 1]) for i in range(n)] == [h - 2_000 for h in truth]
    for i, (_, s, _, _) in enumerate(ops[:n]):
        # the first has no gap before it; the least of 7 readings straddles the jump; the
        # last ones read the anchor's own 2 us with theirs
        if i > 0 and abs(i - n // 2) > 3:
            assert abs(device(s) - call(calls[i + 1])) <= 2_500, i
    assert box["clock_wander_us"][0] == pytest.approx((latency - 330 * (n // 2 - 1)) / 1e3, abs=1)
    assert box["clock_wander_us"][1] == pytest.approx(latency / 1e3)
    # a copy's start, however late after its call, reads no wander
    late = ops[:500] + [("Memcpy HtoD", ops[499][2] + 50_000, ops[499][2] + 60_000, 777)] \
        + ops[500:]
    calls[777] = calls[10]
    device_late, _ = pt.clocks(late, calls, dict(box))
    assert device_late(ops[501][1]) == device(ops[501][1])


def test_timeline_labels_own_time():
    line = pt.Timeline(SPANS)
    assert line.at(_ms(7.5)) == "train.forward"
    assert line.at(_ms(9)) == "cfm.draw"
    assert line.at(_ms(12)) == "train.forward"  # cfm.draw closed
    assert line.at(_ms(32)) == "train.read"
    assert line.at(_ms(43.5)) == "train.step"
    assert line.at(_ms(44)) == pt.OUTSIDE
    assert line.at(_ms(100)) == "train.step"
    assert pt.Timeline([]).at(5) == pt.OUTSIDE


def test_phase_ms_over_whole_steps():
    out = pt.phase_ms(SPANS)
    assert out["steps"] == 3
    assert out["train.update"] == pytest.approx((5 + 8) / 3)
    assert out["loader.wait"] == pytest.approx(1 / 3)  # the wait before the first step is out
    assert pt.phase_ms(SPANS, skip=1)["train.update"] == pytest.approx(8 / 2)
    assert pt.phase_ms(SPANS, skip=3) == {}


def test_a_program_span_nests_inside_the_benchmark_span_around_the_same_call():
    """The loader's own wait and the benchmark's ``data wait`` around the same ``next``
    are stamped on one clock: the program's lies inside the benchmark's."""
    from oron_tts_tpu_torch.data.dataset import FixedBatchSampler, TTSCollator, TTSDataset
    from oron_tts_tpu_torch.data.loader import DataLoader
    from oron_tts_tpu_torch.utils import trace

    sr = 24000
    arrays = [(0.3 * np.sin(2 * np.pi * 220 * np.arange(sr + 4000 * i) / sr)).astype(np.float32)
              for i in range(4)]
    ds = TTSDataset(audio_arrays=arrays, texts=["сайн байна уу"] * 4, sample_rate=sr)
    probe = record.Probe()
    for workers in (0, 2):
        feed = iter(DataLoader(ds, FixedBatchSampler(4, 2, shuffle=False), TTSCollator(),
                               num_workers=workers))
        trace.start()
        try:
            for _ in range(2):
                w0 = record.now_ns()
                next(feed)
                probe.span("data wait", w0, record.now_ns())
        finally:
            spans = trace.stop()["spans"]
        outer = probe.spans[-2:]
        assert [sp["name"] for sp in spans] == ["loader.wait"] * 2
        for inner, around in zip(spans, outer):
            assert around["t0"] <= inner["t0"] <= inner["t1"] <= around["t1"]


TOL_NS = 50_000  # the launch latency the clock shift holds, and more


@pytest.mark.card
def test_a_traced_steps_kernels_were_launched_inside_its_span(card):
    """A short traced run of four Base blocks: the ops the device ran between one step's
    closing marker and the next step's were launched inside that next step's span, the
    update's after its opening marker, and nearly every op's launch was found."""
    import json

    from portbench import traffic as tr
    from portbench import training
    from portbench.tests.tiny import ROOT

    cfg = json.loads((ROOT / "portbench" / "configs" / "oron-base.json").read_text())
    cfg["model"]["depth"] = 4
    mix = tr.load_mix(ROOT, "runpod_frames")
    mix["corpus"]["clips"] = 120
    with pt.program_traced({}) as state:
        training.run({"name": "base.train.48k"}, cfg, mix, 2**31 + 21, 12.0, True, "cuda",
                     time.perf_counter(), ROOT)
    rec, ops = state["trace"], state["ops"]
    t0, t1 = min(s for _, s, _, _ in ops), max(e for _, _, e, _ in ops)
    mine = [op for op in ops if not record.is_marker(op[0]) and t0 <= op[1] < t1]
    assert rec["launches_matched"] >= 0.98 * len(mine), (rec["launches_matched"], len(mine))
    early = [at - s for _, s, _, at in mine if at is not None and s < at - TOL_NS]
    assert len(early) <= 0.001 * len(mine), (len(early), max(early))
    spans = rec["program_spans"]
    steps = sorted((sp for sp in spans if sp["name"] == "train.step"), key=lambda sp: sp["t0"])
    assert len(steps) >= 3
    step = steps[1]  # its predecessor's closing marker is in the trace
    kids = {sp["name"]: sp for sp in spans if sp["parent"] == step["id"]}
    ordered = sorted(ops, key=lambda op: op[1])
    closing = [k for k, op in enumerate(ordered)
               if record.is_marker(op[0]) and op[2] - op[1] >= record.LONG_NS]
    opening = [k for k, op in enumerate(ordered)
               if record.is_marker(op[0]) and op[2] - op[1] < record.LONG_NS]
    # the markers of this step: the first closing one launched inside it
    mark_close = next(k for k in closing if ordered[k][3] is not None
                      and step["t0"] <= ordered[k][3] <= step["t1"] + TOL_NS)
    mark_open = max(k for k in opening if k < mark_close)
    prev_close = max(k for k in closing if k < mark_open)
    assert kids["train.update"]["t1"] - TOL_NS <= ordered[mark_close][3]
    assert kids["train.grads"]["t1"] - TOL_NS <= ordered[mark_open][3] \
        <= kids["train.read"]["t0"] + TOL_NS
    before, update = ordered[prev_close + 1: mark_open], ordered[mark_open + 1: mark_close]
    assert before and update
    for name, s, e, at in before:
        assert at is not None and step["t0"] - TOL_NS <= at <= kids["train.grads"]["t1"] + TOL_NS
    for name, s, e, at in update:
        assert at is not None and kids["train.read"]["t0"] - TOL_NS <= at \
            <= kids["train.update"]["t1"] + TOL_NS
