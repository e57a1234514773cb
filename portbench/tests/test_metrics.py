"""Each per-layer reader on a recorded trace, and the trace reductions they rest on."""

from __future__ import annotations

import importlib.util
import json

import pytest

from portbench import flops, record
from portbench.reference import architecture
from portbench.tests.tiny import ROOT

MS = 1_000_000  # ns


def reader(name: str):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


TRAIN = {
    "busy_s": 8.0, "window_s": 10.0, "seconds": 40.0,
    "kernels": {"bwd_dq_wgmma<64>": [0.3, 10], "bwd_dkdv_wgmma<64>": [0.7, 10]},
    "idle_gaps": {}, "data_wait_s": [0.001, 0.003], "steps": 2, "train_flops": 7.912e15,
    "kept_frames": 900, "padded_frames": 1200, "update_device_s": 0.3, "updates_traced": 3,
    "attn_bwd_bound_s": 0.25,
}

CASES = [
    ("data_wait_ms.train", TRAIN, 2.0), ("pad_share.train", TRAIN, 25.0),
    ("optimizer_ms.train", TRAIN, 100.0), ("attn_bwd_roofline.train", TRAIN, 25.0),
    ("dit_mfu.train", TRAIN, 20.0), ("device_idle_share.train", TRAIN, 20.0),
]

CASE_FILES = ROOT / "portbench" / "tests" / "metric_cases"


def recorded_cases(folder=CASE_FILES) -> list[tuple[str, dict, float]]:
    """``CASES``, and the case of each reader added later as a file of its own,
    ``<folder>/<metric>.json`` holding ``{"trace": {...}, "want": <reading>}``, so that
    a new per-layer metric comes in as new files only."""
    found = []
    for path in sorted(folder.glob("*.json")):
        case = json.loads(path.read_text())
        found.append((path.stem, case["trace"], case["want"]))
    return CASES + found


ALL = recorded_cases()


@pytest.mark.parametrize("name,trace,want", ALL, ids=[c[0] for c in ALL])
def test_reader_on_a_recorded_trace(name, trace, want):
    assert reader(name)(trace) == pytest.approx(want)


@pytest.mark.parametrize("name", [c[0] for c in ALL])
def test_reader_that_finds_nothing_returns_none(name):
    assert reader(name)({"seconds": 40.0, "kernels": {}}) is None


def test_a_case_file_adds_a_case(tmp_path):
    (tmp_path / "dit_mfu.e2.json").write_text(json.dumps({"trace": TRAIN, "want": 20.0}))
    assert recorded_cases(tmp_path) == CASES + [("dit_mfu.e2", TRAIN, 20.0)]


def test_every_per_layer_metric_has_a_reader_and_a_tested_case():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["per_layer"]}
    assert names == {c[0] for c in ALL}
    readers = {p.name[:-3] for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    assert readers == names  # a reader for every metric, and none without one


def test_device_summary_and_idle_gaps():
    events = [("a", 0, 2 * MS), ("b", 1 * MS, 3 * MS), ("a", 5 * MS, 6 * MS),
              ("c", 6 * MS + 5_000, 8 * MS), ("d", 11 * MS, 12 * MS)]
    dev = record.device_summary(events, 0, 10 * MS)
    assert dev["busy_s"] == pytest.approx((3 + 1 + 2 - 0.005) / 1e3)
    assert dev["by_name"]["a"] == [pytest.approx(0.003), 2]
    assert "d" not in dev["by_name"]
    spans = [{"name": "request", "t0": 0, "t1": 10 * MS}, {"name": "vocoder", "t0": 3 * MS,
                                                            "t1": 4 * MS + 500_000}]
    gaps = record.idle_gaps(dev["busy"], 0, 10 * MS, spans)
    assert gaps["vocoder"] == pytest.approx(0.002)
    assert gaps["request"] == pytest.approx(0.002)
    assert gaps["between launches"] == pytest.approx(5e-6)


def test_between_edges_counts_the_kernels_in_stream_order_between_markers():
    short, long = 1_000, 20_000  # ns
    events = [("spin_kernel", 0, long),  # the clock marker
              ("bwd", 1 * MS, 4 * MS),  # queued before the update's opening marker
              ("spin_kernel", 4 * MS, 4 * MS + short), ("norm", 5 * MS, 6 * MS),
              ("adam", 6 * MS, 8 * MS), ("spin_kernel", 8 * MS, 8 * MS + long),
              ("fwd", 9 * MS, 10 * MS),
              ("spin_kernel", 11 * MS, 11 * MS + short), ("adam", 12 * MS, 13 * MS),
              ("spin_kernel", 14 * MS, 14 * MS + long),
              ("spin_kernel", 15 * MS, 15 * MS + short), ("fwd", 16 * MS, 17 * MS)]  # cut
    total, pairs = record.between_edges(events)
    assert pairs == 2 and total == pytest.approx(4e-3)
    assert record.between_edges(events[:2]) == (0.0, 0)
    # without the clock marker the pairs are the same
    assert record.between_edges(events[1:]) == (pytest.approx(4e-3), 2)


def test_percentile_is_nearest_rank_and_counts_failures():
    assert record.pct(list(range(1, 101)), 0.9) == 90
    assert record.pct([1.0] * 9 + [float("inf")], 0.9) == 1.0
    assert record.pct([1.0] * 8 + [float("inf")] * 2, 0.9) == float("inf")


def test_bounds_by_operations_and_by_bytes():
    # lanes forward at the kernel table's row-1 shapes: 0.00547 ms by operations
    t = flops.attn_fwd_bound_s(2, 832, 16, 64, 832 + 755)
    assert t * 1e3 == pytest.approx(0.00547, rel=0.01)
    # the training backward's bound is 2.5x the forward's FLOPs
    assert flops.attn_bwd_bound_s(12, 2048, 16, 64, 12 * 2048) == pytest.approx(
        10.0 * 2048 * 16 * 64 * 12 * 2048 / flops.BF16_FLOPS)
    # the mel is bound by f32 operations at 10 s of audio (row 3: 0.000424 ms)
    assert flops.mel_bound_s(1, 240000) * 1e3 == pytest.approx(0.000424, rel=0.02)


def test_model_flops_count_cfg_rows_and_steps():
    cfg = json.loads((ROOT / "portbench" / "configs" / "oron-base.json").read_text())
    arch = architecture(cfg)  # the configuration's own count
    m = arch.model_dims(cfg)
    assert m == {"dim": 1024, "depth": 22, "heads": 16, "ff_mult": 4, "text_dim": 512,
                 "conv_layers": 4, "mel_dim": 100}
    one = arch.dit_row_flops(m, 500)
    solve = arch.solve_flops(cfg, [500], 32, guided=True)
    assert solve > 64 * one and solve < 64.1 * one
    assert arch.solve_flops(cfg, [500], 32, guided=False) < solve / 1.9
    assert arch.train_step_flops(cfg, [500, 0]) == pytest.approx(3 * (
        one + arch.text_embed_flops(m, 500) + 22 * 2 * 1024 * 6 * 1024 + 2 * 1024 * 2 * 1024))
