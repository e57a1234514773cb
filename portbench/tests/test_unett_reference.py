"""E2 TTS's plain reference (``portbench/reference/unett.py``) and its cell on the CPU.

- the benchmark's copy against the repository's test copy, ``tests/plain_unett.py``
  (loaded by its path): the same velocity and loss on the same weights;
- ``e2-base`` resolves to ``reference/unett.py``, which meets the contract;
- ``train_step_flops`` and ``solve_flops`` against a count by hand at a small size;
- ``dit_state`` draws every key of the program's UNetT;
- the program's UNetT against this reference at a tiny width, and the cell's
  training check end to end with a fault it must refuse, under the cell's limits.
"""

from __future__ import annotations

import importlib.util
import json
import math
import time

import pytest
import torch

from portbench import check, training
from portbench import run as prun
from portbench.reference import CONTRACT, architecture, unett
from portbench.reference import train as RTrain
from portbench.tests import tiny
from portbench.weights import dit_state

ROOT = tiny.ROOT
CELL = "e2.train.38k"
SEED = 2**31 + 2020


def e2_config(**model) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / "e2-base.json").read_text())
    cfg["model"].update(dim=64, depth=4, heads=4, ff_mult=2, **model)
    return cfg


def plain():
    """``tests/plain_unett.py``, by its path (the benchmark imports nothing of tests/)."""
    path = ROOT / "tests" / "plain_unett.py"
    spec = importlib.util.spec_from_file_location("plain_unett_by_path", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import build_backbone

    with torch.device("meta"):
        backbone = build_backbone(F5Config.from_dict(cfg).model, cfg["n_mels"], False)
    return {k: tuple(v.shape) for k, v in backbone.state_dict().items()}


@pytest.fixture(scope="module")
def drawn():
    cfg = e2_config()
    state = dit_state(program_shapes(cfg), SEED, "cpu", torch.float32, unett)
    return cfg, state


def test_e2_base_resolves_to_the_unett_reference():
    _, cell, cfg = prun.load_spec(ROOT, CELL)
    assert cell["config"] == "e2-base" and cfg["model"]["backbone"] == "UNetT"
    assert architecture(cfg) is unett
    assert all(callable(getattr(unett, f)) for f in CONTRACT)
    assert unett.dropout_pairs(cfg) == 24


def test_the_draw_covers_every_unett_key(drawn):
    cfg, state = drawn
    shapes = program_shapes(cfg)
    assert list(state) == list(shapes)
    assert all(tuple(state[k].shape) == s for k, s in shapes.items())
    assert abs(float(state["norm_out.weight"].mean()) - 1.0) < 0.01
    assert abs(float(state["block3.ff_norm.weight"].mean()) - 1.0) < 0.01
    w = state["block2.skip_proj.weight"]  # [dim, 2·dim]: N(0, 1/(2·dim))
    assert abs(float(w.std()) * math.sqrt(w.shape[1]) - 1.0) < 0.05
    assert unett.weight_rule("block0.attn.to_q.weight", (64, 64)) is None


def test_the_benchmark_copy_equals_the_test_copy(drawn):
    cfg, state = drawn
    R2 = plain()
    P = unett.params(state, cfg, "cpu")
    g = torch.Generator().manual_seed(4)
    B, T = 3, 80
    x, cond = torch.randn(B, T, 100, generator=g), torch.randn(B, T, 100, generator=g)
    ids = torch.randint(-1, 64, (B, T), generator=g)
    t = torch.rand(B, generator=g)
    mask = torch.arange(T)[None] < torch.tensor([80, 51, 7])[:, None]
    for drop_audio, drop_text in ((False, False), (True, False), (True, True)):
        with torch.no_grad():
            a = unett.velocity(P, x, cond, ids, t, mask, drop_audio, drop_text)
            b = R2.velocity(state, x, cond, ids, t, mask, 4, 1, drop_audio, drop_text)
        assert float((a - b)[mask].abs().max()) <= 1e-6 * float(b[mask].abs().max())

    # the loss, with the benchmark's dropout masks handed to the test copy
    m = cfg["model"]
    mel = torch.randn(4, 100, 64, generator=g) - 4
    tid = torch.randint(0, 64, (4, 64), generator=g)
    lens = torch.tensor([64, 40, 17, 0], dtype=torch.int32)
    d = RTrain.draws(torch.Generator().manual_seed(8), 4, 64, 100, 4, (0.3, 0.2))
    loss, _ = RTrain.loss_and_grads(P, mel, tid, lens, d, (0.7, 1.0), m["p_dropout"], 4,
                                    velocity=unett.velocity)
    rate = m["p_dropout"]

    def dropout(i):
        def drop(kind, x):
            seed = d["seeds"][i][0 if kind == "attn" else 1]
            keep = RTrain.keep_mask(tuple(x.shape), seed, rate, 0, x.device)
            return x * keep.float() * (1.0 / (1.0 - rate))
        return drop

    want = R2.cfm_loss(state, mel, tid, lens, d, 4, 1, dropout=dropout)
    assert loss == pytest.approx(float(want), rel=1e-6)


def test_flops_equal_a_count_by_hand():
    cfg = e2_config()
    d, depth, ff, mel = 64, 4, 2, 100
    blocks = depth * (8 * d * d + 4 * ff * d * d) + depth // 2 * 4 * d * d
    frame = 2 * 300 * d + 2 * 2 * d * 4 * 31 + 2 * d * mel
    time_mlp = 2 * 256 * d + 2 * d * d

    def fwd(n):
        return (n + 1) * blocks + n * frame + 4 * (n + 1) ** 2 * d * depth

    assert unett.train_step_flops(cfg, [50, 0, 7]) == 3 * (fwd(50) + fwd(7) + 2 * time_mlp)
    assert unett.solve_flops(cfg, [50], 8, guided=True) == 2 * 8 * fwd(50) + 8 * time_mlp
    assert unett.solve_flops(cfg, [50, 9], 4, guided=False) == (
        4 * (fwd(50) + fwd(9)) + 4 * time_mlp)
    # E2TTS_Base: 624·d² FLOPs a token in the products, 18% over the DiT Base's 528·d²
    base = json.loads((ROOT / "portbench" / "configs" / "e2-base.json").read_text())
    assert unett.token_flops(unett.model_dims(base)) == 624 * 1024 * 1024


def test_the_program_matches_the_reference(drawn):
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS

    cfg, state = drawn
    model = F5TTS.from_config(F5Config.from_dict(cfg), device="cpu", dtype=torch.float32)
    model.backbone.load_state_dict(state)
    P = unett.params(state, cfg, "cpu")
    g = torch.Generator().manual_seed(5)
    B, T = 8, 128
    mel = torch.randn(B, 100, T, generator=g) - 4
    ids = torch.randint(0, 64, (B, T), generator=g)
    lens = torch.tensor([128, 100, 90, 64, 50, 128, 0, 0], dtype=torch.int32)
    for p in model.backbone.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss = model.cfm.loss(mel, ids, lens, torch.Generator().manual_seed(3), train=True)
    loss.backward()
    m = cfg["model"]
    d = RTrain.draws(torch.Generator().manual_seed(3), B, T, 100, unett.dropout_pairs(cfg),
                     (m["audio_drop_prob"], m["cond_drop_prob"]))
    want, grads = RTrain.loss_and_grads(P, mel, ids, lens, d, (0.7, 1.0), m["p_dropout"], 3,
                                         velocity=unett.velocity)
    assert loss.item() == pytest.approx(want, rel=1e-5)
    for (name, p), gr in zip(model.backbone.named_parameters(), grads):
        assert (p.grad - gr).norm() <= 1e-4 * gr.norm() + 1e-9, name


def train(fault: str | None = None) -> dict:
    cfg = e2_config()
    cfg.update(frames_threshold=2000, max_samples=8, num_workers=2)
    return training.run({"name": CELL}, cfg, tiny.mix("runpod_frames"), SEED, 2.0, False, "cpu",
                        time.perf_counter(), ROOT, fault=fault)


def test_the_e2_training_cell_runs_and_is_correct():
    out = train()
    ok, compared = prun.verdict(out, check.load_limits(ROOT, CELL))
    assert ok, compared
    assert out["train_frames_per_s"] > 0 and out["attempted"] > 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert set(prun.end_to_end(bench, cell, out)) == {"train_frames_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_an_e2_training_fault_is_not_correct(fault):
    ok, compared = prun.verdict(train(fault), check.load_limits(ROOT, CELL))
    assert not ok, compared
