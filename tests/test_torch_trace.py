"""PyTorch port: the in-process tracer (``utils/trace.py``) on the training path.

- off, nothing is recorded and a span is one shared no-op;
- one ``train_step`` yields exactly the training path's spans, nested by
  ``parent``, each child inside its parent, all of them carrying the step;
- under gradient accumulation the micro-batch spans carry the window's step;
- a traced and an untraced run are bit-equal (loss, gradient norm, masters,
  moments, EMA);
- the collator's counters and the loader's waits match what was collated and
  consumed, with and without worker threads;
- counters and span stacks stay right under many threads.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from oron_tts_tpu_torch.data.dataset import FixedBatchSampler, TTSCollator
from oron_tts_tpu_torch.data.loader import DataLoader
from oron_tts_tpu_torch.utils import trace

from test_torch_trainer import TINY_CFG, _synthetic_dataset, _trainer, tiny_trainer_params

STEP_SPANS = {
    "train.step": None, "train.h2d": "train.step", "train.forward": "train.step",
    "cfm.draw": "train.forward", "train.backward": "train.step", "train.grads": "train.step",
    "train.read": "train.step", "train.update": "train.step",
}
DROPOUT_CFG = dict(TINY_CFG, model=dict(TINY_CFG["model"], p_dropout=0.1))


@pytest.fixture(autouse=True)
def tracer_off():
    trace.stop()
    yield
    trace.stop()


def _batch(trainer):
    return next(iter(trainer.train_loader))


def test_off_records_nothing(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.set_params(tiny_trainer_params())
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b", step=3, rows=1)
    with trace.span("a") as sp:
        assert sp is None
    trainer.train_step(_batch(trainer), torch.Generator().manual_seed(0))
    trace.count("collate.frames_kept", 5)
    assert trace._spans == [] and trace._counters == {}
    assert trace.stop() == {"spans": [], "counters": {}}


def test_one_step_yields_the_training_spans_nested(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.set_params(tiny_trainer_params())
    batch = _batch(trainer)
    step0 = trainer.state.step
    trace.start()
    metrics = trainer.train_step(batch, torch.Generator().manual_seed(0))
    spans = trace.stop()["spans"]
    assert metrics["ok"] and trainer.state.step == step0 + 1
    by_name = {sp["name"]: sp for sp in spans}
    assert sorted(sp["name"] for sp in spans) == sorted(STEP_SPANS)
    by_id = {sp["id"]: sp for sp in spans}
    for name, parent in STEP_SPANS.items():
        sp = by_name[name]
        assert sp["step"] == step0
        assert sp["t0"] <= sp["t1"]
        if parent is None:
            assert sp["parent"] is None
            continue
        up = by_id[sp["parent"]]
        assert up["name"] == parent
        assert up["t0"] <= sp["t0"] and sp["t1"] <= up["t1"]
    # the children run in the step's order
    order = ["train.h2d", "train.forward", "train.backward", "train.grads", "train.read",
             "train.update"]
    for a, b in zip(order, order[1:]):
        assert by_name[a]["t1"] <= by_name[b]["t0"]
    root = by_name["train.step"]
    lengths = np.asarray(batch["mel_lengths"])
    assert root["rows"] == batch["mel"].shape[0] == lengths.size
    assert root["frames_kept"] == int(lengths.sum())
    assert root["frames_collated"] == batch["mel"].shape[0] * batch["mel"].shape[2]


def test_accumulation_spans_carry_the_window_step(tmp_path):
    trainer = _trainer(tmp_path, cfg=dict(TINY_CFG, grad_accumulation_steps=2), n=4, batch=2)
    trainer.set_params(tiny_trainer_params())
    batches = list(trainer.train_loader)
    gen = torch.Generator().manual_seed(0)
    trace.start()
    acc = trainer._zero_accum()
    for b in batches:
        trainer._accum_step(acc, b, gen)
    assert trainer._apply_accum(acc)["ok"]
    spans = trace.stop()["spans"]
    names = [sp["name"] for sp in spans]
    assert "train.step" not in names
    assert names.count("train.forward") == names.count("cfm.draw") == 2
    assert names.count("train.read") == names.count("train.update") == 1
    assert {sp["step"] for sp in spans} == {0}
    roots = {sp["name"] for sp in spans if sp["parent"] is None}
    assert roots == {"train.h2d", "train.forward", "train.backward", "train.grads",
                     "train.read", "train.update"}


def _two_steps(tmp_path, tag, traced):
    trainer = _trainer(tmp_path, cfg=DROPOUT_CFG, tag=tag)
    trainer.set_params(tiny_trainer_params())
    batches = list(trainer.train_loader)[:2]
    gen = torch.Generator().manual_seed(11)
    if traced:
        trace.start()
    metrics = [trainer.train_step(b, gen) for b in batches]
    if traced:
        assert len(trace.stop()["spans"]) == 2 * len(STEP_SPANS)
    return metrics, trainer.state


def test_traced_and_untraced_steps_are_bit_equal(tmp_path):
    m_off, s_off = _two_steps(tmp_path, "off", traced=False)
    m_on, s_on = _two_steps(tmp_path, "on", traced=True)
    assert m_off == m_on  # loss, gradient norm and ok, as the host read them
    assert all(m["ok"] for m in m_on) and s_on.step == s_off.step == 2
    for tree in ("params", "mu", "nu", "ema"):
        for a, b in zip(getattr(s_off, tree), getattr(s_on, tree)):
            assert torch.equal(a, b), tree


@pytest.mark.parametrize("workers", [0, 3])
def test_collator_counters_and_loader_waits(workers):
    ds = _synthetic_dataset(7)
    loader = DataLoader(ds, FixedBatchSampler(len(ds), 3, shuffle=False, drop_last=False),
                        TTSCollator(pad_to_multiple=64), num_workers=workers)
    trace.start()
    batches = list(loader)
    out = trace.stop()
    assert len(batches) == 3
    assert out["counters"] == {
        "collate.frames_kept": sum(int(b["mel_lengths"].sum()) for b in batches),
        "collate.frames_collated": sum(b["mel"].shape[0] * b["mel"].shape[2] for b in batches),
    }
    waits = [sp for sp in out["spans"] if sp["name"] == "loader.wait"]
    assert len(waits) == len(batches) == len(out["spans"])
    assert all(sp["parent"] is None and sp["step"] is None for sp in waits)


def test_counters_and_span_stacks_under_many_threads():
    n_threads, per = 24, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        trace.start()
        wrong = []

        def work():
            for _ in range(per):
                with trace.span("outer") as outer:
                    trace.count("n", 1)
                    with trace.span("inner") as inner:
                        if inner["parent"] != outer["id"]:
                            wrong.append(inner)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        out = trace.stop()
    finally:
        sys.setswitchinterval(old)
    assert not wrong
    assert out["counters"] == {"n": n_threads * per}
    assert len(out["spans"]) == 2 * n_threads * per
    assert len({sp["id"] for sp in out["spans"]}) == len(out["spans"])
    assert sum(sp["parent"] is None for sp in out["spans"]) == n_threads * per
