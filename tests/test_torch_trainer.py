"""PyTorch port, the trainer against the JAX package's, on ``device="cpu"``.

- the guarded AdamW + EMA step against ``_guarded_update`` over
  ``make_optimizer`` (optax) for both first-moment types, five steps and a
  non-finite one;
- ``make_lr_schedule`` against optax's joined schedules;
- mirrors of ``tests/test_trainer.py`` (end to end and resume, gradient
  accumulation, partial flush, poisoned window, non-finite batch, SIGTERM
  checkpoint, rotation, best file between intervals) on the port;
- checkpoints crossing between the packages in both directions;
- ``to_flax_params`` as the inverse of ``from_flax_params``;
- a short run in which the eval loss falls.
"""

import json
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oron_tts_tpu.train import checkpoint as jckpt
from oron_tts_tpu.train import trainer as jtrainer
from oron_tts_tpu_torch.config import F5Config
from oron_tts_tpu_torch.data.dataset import (
    DynamicBatchSampler,
    FixedBatchSampler,
    TTSCollator,
    TTSDataset,
)
from oron_tts_tpu_torch.data.loader import DataLoader
from oron_tts_tpu_torch.models.f5tts import F5TTS
from oron_tts_tpu_torch.train.checkpoint import CheckpointManager, load_pytree_npz
from oron_tts_tpu_torch.train.trainer import (
    F5Trainer,
    TrainingPreempted,
    TrainState,
    guarded_update,
    make_lr_schedule,
)
from oron_tts_tpu_torch.utils.weights import from_flax_params, seeded_dit_params, to_flax_params

from test_torch_models import tiny_params

REPO = Path(__file__).resolve().parent.parent

TINY_CFG = {
    "sample_rate": 24000, "n_fft": 1024, "hop_length": 256, "n_mels": 100,
    "learning_rate": 1e-3, "warmup_steps": 2, "num_epochs": 2,
    "ema_decay": 0.999, "max_grad_norm": 1.0, "grad_accumulation_steps": 1,
    "use_tqdm": False, "log_interval": 1, "save_interval": 1,
    "max_checkpoints": 2, "audio_sample_interval": 1000,
    "model": {
        "vocab_size": 65, "dim": 64, "depth": 2, "heads": 2, "ff_mult": 2,
        "text_dim": 32, "conv_layers": 2, "p_dropout": 0.0,
    },
}


def tiny_trainer_params():
    """TINY_CFG's DiT with every tensor non-zero (the fresh scheme zeroes the AdaLN
    projections and proj_out, and with them most gradients)."""
    from oron_tts_tpu_torch.config import ModelConfig

    m = TINY_CFG["model"]
    return seeded_dit_params(ModelConfig(
        vocab_size=m["vocab_size"], dim=m["dim"], depth=m["depth"], heads=m["heads"],
        ff_mult=m["ff_mult"], text_dim=m["text_dim"], conv_layers=m["conv_layers"]), seed=4)


def _synthetic_dataset(n=6, sr=24000):
    arrays, texts = [], []
    for i in range(n):
        t = np.arange(int(sr * (1.0 + 0.3 * i))) / sr
        arrays.append((0.4 * np.sin(2 * np.pi * (200 + 20 * i) * t)).astype(np.float32))
        texts.append("сайн байна уу тавтай морилно уу")
    ds = TTSDataset(audio_arrays=arrays, texts=texts, sample_rate=sr)
    ds.durations = [len(a) / sr for a in arrays]
    return ds


def _trainer(tmp_path, cfg=TINY_CFG, n=6, batch=3, val=False, tag="", drop_last=True,
             loader=None):
    ds = _synthetic_dataset(n)
    collator = TTSCollator(pad_to_multiple=64)
    if loader is None:
        loader = DataLoader(ds, FixedBatchSampler(len(ds), batch, seed=1, drop_last=drop_last),
                            collator, num_workers=0)
    val_loader = DataLoader(ds, FixedBatchSampler(len(ds), batch, shuffle=False, drop_last=False),
                            collator, num_workers=0) if val else None
    model = F5TTS.from_config(F5Config.from_dict(cfg), device="cpu")
    return F5Trainer(config=cfg, model=model, train_loader=loader, val_loader=val_loader,
                     log_dir=str(tmp_path / f"logs{tag}"), checkpoint_dir=str(tmp_path / "ckpt"))


# ── the optimizer step against optax ────────────────────────────────────


def _small_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": {"kernel": rng.standard_normal((8, 16)).astype(np.float32),
              "bias": rng.standard_normal(16).astype(np.float32)},
        "conv": {"kernel": rng.standard_normal((3, 4, 8)).astype(np.float32)},
        "norm": {"scale": rng.standard_normal(8).astype(np.float32)},
    }


def _close_f32(a, b, what):
    """1e-6 of the value plus 1e-6 of the tensor's largest (sums may cancel)."""
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * float(np.abs(b).max()), err_msg=what)


def _bf16_ulp(x):
    return np.maximum(np.abs(x), 2.0 ** -126) * 2.0 ** -7


@pytest.mark.parametrize("mu_dtype", ["bfloat16", "float32"])
def test_guarded_update_matches_optax(mu_dtype):
    params = _small_tree(0)
    # gradient norms on both sides of the clip threshold
    grad_seq = [jax.tree_util.tree_map(lambda g, s=s: (g * s).astype(np.float32), _small_tree(10 + i))
                for i, s in enumerate((0.5, 0.01, 0.2, 0.03, 1.0))]
    schedule = jtrainer.make_lr_schedule(1e-2, warmup_steps=2, total_steps=10)
    tx = jtrainer.make_optimizer(
        schedule, max_grad_norm=1.0, mu_dtype=jnp.bfloat16 if mu_dtype == "bfloat16" else None)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtrainer.TrainState(
        params=jp, opt_state=tx.init(jp), ema_params=jax.tree_util.tree_map(jnp.array, jp),
        step=jnp.asarray(0, jnp.int32), ema_updates=jnp.asarray(0, jnp.int32))

    flat = from_flax_params(params)
    names = list(flat)
    state = TrainState(names, [flat[n].clone() for n in names],
                       torch.bfloat16 if mu_dtype == "bfloat16" else torch.float32)
    port_schedule = make_lr_schedule(1e-2, warmup_steps=2, total_steps=10)

    def port_tree(tensors):
        return to_flax_params(dict(zip(names, tensors)))

    def check(jstate):
        adam = jstate.opt_state[1][0]
        for got, ref, what in (
            (port_tree(state.params), jstate.params, "params"),
            (port_tree(state.ema), jstate.ema_params, "ema"),
            (port_tree(state.nu), adam.nu, "nu"),
        ):
            for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
                _close_f32(a, np.asarray(b), what)
        for a, b in zip(jax.tree_util.tree_leaves(port_tree(state.mu)),
                        jax.tree_util.tree_leaves(adam.mu)):
            b = np.asarray(b.astype(jnp.float32))
            if mu_dtype == "bfloat16":
                assert (np.abs(a - b) <= _bf16_ulp(b)).all()
            else:
                _close_f32(a, b, "mu")
        assert state.step == int(jstate.step) and state.ema_updates == int(jstate.ema_updates)
        assert state.count == int(adam.count)

    for i, grads in enumerate(grad_seq):
        jstate, j_norm, j_ok = jtrainer._guarded_update(
            jstate, jax.tree_util.tree_map(jnp.asarray, grads), tx, 0.999)
        g = from_flax_params(grads)
        norm, ok = guarded_update(state, [g[n].clone() for n in names], port_schedule, 0.999,
                                  max_grad_norm=1.0)
        assert ok and bool(j_ok)
        np.testing.assert_allclose(norm, float(j_norm), rtol=1e-6)
        check(jstate)
    assert state.step == 5

    # a non-finite gradient, and a finite one under a non-finite loss: all frozen
    frozen = [[t.clone() for t in lst] for lst in (state.params, state.mu, state.nu, state.ema)]
    bad = from_flax_params(grad_seq[0])
    bad["a.weight"][0, 0] = float("nan")
    for grads, extra_ok in (([bad[n].clone() for n in names], True),
                            ([g[n].clone() for n in names], False)):
        norm, ok = guarded_update(state, grads, port_schedule, 0.999, extra_ok=extra_ok)
        assert not ok
    jbad = jax.tree_util.tree_map(jnp.asarray, grad_seq[0])
    jbad["a"]["kernel"] = jbad["a"]["kernel"].at[0, 0].set(jnp.nan)
    jstate, _, j_ok = jtrainer._guarded_update(jstate, jbad, tx, 0.999)
    assert not bool(j_ok)
    for lst, ref in zip((state.params, state.mu, state.nu, state.ema), frozen):
        assert all(torch.equal(a, b) for a, b in zip(lst, ref))
    assert (state.step, state.ema_updates, state.count) == (5, 5, 5)
    check(jstate)


@pytest.mark.parametrize("lr,warmup,total", [(1e-4, 10, 100), (7.5e-5, 1000, 20000), (1e-3, 2, 4)])
def test_lr_schedule_matches_optax(lr, warmup, total):
    ref = jtrainer.make_lr_schedule(lr, warmup, total)
    got = make_lr_schedule(lr, warmup, total)
    for step in {0, 1, warmup // 2, warmup - 1, warmup, warmup + 1, (warmup + total) // 2,
                 total - 1, total, total + 5}:
        # optax evaluates in f32: (lr·1e-4 − lr)·frac + lr cancels to ~1e-7 of lr
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=2e-6, atol=1e-6 * lr,
                                   err_msg=str(step))
    assert got(0) == pytest.approx(lr * 1e-4, rel=1e-6)
    assert got(warmup) == pytest.approx(lr, rel=1e-6)
    assert got(total) == pytest.approx(1e-6, rel=1e-6)


# ── data ────────────────────────────────────────────────────────────────


def test_dataset_item_and_collator_match_jax():
    from oron_tts_tpu.data.dataset import TTSCollator as JCollator
    from oron_tts_tpu.data.dataset import TTSDataset as JDataset

    # noise, not the sines: a pure tone leaves most mel bins at the log floor,
    # where rounding noise decides between log(1e-5) and log(3e-5)
    rng = np.random.default_rng(1)
    arrays = [(0.3 * rng.standard_normal(24000 + 7000 * i)).astype(np.float32) for i in range(4)]
    ds = TTSDataset(audio_arrays=arrays, texts=["сайн байна уу тавтай морилно уу"] * 4)
    jds = JDataset(audio_arrays=arrays, texts=ds.texts, sample_rate=24000)
    item, jitem = ds[1], jds[1]
    assert item["mel"].shape == jitem["mel"].shape and item["mel"].shape[0] == 100
    np.testing.assert_allclose(item["mel"], jitem["mel"], atol=2e-4)
    np.testing.assert_array_equal(item["text_ids"], jitem["text_ids"])
    assert item["text_ids"][0] == 4  # the [LANG_MN] tag
    batch = TTSCollator(pad_to_multiple=64)([ds[0], ds[3]])
    jbatch = JCollator(pad_to_multiple=64)([jds[0], jds[3]])
    assert batch["mel"].shape == jbatch["mel"].shape and batch["mel"].shape[2] % 64 == 0
    for key in ("text_ids", "mask", "mel_lengths"):
        np.testing.assert_array_equal(batch[key], jbatch[key])
    T0 = batch["mel_lengths"][0]
    assert (batch["text_ids"][0, T0:] == -1).all() and not batch["mask"][0, T0:].any()


def test_samplers_match_jax():
    from oron_tts_tpu.data.dataset import DynamicBatchSampler as JDynamic
    from oron_tts_tpu.data.dataset import FixedBatchSampler as JFixed

    durations = [1.0, 2.0, 3.0, 1.5, 2.5, 0.5]
    s, js = DynamicBatchSampler(durations, 400), JDynamic(durations, 400)
    for epoch in (0, 1, 2):
        s.set_epoch(epoch)
        js.set_epoch(epoch)
        assert list(s) == list(js)
    assert sorted(i for b in s for i in b) == list(range(6))  # nothing dropped
    for kw in ({}, {"shuffle": False, "drop_last": False}):
        f, jf = FixedBatchSampler(7, 3, seed=2, **kw), JFixed(7, 3, seed=2, **kw)
        f.set_epoch(3)
        jf.set_epoch(3)
        assert list(f) == list(jf) and len(f) == len(jf)


def test_dataset_cache_is_bounded_in_bytes():
    ds = _synthetic_dataset()
    one_item = TTSDataset._item_nbytes(ds[0])
    small = TTSDataset(audio_arrays=ds.audio_arrays, texts=ds.texts, sample_rate=24000,
                       cache_bytes=int(one_item * 2.5))
    for i in range(len(small)):
        small[i]
    st = small.cache_stats()
    assert st["bytes"] <= st["budget_bytes"] and st["items"] < len(small)
    np.testing.assert_array_equal(small[5]["mel"], small[5]["mel"])


def test_loader_threads_skip_a_bad_sample_and_keep_order():
    ds = _synthetic_dataset()
    ds.audio_arrays[2] = np.full(30000, np.nan, np.float32)  # fails the finite check
    sampler = FixedBatchSampler(len(ds), 3, shuffle=False, drop_last=False)
    collator = TTSCollator(pad_to_multiple=64)
    serial = list(DataLoader(ds, sampler, collator, num_workers=0))
    threaded = list(DataLoader(ds, sampler, collator, num_workers=3))
    assert [b["mel"].shape[0] for b in serial] == [2, 3]
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a["mel"], b["mel"])


# ── the trainer, mirrored from tests/test_trainer.py ────────────────────


def test_trainer_end_to_end_and_resume(tmp_path):
    trainer = _trainer(tmp_path, val=True)
    loss1 = trainer.train_epoch(total_epochs=2)
    assert np.isfinite(loss1)
    val = trainer.validate()
    assert np.isfinite(val) and val > 0
    # validation lent the working set to the EMA and gave it back
    for w, p in zip(trainer.work, trainer.state.params):
        assert torch.equal(w.detach(), p)
    trainer.save_checkpoint(is_best=True, loss=loss1)
    assert (tmp_path / "ckpt" / "f5tts_best.npz").exists()
    assert trainer.global_step == 2  # 6 samples / batch 3

    trainer2 = _trainer(tmp_path, tag="2")
    trainer2.load_checkpoint()
    assert trainer2.global_step == 2 and trainer2.epoch == 1
    s1, s2 = trainer.state, trainer2.state
    for a, b in zip(s1.params + s1.ema + s1.nu + s1.mu, s2.params + s2.ema + s2.nu + s2.mu):
        assert torch.equal(a, b)
    assert s2.count == s1.count == 2 and s2.mu[0].dtype == torch.bfloat16
    assert np.isfinite(trainer2.train_epoch(total_epochs=2))


def test_grad_accumulation_equals_the_large_batch(tmp_path):
    """Two micro-batches of 2 under accumulation give the gradient and the loss
    of the one batch of 4. Each loss is a mean over its own span frames, so
    the halves are given equal lengths; the draws are pinned (the eval-mode
    span and time, a fixed x0 per row) so that the split is the only change."""
    sr = 24000
    arrays = [(0.4 * np.sin(2 * np.pi * f * np.arange(n) / sr)).astype(np.float32)
              for f, n in ((200, 30000), (260, 40000), (330, 30000), (410, 40000))]
    ds = TTSDataset(audio_arrays=arrays, texts=["сайн байна уу"] * 4, sample_rate=sr)
    big = TTSCollator(pad_to_multiple=64)([ds[i] for i in range(4)])
    halves = [{k: v[i:i + 2] for k, v in big.items()} for i in (0, 2)]
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, big["mel"].shape[2], 100)).astype(np.float32))

    def pin(trainer, rows):
        cfm = trainer.model.cfm
        trainer.model.cfm.loss = lambda mel, ids, lens, generator, train=True: type(cfm).loss(
            cfm, mel, ids, lens, train=False, x0=x0[rows])

    t_acc = _trainer(tmp_path, cfg=dict(TINY_CFG, grad_accumulation_steps=2), tag="a",
                     loader=halves)
    t_acc.set_params(tiny_trainer_params())
    acc = t_acc._zero_accum()
    for rows, half in zip((slice(0, 2), slice(2, 4)), halves):
        pin(t_acc, rows)
        t_acc._accum_step(acc, half, torch.Generator())
    m_acc = t_acc._apply_accum(acc)  # scales acc["grads"] to the mean in place

    t_big = _trainer(tmp_path, tag="b", loader=[big])
    t_big.set_params(tiny_trainer_params())
    pin(t_big, slice(0, 4))
    loss_big, grads_big = t_big._loss_and_grads(big, torch.Generator())
    assert m_acc["ok"] and t_acc.state.step == 1
    np.testing.assert_allclose(m_acc["loss"], float(loss_big), rtol=1e-5)
    top = max(float(g.abs().max()) for g in grads_big)
    assert top > 0
    for a, g in zip(acc["grads"], grads_big):
        np.testing.assert_allclose(a.numpy(), g.numpy(), atol=1e-5 * top)


def test_grad_accumulation_windows(tmp_path):
    cfg = dict(TINY_CFG, grad_accumulation_steps=2)
    trainer = _trainer(tmp_path, cfg=cfg, n=4, batch=2)
    assert np.isfinite(trainer.train_epoch(total_epochs=1))
    assert trainer.global_step == 1  # 2 batches / accum 2 → one update


def test_grad_accumulation_mean_of_microbatch_gradients(tmp_path):
    """The window's update uses the mean of its micro-batches' gradients."""
    cfg = dict(TINY_CFG, grad_accumulation_steps=2)
    trainer = _trainer(tmp_path, cfg=cfg, n=4, batch=2)
    batches = list(trainer.train_loader)
    grads = []
    for i, b in enumerate(batches):
        _, g = trainer._loss_and_grads(b, torch.Generator().manual_seed(i))
        grads.append(g)
    acc = trainer._zero_accum()
    for i, b in enumerate(batches):
        trainer._accum_step(acc, b, torch.Generator().manual_seed(i))
    assert int(acc["n_finite"]) == 2 and bool(acc["all_finite"])
    for a, g0, g1 in zip(acc["grads"], *grads):
        np.testing.assert_allclose(a.numpy(), (g0 + g1).numpy(), rtol=1e-6, atol=1e-7)
    before = [p.clone() for p in trainer.state.params]
    metrics = trainer._apply_accum(acc)
    assert metrics["ok"] and trainer.state.step == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, trainer.state.params))
    for a, g0, g1 in zip(acc["grads"], *grads):  # scaled in place to the mean
        np.testing.assert_allclose(a.numpy(), ((g0 + g1) / 2).numpy(), rtol=1e-5, atol=1e-7)


def test_grad_accumulation_partial_flush(tmp_path):
    cfg = dict(TINY_CFG, grad_accumulation_steps=2)
    trainer = _trainer(tmp_path, cfg=cfg, n=6, batch=2, drop_last=False)
    assert np.isfinite(trainer.train_epoch(total_epochs=1))
    assert trainer.global_step == 2  # a full window and a flushed partial one


def test_grad_accumulation_poisoned_window_skipped(tmp_path):
    cfg = dict(TINY_CFG, grad_accumulation_steps=2)
    ds = _synthetic_dataset(4)
    good = TTSCollator(pad_to_multiple=64)([ds[0], ds[1]])
    bad = {k: np.asarray(v).copy() for k, v in good.items()}
    bad["mel"][0, 0, 0] = np.inf
    trainer = _trainer(tmp_path, cfg=cfg, loader=[good] * 2)
    before = [p.clone() for p in trainer.state.params]
    acc = trainer._zero_accum()
    trainer._accum_step(acc, bad, torch.Generator().manual_seed(0))
    trainer._accum_step(acc, good, torch.Generator().manual_seed(0))
    assert not bool(acc["all_finite"]) and int(acc["n_finite"]) == 1
    metrics = trainer._apply_accum(acc)
    assert not metrics["ok"]
    assert all(torch.equal(a, b) for a, b in zip(before, trainer.state.params))
    assert trainer.state.step == 0 and trainer.state.count == 0
    # a clean window does move the parameters
    acc = trainer._zero_accum()
    trainer._accum_step(acc, good, torch.Generator().manual_seed(0))
    trainer._accum_step(acc, good, torch.Generator().manual_seed(1))
    assert trainer._apply_accum(acc)["ok"] and trainer.state.step == 1


def test_nonfinite_batch_skipped(tmp_path):
    ds = _synthetic_dataset(4)
    collator = TTSCollator(pad_to_multiple=64)

    class PoisonLoader:
        dataset = ds

        def __len__(self):
            return 2

        def __iter__(self):
            good = collator([ds[0], ds[1]])
            bad = {k: v.copy() for k, v in good.items()}
            bad["mel"][0, 0, 0] = np.nan
            yield bad
            yield good

    trainer = _trainer(tmp_path, loader=PoisonLoader())
    loss = trainer.train_epoch(total_epochs=1)
    assert trainer.global_step == 1 and np.isfinite(loss)


def test_best_checkpoint_written_between_save_intervals(tmp_path):
    trainer = _trainer(tmp_path, n=3, val=True)
    trainer.train(num_epochs=1, save_interval=5)
    ckpt = tmp_path / "ckpt"
    assert (ckpt / "f5tts_best.npz").exists() and not list(ckpt.glob("f5tts_step_*.npz"))
    trainer2 = _trainer(tmp_path, n=3, tag="2")
    trainer2.load_checkpoint(load_best=True)
    assert trainer2.epoch == 1 and np.isfinite(trainer2._best_val)

    opt_out = dict(TINY_CFG, save_best_between_intervals=False)
    trainer3 = _trainer(tmp_path / "other", cfg=opt_out, n=3, val=True)
    trainer3.train(num_epochs=1, save_interval=5)
    assert not (tmp_path / "other" / "ckpt" / "f5tts_best.npz").exists()


def test_sigterm_preemption_checkpoint(tmp_path):
    trainer = _trainer(tmp_path)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        trainer.install_signal_handlers()
        os.kill(os.getpid(), signal.SIGTERM)  # the real delivery path
        with pytest.raises(TrainingPreempted):
            trainer.train_epoch(total_epochs=2)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert list((tmp_path / "ckpt").glob("f5tts_step_*.npz")), "emergency checkpoint missing"
    trainer2 = _trainer(tmp_path, tag="2")
    trainer2.load_checkpoint()
    assert trainer2.global_step == trainer.global_step == 1


@pytest.mark.parametrize("async_writes", [False, True])
def test_checkpoint_rotation_and_names(tmp_path, async_writes):
    mgr = CheckpointManager(tmp_path, max_checkpoints=2, async_writes=async_writes)
    params = {"a": {"kernel": np.ones((2, 3), np.float32)}}
    for step in (1, 2, 3):
        mgr.save(step, params, ema_params=params, loss=0.5, config={"x": 1},
                 is_best=step == 2, extra_state={"epoch": step})
    mgr.wait()
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "f5tts_best.npz", "f5tts_step_00000002.npz", "f5tts_step_00000003.npz"]
    assert mgr.load_config() == {"x": 1}
    info = mgr.load()
    assert info["step"] == 3 and info["epoch"] == 3 and info["opt"] is None
    assert mgr.load(load_best=True)["step"] == 2
    assert CheckpointManager(tmp_path / "empty").load()["params"] is None


# ── checkpoints cross between the packages ──────────────────────────────


def _assert_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_port_checkpoint_is_read_by_the_jax_package(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.train_epoch(total_epochs=2)
    path = trainer.save_checkpoint(loss=1.0)
    trees, meta = jckpt.load_pytree_npz(path)
    assert meta["step"] == 2 and meta["epoch"] == 1
    _assert_trees_equal(trees["params"], trainer._flax_tree(trainer.state.params))
    _assert_trees_equal(trees["ema"], trainer._flax_tree(trainer.state.ema))
    # the JAX DiT accepts the tree as its parameters
    from oron_tts_tpu.config import F5Config as JF5Config
    from oron_tts_tpu.models.f5tts import F5TTS as JF5TTS

    jmodel = JF5TTS(JF5Config.from_dict(TINY_CFG))
    ref = jax.device_get(jmodel.init_params(0)["params"])
    assert (jax.tree_util.tree_structure(ref)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, trees["params"])))
    # the first moment is stored as bf16, as the JAX package stores its own
    import ml_dtypes

    mu = jax.tree_util.tree_leaves(trees["opt"]["mu"])
    assert all(m.dtype == ml_dtypes.bfloat16 for m in mu)
    np.testing.assert_array_equal(
        np.asarray(mu[0]).astype(np.float32),
        jax.tree_util.tree_leaves(trainer._flax_tree(trainer.state.mu))[0])


def test_jax_checkpoint_is_read_by_the_port(tmp_path):
    from oron_tts_tpu.config import F5Config as JF5Config
    from oron_tts_tpu.models.f5tts import F5TTS as JF5TTS

    jmodel = JF5TTS(JF5Config.from_dict(TINY_CFG))
    params = jax.device_get(jmodel.init_params(0)["params"])
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)
    ema = jax.tree_util.tree_map(lambda x: (0.5 * x).astype(np.float32), params)
    tx = jtrainer.make_optimizer(jtrainer.make_lr_schedule(1e-3, 2, 10), mu_dtype=jnp.bfloat16)
    jckpt.CheckpointManager(tmp_path / "ckpt").save(
        step=7, params=params, opt_state=tx.init(params), ema_params=ema, loss=0.25,
        config=TINY_CFG, extra_state={"epoch": 3, "best_val": 0.5})

    trees, meta = load_pytree_npz(tmp_path / "ckpt" / "f5tts_step_00000007.npz")
    assert meta["step"] == 7
    _assert_trees_equal(trees["params"], params)
    trainer = _trainer(tmp_path)
    trainer.load_checkpoint()
    assert (trainer.global_step, trainer.epoch, trainer._best_val) == (7, 3, 0.5)
    _assert_trees_equal(trainer._flax_tree(trainer.state.params), params)
    _assert_trees_equal(trainer._flax_tree(trainer.state.ema), ema)
    # optax's opt tree is read: its initial moments are zero and its count 0
    assert not any(m.any() for m in trainer.state.mu) and trainer.state.count == 0
    for w, p in zip(trainer.work, trainer.state.params):
        assert torch.equal(w.detach(), p)


def test_jax_trainer_checkpoint_resumes_with_its_optimizer_state(tmp_path):
    """The JAX trainer writes a checkpoint after two steps; both packages resume
    it and take one step on the same batch and noise (the deterministic loss,
    ``x0`` injected). Both losses agree; the JAX gradients go into both
    optimizers, so what is compared is the resumed state and the update. The
    port reads optax's Adam moments and count from the checkpoint's positional
    ``opt/#i`` tree, so moments, count and parameters agree with the JAX
    trainer's to 1e-5 of each tensor's largest value, bf16 first moments also
    within one bf16 rounding of the value."""
    from oron_tts_tpu.config import F5Config as JF5Config
    from oron_tts_tpu.models.f5tts import F5TTS as JF5TTS

    rng = np.random.default_rng(3)
    B, T = 2, 64
    batch = {"mel": rng.standard_normal((B, 100, T)).astype(np.float32),
             "text_ids": rng.integers(0, 60, (B, T)).astype(np.int32),
             "mel_lengths": np.asarray([T, T - 21], np.int32)}
    batch["text_ids"][1, T - 21:] = -1
    x0 = rng.standard_normal((B, T, 100)).astype(np.float32)

    def jax_trainer(tag):
        model = JF5TTS(JF5Config.from_dict(TINY_CFG))
        model.variables = {"params": jax.tree_util.tree_map(jnp.asarray, tiny_trainer_params())}
        return jtrainer.F5Trainer(config=dict(TINY_CFG), model=model, train_loader=[batch, batch],
                                  log_dir=str(tmp_path / f"jlogs{tag}"),
                                  checkpoint_dir=str(tmp_path / "ckpt"))

    writer = jax_trainer("w")
    for i in range(2):
        key = jax.random.PRNGKey(i)
        writer.state, _ = writer._get_train_step(batch, key)(writer.state, batch, key)
    writer.global_step = 2
    writer.save_checkpoint()

    reader = jax_trainer("r")
    reader.load_checkpoint()

    def j_loss(params):
        return reader.model.cfm.loss(
            {"params": params}, jnp.asarray(batch["mel"]), jnp.asarray(batch["text_ids"]),
            jnp.asarray(batch["mel_lengths"]), jax.random.PRNGKey(0), train=False,
            x0=jnp.asarray(x0))

    j_val, j_grads = jax.value_and_grad(j_loss)(reader.state.params)
    jstate, _, j_ok = jtrainer._guarded_update(reader.state, j_grads, reader.tx,
                                               reader.ema_decay)

    trainer = _trainer(tmp_path, tag="p")
    trainer.load_checkpoint()
    st = trainer.state
    assert st.count == 2 and any(m.any() for m in st.mu)
    b = trainer._to_device(batch)
    with torch.no_grad():
        loss = trainer.model.cfm.loss(b["mel"], b["text_ids"], b["mel_lengths"], train=False,
                                      x0=torch.from_numpy(x0))
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-5)
    g = from_flax_params(jax.device_get(j_grads))
    assert trainer._apply([g[n].clone() for n in st.names], loss)["ok"] and bool(j_ok)

    adam = jstate.opt_state[1][0]
    assert st.count == int(adam.count) == 3
    for got, ref, what in ((st.params, jstate.params, "params"), (st.nu, adam.nu, "nu"),
                           (st.mu, adam.mu, "mu")):
        ref = from_flax_params(jax.device_get(ref))
        for name, a in zip(st.names, got):
            r = ref[name].float()
            err = (a.float() - r).abs()
            tol = 1e-5 * float(r.abs().max())
            if what == "mu":
                tol = tol + torch.from_numpy(_bf16_ulp(r.numpy()))
            assert bool((err <= tol).all()), (what, name, float(err.max()))


@pytest.mark.parametrize("source", ["tiny_jax_init", "seeded_port"])
def test_to_flax_params_inverts_from_flax_params(source):
    from oron_tts_tpu_torch.config import ModelConfig

    tree = tiny_params() if source == "tiny_jax_init" else seeded_dit_params(
        ModelConfig(dim=128, depth=1, heads=2, text_dim=32, conv_layers=2), seed=2)
    _assert_trees_equal(to_flax_params(from_flax_params(tree)), tree)


def test_set_params_keeps_full_precision_masters(tmp_path):
    trainer = _trainer(tmp_path)
    tree = trainer._flax_tree([p + 1e-4 for p in trainer.state.params])
    trainer.set_params(tree)
    _assert_trees_equal(trainer._flax_tree(trainer.state.params), tree)
    _assert_trees_equal(trainer._flax_tree(trainer.state.ema), tree)


# ── the CLI ─────────────────────────────────────────────────────────────


def test_cli_trains_from_local_data_and_resumes(tmp_path, capsys):
    from oron_tts_tpu_torch.cli import train as cli_train
    from oron_tts_tpu_torch.data.wav import wav_info, write_wav

    ds = _synthetic_dataset(5)
    records = []
    for i, audio in enumerate(ds.audio_arrays):
        path = tmp_path / f"clip{i}.wav"
        write_wav(path, audio, 24000)
        assert wav_info(path) == (pytest.approx(len(audio) / 24000), 24000)
        records.append({"audio_path": str(path), "text": ds.texts[i], "lang": "mn"})
    records.append({"audio_path": str(tmp_path / "missing.wav"), "text": "x"})
    (tmp_path / "metadata.json").write_text(json.dumps(records))
    args = ["--config", str(REPO / "configs" / "test.yaml"), "--from-local", "--data-dir",
            str(tmp_path), "--device", "cpu", "--log-dir", str(tmp_path / "logs"),
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    prev = signal.getsignal(signal.SIGTERM)
    try:
        cli_train.main(args + ["--num-epochs", "1"])
        assert (tmp_path / "ckpt" / "f5tts_step_00000002.npz").exists()  # 5 clips / batch 2
        cli_train.main(args + ["--num-epochs", "2", "--resume"])
        assert (tmp_path / "ckpt" / "f5tts_step_00000004.npz").exists()
    finally:
        signal.signal(signal.SIGTERM, prev)
    out = capsys.readouterr().out
    assert "skipped 1/6 samples" in out and "Resumed from step 2" in out


# the HuggingFace dataset path (--dataset, and no --from-local), the hub push
# (--push-to-hub, --hf-repo) and --num-gpus (accepted and ignored, as in the
# JAX package) parse, and the run stops only at the missing corpus; a mesh
# that does not match the world (--mesh 4x1 in a world of one) and
# --multihost without the torchrun environment raise, naming torchrun
@pytest.mark.parametrize("flags", [["--push-to-hub"], ["--mesh", "4x1"], ["--hf-repo", "a/b"],
                                   ["--num-gpus", "2"], ["--multihost"]])
def test_cli_names_what_is_not_ported(flags, capsys, tmp_path, monkeypatch):
    from oron_tts_tpu_torch.cli import train as cli_train

    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    if flags[0] in ("--push-to-hub", "--hf-repo", "--num-gpus"):
        with pytest.raises(FileNotFoundError, match="metadata.json"):
            cli_train.main(["--device", "cpu"] + flags + ["--from-local", "--data-dir",
                                                          str(tmp_path)])
        captured = capsys.readouterr()
        assert "ROADMAP.md" not in captured.err
        if flags[0] == "--num-gpus":
            assert "--num-gpus 2 is ignored" in captured.out
            assert "torch.distributed.run --nproc-per-node" in captured.out
        return
    with pytest.raises(SystemExit):
        cli_train.main(["--device", "cpu"] + flags + ["--from-local"])
    err = capsys.readouterr().err
    assert "torch.distributed.run" in err and "ROADMAP.md" not in err
    assert ("does not cover 1 process" in err) == (flags[0] == "--mesh")
    assert not torch.distributed.is_initialized()


# ── learning dynamics ───────────────────────────────────────────────────


def test_loss_decreases(tmp_path):
    cfg = {
        "sample_rate": 24000, "n_mels": 100, "learning_rate": 2e-3, "warmup_steps": 10,
        "num_epochs": 40, "ema_decay": 0.99, "max_grad_norm": 1.0, "use_tqdm": False,
        "audio_sample_interval": 10**9, "log_interval": 10**9,
        "model": {"vocab_size": 65, "dim": 64, "depth": 2, "heads": 2, "ff_mult": 2,
                  "text_dim": 32, "conv_layers": 1, "p_dropout": 0.1},
    }
    sr = 24000
    t = np.arange(sr) / sr
    arrays = [(0.5 * np.sin(2 * np.pi * (180 + 60 * i) * t)).astype(np.float32) for i in range(4)]
    ds = TTSDataset(audio_arrays=arrays, texts=["нэг хоёр гурав дөрөв"] * 4, sample_rate=sr)
    collator = TTSCollator(pad_to_multiple=64)
    model = F5TTS.from_config(cfg, device="cpu")
    trainer = F5Trainer(
        config=cfg, model=model,
        train_loader=DataLoader(ds, FixedBatchSampler(4, 4, seed=0), collator, num_workers=0),
        val_loader=DataLoader(ds, FixedBatchSampler(4, 4, shuffle=False, drop_last=False),
                              collator, num_workers=0),
        log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / "ckpt"))
    initial = trainer.validate(use_ema=False)
    for _ in range(40):
        trainer.train_epoch(total_epochs=40)
    final, final_ema = trainer.validate(use_ema=False), trainer.validate(use_ema=True)
    # the zero-initialised model predicts 0; training must cut the eval loss by 35%
    assert np.isfinite(final) and final < 0.65 * initial, (initial, final)
    assert final_ema < initial, (initial, final_ema)
    trainer.finish()
    wav = model.synthesize("нэг хоёр", n_steps=2, target_duration_s=0.4, seed=0)
    assert np.isfinite(wav).all()
