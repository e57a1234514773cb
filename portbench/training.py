"""Training cells: ``F5Trainer.train_step`` fed by the port's own data path.

Set-up writes a seeded corpus of speech-like WAV clips under the run's
``TMPDIR`` and wires it as ``cli/train.py --from-local`` does: ``TTSDataset``
over ``metadata.json`` → ``DynamicBatchSampler`` (the frame budget) →
``TTSCollator`` → the threaded ``DataLoader``; ``gradient_checkpointing:
auto`` is decided by the program's memory model. The trainer then takes its
first three steps through ``train_step`` on that loader (what the check
follows), and the same trainer and loader go on into the measured window.
The corpus is small enough that ``TTSDataset``'s item cache holds it after
the first epoch, so most window steps read cached items and no WAV decode
or host log-mel competes with the launching thread. A window step that the
guard skips, or whose loss is not finite, makes the run not correct.

The rate is the kept (unpadded) mel frames of the window's steps over its
seconds; the step that straddles the close counts by the share of it that
fell inside.
"""

from __future__ import annotations

import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import audio, flops, record
from portbench.reference import architecture
from portbench.traffic import make_text, quantile_lengths

CHECK_STEPS = 3


def make_corpus(mix: dict, seed: int, out_dir: Path) -> list[dict]:
    """Seeded clips cut from a few speech-like recordings, written as PCM16 WAVs."""
    c = mix["corpus"]
    rng = np.random.default_rng([int(seed) % (1 << 63), 11])
    bases = [audio.speech_clip(rng, c["max_s"]) for _ in range(int(c["recordings"]))]
    n = int(c["clips"])
    # seconds from the lognormal's quantiles (in tenths), shuffled by the seed
    secs = [s / 10 for s in quantile_lengths(n, 10 * c["median_s"], c["sigma"],
                                             int(10 * c["min_s"]), int(10 * c["max_s"]))]
    secs = [secs[i] for i in rng.permutation(n)]
    meta = []
    for i, s in enumerate(secs):
        base = bases[int(rng.integers(0, len(bases)))]
        length = int(s * audio.SR)
        start = int(rng.integers(0, len(base) - length + 1))
        clip = base[start: start + length] * rng.uniform(0.5, 1.0)
        path = out_dir / f"clip{i:05d}.wav"
        path.write_bytes(audio.pcm16_wav(clip))
        letters = max(2, round(c["letters_per_s"] * s))
        meta.append({"audio_path": str(path), "text": make_text(rng, letters, "mn", mix["text"]),
                     "lang": "mn"})
    (out_dir / "metadata.json").write_text(json.dumps(meta, ensure_ascii=False))
    return meta


class _Recorder:
    """The loader's batch sampler, recording the index lists it hands out."""

    def __init__(self, sampler) -> None:
        self.sampler, self.seen = sampler, []

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self):
        for entry in self.sampler:
            self.seen.append(list(entry))
            yield entry


def batches(loader, recorder: _Recorder):
    """The loader's batches over epoch after epoch, each with its clips' indices."""
    epoch = 0
    while True:
        recorder.set_epoch(epoch)
        start = len(recorder.seen)
        for k, batch in enumerate(loader):
            yield batch, recorder.seen[start + k]
        epoch += 1


def build(cfg: dict, seed: int, device: str, data_dir: Path, log_dir: Path):
    """The trainer and its loader over the corpus, as ``cli/train.py`` builds them."""
    import torch

    from oron_tts_tpu_torch.cli import train as train_cli
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from portbench.serving import port_config
    from portbench.weights import dit_state

    config = port_config(cfg)
    config["use_tqdm"] = False
    dev = torch.device(device)
    if config.get("gradient_checkpointing") == "auto":
        config["gradient_checkpointing"] = train_cli.decide_gradient_checkpointing(config, dev)
    dtype = torch.bfloat16 if (config.get("mixed_precision") == "bfloat16"
                               and dev.type == "cuda") else torch.float32
    model = F5TTS(F5Config.from_dict(config), device=dev, dtype=dtype)
    shapes = {k: tuple(v.shape) for k, v in model.backbone.state_dict().items()}
    model.backbone.load_state_dict(dit_state(shapes, seed, dev, dtype, architecture(cfg)),
                                   strict=True)
    model.params_loaded = True
    dataset = train_cli.build_dataset(str(data_dir), config)
    loader, _ = train_cli.build_loaders(dataset, config)
    recorder = _Recorder(loader.batch_sampler)
    loader.batch_sampler = recorder
    trainer = F5Trainer(config=config, model=model, train_loader=loader, val_loader=None,
                        log_dir=str(log_dir / "logs"), checkpoint_dir=str(log_dir / "ckpt"))
    model.backbone.train()
    return trainer, loader, recorder, shapes, config


def warm_up(trainer, loader, recorder) -> None:
    """Every batch shape an epoch holds, once through the loss and its backward (no
    update: the state the check follows is untouched), outside the window."""
    import torch

    sub = loader.dataset
    frames = [int(d * 24000 / 256) + 1 for d in sub.durations]
    rows_mult = loader.collate_fn.pad_batch_to_multiple
    t_mult = loader.collate_fn.pad_to_multiple
    shapes = sorted({(-(-len(b) // rows_mult) * rows_mult,
                      -(-max(frames[i] for i in b) // t_mult) * t_mult)
                     for b in recorder.sampler.batches})
    gen = torch.Generator().manual_seed(0)
    for B, T in shapes:
        batch = {"mel": np.zeros((B, 100, T), np.float32), "text_ids": np.zeros((B, T), np.int32),
                 "mel_lengths": np.full(B, T, np.int32)}
        trainer._loss_and_grads(batch, gen)


def _host(tensors) -> list:
    return [t.detach().float().cpu().clone() for t in tensors]


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device: str,
        setup_t0: float, root: Path, fault: str | None = None, control: bool = False) -> dict:
    """One training run; returns the harness's record. ``fault`` plants one of the
    faults the check must catch; ``control`` also reads the control (both for choosing
    and testing the limits, never in a benchmark run)."""
    import torch

    tmp = Path(tempfile.mkdtemp(prefix="portbench-train-"))
    try:
        data_dir = tmp / "corpus"
        data_dir.mkdir()
        meta = make_corpus(mix, seed, data_dir)
        trainer, loader, recorder, shapes, config = build(cfg, seed, device, data_dir, tmp)
        if fault:
            plant(trainer, fault)
        out = _drive(trainer, loader, recorder, seed, seconds, trace, setup_t0, cfg, device)
        subset = loader.dataset
        out["check_clips"] = [[subset.indices[i] for i in idx] for idx in out.pop("first_idx")]
        del trainer, loader, recorder, subset
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        from portbench import check_train

        out["checks"] = check_train.training(cfg, config, meta, out, seed, shapes, device)
        if out["failed"]:
            out["checks"]["problems"].append(
                f"{out['failed']} window steps skipped by the guard or with a non-finite loss")
        if control:
            out["control"] = check_train.training(cfg, config, meta, out, seed, shapes, device,
                                                  control=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _drive(trainer, loader, recorder, seed: int, seconds: float, trace: bool, setup_t0: float,
           cfg: dict, device: str) -> dict:
    import torch

    cuda = device != "cpu"
    warm_up(trainer, loader, recorder)
    gen = torch.Generator().manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    feed = batches(loader, recorder)
    st = trainer.state
    out: dict = {"losses": [], "first_idx": []}
    out["params0"] = _host(st.params)
    for k in range(CHECK_STEPS):
        batch, idx = next(feed)
        metrics = trainer.train_step(batch, gen)
        out["losses"].append(metrics["loss"])
        out["first_idx"].append(idx)
        out.setdefault("ok", []).append(metrics["ok"])
        if k == 0:
            out["nu1"] = _host(st.nu)
    out["params3"] = _host(st.params)
    out["ema3"] = _host(st.ema)
    out["names"] = list(st.names)
    if cuda:
        torch.cuda.synchronize()
    probe = record.Probe() if trace else None
    if probe is not None:
        _probe_trainer(trainer, probe)
        if cuda:
            record.profiler_warm_up()
    frames, steps, skipped, box = 0.0, 0, 0, {}
    t_open = time.perf_counter()
    out["setup_s"] = t_open - setup_t0
    t_close = t_open + seconds
    length = min(TRACE_S, seconds)
    trace_from = t_open + (seconds - length) / 2
    prof = None
    while True:
        t0 = time.perf_counter()
        if prof is not None and (t0 >= box["t0_perf"] + length or t0 >= t_close):
            record.trace_stop(box, probe, prof)
            prof = None
        if t0 >= t_close:
            break
        if trace and "t0" not in box and t0 >= trace_from:  # on this thread, at a step's edge
            prof = record.trace_start(box, probe)
        w0 = record.now_ns()
        batch, _ = next(feed)
        w1 = record.now_ns()
        metrics = trainer.train_step(batch, gen)
        t1 = time.perf_counter()
        kept = int(np.asarray(batch["mel_lengths"]).sum())
        share = 1.0 if t1 <= t_close else (t_close - t0) / (t1 - t0)
        if metrics["ok"] and np.isfinite(metrics["loss"]):
            frames += kept * share
        else:
            skipped += 1
        steps += 1
        if probe is not None:
            probe.span("data wait", w0, w1)
            probe.span("step", w1, record.now_ns(), share=share,
                       lengths=[int(x) for x in np.asarray(batch["mel_lengths"])],
                       padded=int(np.prod(np.asarray(batch["mel"]).shape[::2])))
    if cuda:
        torch.cuda.synchronize()
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    out.update({"train_frames_per_s": frames / seconds, "attempted": steps, "failed": skipped,
                "errors": skipped, "window": {"t_open": t_open, "t_close": t_close}})
    if trace:
        out["trace"] = _trace_record(box, probe, cfg, seconds, t_open, t_close)
    return out


TRACE_S = 10.0


def _probe_trainer(trainer, probe: record.Probe) -> None:
    """Spans and edge markers around the guarded update, and shapes of the attention
    backward calls."""
    import torch

    from oron_tts_tpu_torch.ops import flash_attention as fa

    apply = trainer._apply

    def apply_probe(grads, loss, extra_ok=None):
        # the backward's kernels are still queued when the host enters the update, so
        # the update's own kernels are those between two edge markers in stream order
        record.edge(probe, opens=True)
        t0 = record.now_ns()
        out = apply(grads, loss, extra_ok)
        record.edge(probe, opens=False)
        probe.span("update", t0, record.now_ns())
        return out

    trainer._apply = apply_probe
    bwd = fa.flash_lanes_bwd

    def bwd_probe(q, k, v, kv_lens, out, dout, lse2, heads):
        if probe.tracing:
            B, T, HD = q.shape
            probe.call("attn_bwd", B=B, T=T, H=heads, D=HD // heads, kv=kv_lens)
        return bwd(q, k, v, kv_lens, out, dout, lse2, heads)

    bwd_probe.__wrapped__ = bwd
    bwd_probe.launches = bwd.launches
    fa.flash_lanes_bwd = bwd_probe


def _trace_record(box: dict, probe: record.Probe, cfg: dict, seconds: float, t_open: float,
                  t_close: float) -> dict:
    events = record.aligned(record.read_profiler(box["prof"]), box)
    t0, t1 = box["t0"], box["t1"]
    dev = record.device_summary(events, t0, t1)
    shift = time.time_ns() - int(time.perf_counter() * 1e9)
    w0, w1 = int(t_open * 1e9) + shift, int(t_close * 1e9) + shift
    spans = [sp for sp in probe.spans if w0 <= sp["t0"] < w1]
    steps = [sp for sp in spans if sp["name"] == "step"]
    update_s, n_updates = record.between_edges(events)
    print(f"update edges: {n_updates} pairs, {update_s:.6f} s between them", file=sys.stderr)
    from oron_tts_tpu_torch.ops import flash_attention as fa

    fa.flash_lanes_bwd = getattr(fa.flash_lanes_bwd, "__wrapped__", fa.flash_lanes_bwd)
    return {
        "busy_s": dev["busy_s"], "window_s": (t1 - t0) / 1e9, "seconds": seconds,
        "kernels": dev["by_name"],
        "idle_gaps": record.idle_gaps(dev["busy"], t0, t1, probe.spans),
        "data_wait_s": [(sp["t1"] - sp["t0"]) / 1e9 for sp in spans if sp["name"] == "data wait"],
        "steps": len(steps),
        "train_flops": window_flops(cfg, steps),
        "kept_frames": sum(sum(sp["lengths"]) for sp in steps),
        "padded_frames": sum(sp["padded"] for sp in steps),
        "update_device_s": update_s, "updates_traced": n_updates,
        "attn_bwd_bound_s": sum(
            flops.attn_bwd_bound_s(c["B"], c["T"], c["H"], c["D"],
                                   int(c["kv"].clamp(max=c["T"]).sum()))
            for c in probe.calls["attn_bwd"] if c["traced"]),
    }


def window_flops(cfg: dict, steps: list[dict]) -> float:
    """Model FLOPs of the traced steps, each by its share inside the window, by the
    configuration's architecture."""
    arch = architecture(cfg)
    return sum(sp["share"] * arch.train_step_flops(cfg, sp["lengths"]) for sp in steps)


def plant(trainer, fault: str) -> None:
    """Break the timed path underneath: a fault the check must catch."""
    import torch

    if fault == "unchanged":  # the step returns the state as it found it
        trainer._apply = lambda grads, loss, extra_ok=None: {
            "loss": float(loss), "grad_norm": 0.0, "ok": True}
    elif fault == "half_batch":  # half the rows left out, the mean over the rest
        step = trainer.train_step

        def half(batch, gen):
            n = max(1, int((np.asarray(batch["mel_lengths"]) > 0).sum()) // 2)
            cut = {k: np.array(v) for k, v in batch.items()}
            cut["mel_lengths"][n:] = 0
            cut["mask"][n:] = False
            return step(cut, gen)

        trainer.train_step = half
    elif fault == "skipped":  # the guard skips every step after the checked ones
        step, calls = trainer.train_step, [0]

        def skip(batch, gen):
            calls[0] += 1
            metrics = step(batch, gen)
            return metrics if calls[0] <= CHECK_STEPS else {**metrics, "ok": False}

        trainer.train_step = skip
    elif fault == "loss_altered":  # an answer altered where it is produced
        loss_fn = trainer.model.cfm.loss

        def altered(*a, **k):
            return loss_fn(*a, **k) * 1.05

        trainer.model.cfm.loss = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")
    del torch
