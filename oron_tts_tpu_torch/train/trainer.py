"""F5 trainer: guarded AdamW + EMA around ``CFM.loss`` (PyTorch).

Counterpart of the JAX package's ``train/trainer.py``: one AdamW
(weight decay 0.01) under a linear warm-up (start factor 1e-4) into a
cosine decay (floor 1e-6), global-norm gradient clipping, an EMA of the
weights with the ``min(d, (1 + n)/(10 + n))`` ramp, a guard that freezes
parameters, moments, EMA and every counter when the loss or the gradient
norm is not finite, gradient accumulation on the device, validation on the
EMA weights each epoch, best-validation tracking, rotating checkpoints and a
SIGTERM checkpoint.

Precision. The trainer owns f32 master weights, the EMA (f32) and the
moments (first moment bf16 by default, second f32). The model's backbone is
the working set in the compute dtype (bf16 on the card): forward and
backward run there, the gradients are widened to f32, the update is applied
to the masters, and the masters are copied back into the working set (in
f32 compute too: one scheme, and validation can lend the working set to the
EMA weights). The update itself is written out in tensor ops after optax's ``adamw``
(``torch.optim.AdamW`` has no bf16 first moment), including optax's
rounding of ``b1·mu`` in bf16.

One host read per optimizer step (loss, gradient norm, and the window's
finite flag when accumulating) decides the guard; micro-batches of an
accumulation window are never read. Randomness (spans, times, CFG dropout,
noise, dropout seeds) comes from one CPU ``torch.Generator`` per epoch,
seeded ``seed + epoch``.

Not ported: the XLA-specific machinery (AOT layouts, relayout, the
compilation cache), meshes and ZeRO, and the hub push.
"""

from __future__ import annotations

import logging
import math
import signal
import sys
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from oron_tts_tpu_torch.models.f5tts import F5TTS
from oron_tts_tpu_torch.train.checkpoint import CheckpointManager
from oron_tts_tpu_torch.utils.weights import from_flax_params, to_flax_params


def make_lr_schedule(
    lr: float, warmup_steps: int, total_steps: int, eta_min: float = 1e-6,
    start_factor: float = 1e-4,
) -> Callable[[int], float]:
    """Linear warm-up from ``lr·start_factor`` to ``lr``, then cosine to ``eta_min``."""
    decay_steps = max(total_steps - warmup_steps, 1)
    alpha = eta_min / lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - step / warmup_steps
            return (lr * start_factor - lr) * frac + lr
        count = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


class TrainState:
    """Masters, moments, EMA and counters; lists run parallel to ``names``."""

    def __init__(self, names: list[str], params: list[torch.Tensor],
                 mu_dtype: torch.dtype = torch.bfloat16) -> None:
        self.names = names
        self.params = params
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.ema = [p.clone() for p in params]
        self.count = 0        # optimizer updates applied (drives the schedule)
        self.step = 0
        self.ema_updates = 0


@torch.no_grad()
def guarded_update(
    state: TrainState,
    grads: list[torch.Tensor],
    schedule: Callable[[int], float],
    ema_decay: float,
    betas: tuple[float, float] = (0.9, 0.999),
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
    eps: float = 1e-8,
    extra_ok: bool = True,
    grad_norm: float | None = None,
) -> tuple[float, bool]:
    """Clip, AdamW, EMA, all skipped when the step is not finite.

    ``grads`` are f32 and may be modified. Returns (grad_norm, ok); when
    ``ok`` is false nothing in ``state`` has changed. Mirrors the JAX
    package's ``_guarded_update`` over ``optax.chain(clip_by_global_norm,
    adamw)``.
    """
    if grad_norm is None:
        grad_norm = float(torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads))))
    ok = math.isfinite(grad_norm) and bool(extra_ok)
    if not ok:
        return grad_norm, False

    b1, b2 = betas
    f32 = np.float32
    count_inc = state.count + 1
    bc1 = float(f32(1) - f32(b1) ** f32(count_inc))
    bc2 = float(f32(1) - f32(b2) ** f32(count_inc))
    lr = float(f32(schedule(state.count)))
    n = state.ema_updates + 1
    decay = float(min(f32(ema_decay), f32(1.0 + n) / f32(10.0 + n)))
    one_minus_decay = float(f32(1.0) - f32(decay))
    # optax multiplies a bf16 moment by b1 in bf16: the constant is rounded too
    b1_lp = float(torch.tensor(b1).to(torch.bfloat16))
    clip = grad_norm >= max_grad_norm

    for p, g, m, v, e in zip(state.params, grads, state.mu, state.nu, state.ema):
        if clip:
            g = (g / grad_norm) * max_grad_norm
        mu = g * (1.0 - b1)
        if m.dtype == torch.float32:
            mu.add_(m * b1)
        else:
            mu.add_((m * b1_lp).float())
        v.mul_(b2).add_((g * g).mul_(1.0 - b2))
        update = (mu / bc1).div_((v / bc2).sqrt_().add_(eps))
        update.add_(p, alpha=weight_decay)
        p.add_(update.mul_(-lr))
        m.copy_(mu)
        e.mul_(decay).add_(p * one_minus_decay)
    state.count = count_inc
    state.step += 1
    state.ema_updates += 1
    return grad_norm, True


class TrainingPreempted(RuntimeError):
    """Raised after the emergency checkpoint when SIGTERM interrupted
    training. The checkpoint is already on disk when this propagates."""


class F5Trainer:
    """Trainer facade with the JAX package's constructor arguments (hub and
    mesh left out). It trains where ``model`` lives, and ``F5TTS`` refuses a
    silent CPU, so there is no device argument here.
    """

    def __init__(
        self,
        config: dict[str, Any],
        model: F5TTS,
        train_loader: Any,
        val_loader: Any | None = None,
        log_dir: str = "logs",
        checkpoint_dir: str = "checkpoints",
    ) -> None:
        self.config = config
        self.model = model
        self.device = model.device
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.log_dir = log_dir

        lr = config.get("learning_rate", 1e-4)
        self.betas = tuple(config.get("betas", [0.9, 0.999]))
        warmup_steps = config.get("warmup_steps", 1000)
        num_epochs = config.get("num_epochs", 500)
        self.grad_accum = max(1, config.get("grad_accumulation_steps", 1))
        steps_per_epoch = max(len(train_loader) // self.grad_accum, 1)
        self.schedule = make_lr_schedule(lr, warmup_steps, num_epochs * steps_per_epoch)
        self.max_grad_norm = config.get("max_grad_norm", 1.0)
        self.weight_decay = 0.01
        self.ema_decay = config.get("ema_decay", 0.9999)
        self._preempt_requested = False
        self._preempt_installed = False

        if not model.params_loaded:
            model.init_params(0)
        named = list(model.backbone.named_parameters())
        self.work = [p for _, p in named]
        for p in self.work:
            p.requires_grad_(True)
        masters = [p.detach().float().clone() for p in self.work]
        mu_dtype = (torch.bfloat16 if config.get("adam_mu_dtype", "bfloat16") == "bfloat16"
                    else torch.float32)
        self.state = TrainState([n for n, _ in named], masters, mu_dtype)

        self.epoch = 0
        self._best_val = float("inf")
        self.use_tqdm = config.get("use_tqdm", True)
        self.checkpoint_manager = CheckpointManager(
            checkpoint_dir, model_name="f5tts",
            max_checkpoints=config.get("max_checkpoints", 5),
            async_writes=bool(config.get("async_checkpoint", False)),
        )
        self.logger = self._setup_logger()
        self.writer = self._setup_tensorboard()

    @property
    def global_step(self) -> int:
        """Optimizer steps applied; the guarded update keeps the count."""
        return self.state.step

    # ── infra ────────────────────────────────────────────────────────────

    def _setup_logger(self) -> logging.Logger:
        logger = logging.getLogger("F5Trainer")
        logger.setLevel(logging.INFO)
        logger.handlers.clear()
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        return logger

    def _setup_tensorboard(self):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self.logger.warning("tensorboardX not installed — console logging only")
            return None
        path = Path(self.log_dir).expanduser().resolve()
        path.mkdir(parents=True, exist_ok=True)
        self.log_dir = str(path)
        self.logger.info("TensorBoard log_dir = %s", self.log_dir)
        return SummaryWriter(log_dir=self.log_dir, flush_secs=30)

    def _device_mem_gb(self) -> float | None:
        if self.device.type != "cuda":
            return None
        return torch.cuda.max_memory_allocated(self.device) / 1e9

    # ── steps ────────────────────────────────────────────────────────────

    def _to_device(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(batch[k])).to(self.device)
                for k in ("mel", "text_ids", "mel_lengths")}

    def _sync_working_set(self, source: list[torch.Tensor]) -> None:
        """Copy ``source`` (masters or EMA) into the model's working parameters."""
        with torch.no_grad():
            for w, s in zip(self.work, source):
                w.copy_(s)

    def _loss_and_grads(self, batch, generator) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Training loss (device scalar, not read) and f32 gradients."""
        b = self._to_device(batch)
        loss = self.model.cfm.loss(
            b["mel"], b["text_ids"], b["mel_lengths"], generator, train=True)
        loss.backward()
        grads = []
        for p in self.work:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads.append(g.float())
            p.grad = None
        return loss.detach(), grads

    def _apply(self, grads, loss: torch.Tensor, extra_ok: torch.Tensor | None = None) -> dict:
        """One guarded update; the step's single host read happens here."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        flag = torch.ones((), device=norm.device) if extra_ok is None else extra_ok.float()
        loss_v, norm_v, flag_v = torch.stack([loss.float(), norm.float(), flag]).tolist()
        _, ok = guarded_update(
            self.state, grads, self.schedule, self.ema_decay, betas=self.betas,
            weight_decay=self.weight_decay, max_grad_norm=self.max_grad_norm,
            extra_ok=math.isfinite(loss_v) and flag_v > 0.5, grad_norm=norm_v,
        )
        if ok:
            self._sync_working_set(self.state.params)
        return {"loss": loss_v, "grad_norm": norm_v, "ok": ok}

    def train_step(self, batch: dict[str, np.ndarray], generator: torch.Generator) -> dict:
        """Fused step: loss, gradients, guarded update. Returns host metrics."""
        loss, grads = self._loss_and_grads(batch, generator)
        return self._apply(grads, loss)

    def _zero_accum(self) -> dict:
        dev = self.device
        return {
            "grads": [torch.zeros_like(p) for p in self.state.params],
            "loss_sum": torch.zeros((), device=dev),
            "n_finite": torch.zeros((), device=dev),
            "all_finite": torch.ones((), dtype=torch.bool, device=dev),
        }

    @torch.no_grad()
    def _accum_step(self, acc: dict, batch, generator) -> None:
        """Add one micro-batch on the device; nothing is read on the host.

        A non-finite micro-batch loss adds nothing and clears ``all_finite``,
        which makes the window's apply step freeze everything.
        """
        with torch.enable_grad():
            loss, grads = self._loss_and_grads(batch, generator)
        finite = torch.isfinite(loss)
        for a, g in zip(acc["grads"], grads):
            a.add_(torch.where(finite, g, torch.zeros_like(g)))
        acc["loss_sum"] += torch.where(finite, loss.float(), torch.zeros_like(acc["loss_sum"]))
        acc["n_finite"] += finite.float()
        acc["all_finite"] &= finite

    @torch.no_grad()
    def _apply_accum(self, acc: dict) -> dict:
        """Mean over the window's finite micro-batches, then the guarded update."""
        scale = 1.0 / torch.clamp(acc["n_finite"], min=1.0)
        for a in acc["grads"]:
            a.mul_(scale)
        return self._apply(acc["grads"], acc["loss_sum"] * scale, acc["all_finite"])

    def _record(self, metrics: dict, batch_size: int, mel_frames: int, pbar) -> float | None:
        """Bookkeeping for one optimizer step; returns its loss if it counted."""
        loss, grad_norm = metrics["loss"], metrics["grad_norm"]
        if not math.isfinite(loss):
            self.logger.warning("Skipping batch due to non-finite loss=%s", loss)
            return None
        if not metrics["ok"]:
            self.logger.warning("Skipped optimizer step (non-finite grad_norm=%s)", grad_norm)
            return None
        lr = self.schedule(self.global_step)
        if self.writer:
            for tag, val in (("train/loss", loss), ("train/lr", lr),
                             ("train/grad_norm", grad_norm),
                             ("train/batch_size", batch_size),
                             ("train/mel_frames", mel_frames)):
                self.writer.add_scalar(tag, val, self.global_step)
            mem = self._device_mem_gb()
            if mem is not None:
                self.writer.add_scalar("system/vram_gb", mem, self.global_step)
        if self.global_step % self.config.get("log_interval", 100) == 0 and pbar is None:
            self.logger.info(
                f"Step {self.global_step} | loss={loss:.4f} | lr={lr:.2e} | "
                f"grad_norm={grad_norm:.4f} | B={batch_size}")
        if pbar is not None:
            pbar.set_postfix(loss=f"{loss:.4f}", lr=f"{lr:.1e}", gn=f"{grad_norm:.2f}")
        return loss

    def train_epoch(self, total_epochs: int) -> float:
        total_loss, n_updates = 0.0, 0
        epoch_start = time.monotonic()
        generator = torch.Generator().manual_seed(self.config.get("seed", 0) + self.epoch)
        self.model.backbone.train()

        iterator, pbar = self.train_loader, None
        if self.use_tqdm:
            try:
                from tqdm import tqdm
            except ImportError:
                self.use_tqdm = False
            else:
                pbar = tqdm(self.train_loader, desc=f"Epoch {self.epoch + 1}/{total_epochs}")
                iterator = pbar

        acc = None  # on-device window accumulator (grad_accum > 1)
        for accum_step, batch in enumerate(iterator):
            if not np.isfinite(batch["mel"]).all():
                self.logger.warning("Skipping batch due to non-finite mel values")
                continue
            batch_size, mel_frames = int(batch["mel"].shape[0]), int(batch["mel"].shape[2])
            if self.grad_accum == 1:
                metrics = self.train_step(batch, generator)
            else:
                if acc is None:
                    acc = self._zero_accum()
                self._accum_step(acc, batch, generator)
                if (accum_step + 1) % self.grad_accum != 0:
                    continue
                metrics, acc = self._apply_accum(acc), None
            loss = self._record(metrics, batch_size, mel_frames, pbar)
            if loss is not None:
                total_loss += loss
                n_updates += 1
            self._maybe_preempt()  # every optimizer step is a host-sync point

        # flush a partial accumulation window; the on-device finite count
        # makes the mean come out right
        if acc is not None:
            loss = self._record(self._apply_accum(acc), 0, 0, pbar)
            if loss is not None:
                total_loss += loss
                n_updates += 1
        self._maybe_preempt()
        self.model.backbone.eval()

        self.epoch += 1
        epoch_time = time.monotonic() - epoch_start
        samples = len(self.train_loader.dataset) if hasattr(
            self.train_loader.dataset, "__len__") else 0
        throughput = samples / epoch_time if epoch_time > 0 else 0.0
        self.logger.info(
            f"  ↳ epoch {self.epoch}: {epoch_time:.1f}s | {throughput:.0f} samples/s | "
            f"avg_loss={total_loss / max(n_updates, 1):.4f}")
        return total_loss / max(n_updates, 1)

    @torch.no_grad()
    def validate(self, use_ema: bool = True) -> float:
        """Mean deterministic eval loss over the validation loader."""
        if self.val_loader is None:
            return 0.0
        if use_ema:
            self._sync_working_set(self.state.ema)
        losses = []
        try:
            for batch in self.val_loader:
                b = self._to_device(batch)
                losses.append(self.model.cfm.loss(
                    b["mel"], b["text_ids"], b["mel_lengths"], train=False).float())
        finally:
            if use_ema:
                self._sync_working_set(self.state.params)
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean())  # one host read

    def _log_audio_samples(self, epoch: int) -> None:
        if not self.writer or epoch % self.config.get("audio_sample_interval", 10) != 0:
            return
        samples = self.config.get(
            "audio_samples",
            [["Сайн байна уу, та хэрхэн байна?", "mn"], ["Монгол улс сайхан орон.", "mn"]],
        )
        self._sync_working_set(self.state.ema)
        try:
            for text, lang in (s[:2] for s in samples[:2]):
                tag = f"{lang}/{text[:20].replace(' ', '_')}"
                try:
                    wav = self.model.synthesize(text, lang=lang, n_steps=16)
                    self.writer.add_audio(
                        f"audio/{tag}", wav[None, :], epoch, sample_rate=self.model.sample_rate)
                except Exception as exc:  # diagnostics must not stop training
                    self.logger.warning(
                        "Audio sample synthesis failed for %r: %s", text, exc, exc_info=True)
        finally:
            self._sync_working_set(self.state.params)

    # ── preemption ───────────────────────────────────────────────────────

    def install_signal_handlers(self) -> None:
        """SIGTERM → emergency checkpoint at the next optimizer step.

        The handler only sets a flag; the loop acts at its next host-sync
        point, writes the checkpoint and raises ``TrainingPreempted``.
        Opt-in (the train CLI calls it): library users and tests keep their
        signal table.
        """

        def _on_term(signum, frame):  # noqa: ARG001 — signal signature
            self._preempt_requested = True

        signal.signal(signal.SIGTERM, _on_term)
        self._preempt_installed = True

    def _maybe_preempt(self) -> None:
        if not self._preempt_installed or not self._preempt_requested:
            return
        self.logger.warning(
            "SIGTERM received — emergency checkpoint at step %d", self.global_step)
        self.save_checkpoint(loss=None)
        self.checkpoint_manager.wait()
        raise TrainingPreempted(f"preempted; checkpoint written at step {self.global_step}")

    # ── the loop ─────────────────────────────────────────────────────────

    def train(self, num_epochs: int, save_interval: int = 5) -> None:
        self.logger.info(
            f"Training: epochs {self.epoch}→{num_epochs}, grad_accum={self.grad_accum}, "
            f"device={self.device}")
        start_epoch, train_start = self.epoch, time.monotonic()
        for _ in range(self.epoch, num_epochs):
            sampler = getattr(self.train_loader, "batch_sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(self.epoch)
            avg_loss = self.train_epoch(total_epochs=num_epochs)
            val_loss = self.validate(use_ema=True)
            self._log_audio_samples(self.epoch)
            is_best = 0 < val_loss < self._best_val
            if is_best:
                self._best_val = val_loss

            elapsed = time.monotonic() - train_start
            done = self.epoch - start_epoch
            remaining = elapsed / done * (num_epochs - self.epoch) if done else 0.0
            eta_h, eta_s = divmod(int(remaining), 3600)
            lr = self.schedule(self.global_step)
            val_str = f" | val_loss={val_loss:.4f}" if val_loss > 0 else ""
            self.logger.info(
                f"Epoch {self.epoch}/{num_epochs} | avg_loss={avg_loss:.4f}{val_str} | "
                f"lr={lr:.2e} | ETA={eta_h}h{eta_s // 60:02d}m")
            if self.writer:
                self.writer.add_scalar("epoch/train_loss", avg_loss, self.epoch)
                if val_loss > 0:
                    self.writer.add_scalar("epoch/val_loss", val_loss, self.epoch)
                self.writer.add_scalar("epoch/lr", lr, self.epoch)
                self.writer.flush()

            if self.epoch % save_interval == 0:
                self.save_checkpoint(is_best=is_best, loss=avg_loss)
            elif is_best and self.config.get("save_best_between_intervals", True):
                # a best epoch between intervals still reaches disk:
                # f5tts_best.npz only, no step file, no rotation
                self.checkpoint_manager.save_best(**self._checkpoint_trees(avg_loss))
        self.finish()

    def finish(self) -> None:
        self.checkpoint_manager.wait()  # surface a writer failure
        if self.writer:
            self.writer.flush()
            self.writer.close()
            self.writer = None
        self._sync_working_set(self.state.params)
        self.model.params_loaded = True

    # ── checkpointing ────────────────────────────────────────────────────

    def _flax_tree(self, tensors: list[torch.Tensor]) -> dict[str, Any]:
        return to_flax_params(dict(zip(self.state.names, tensors)))

    def _checkpoint_trees(self, loss: float | None) -> dict[str, Any]:
        st = self.state
        return {
            "step": self.global_step,
            "params": self._flax_tree(st.params),
            "opt_state": {
                "mu": self._flax_tree(st.mu), "nu": self._flax_tree(st.nu),
                "count": np.asarray(st.count, np.int32),
                "mu_bf16": st.mu[0].dtype == torch.bfloat16,
            },
            "ema_params": self._flax_tree(st.ema),
            "loss": loss,
            "config": self.config,
            "extra_state": {"epoch": self.epoch, "best_val": self._best_val},
        }

    @torch.no_grad()
    def set_params(self, flax_params: dict[str, Any]) -> None:
        """Start from a flax-layout tree: masters and EMA in full f32.

        ``F5TTS.load_params`` alone would leave the masters at the working
        set's precision; pretrained weights come through here.
        """
        flat = from_flax_params(flax_params)
        for name, p, e in zip(self.state.names, self.state.params, self.state.ema):
            p.copy_(flat[name].to(p.device))
            e.copy_(p)
        self._sync_working_set(self.state.params)
        self.model.params_loaded = True

    def save_checkpoint(self, is_best: bool = False, loss: float | None = None) -> Path:
        return self.checkpoint_manager.save(is_best=is_best, **self._checkpoint_trees(loss))

    @torch.no_grad()
    def load_checkpoint(self, path: str | Path | None = None, load_best: bool = False) -> None:
        info = self.checkpoint_manager.load(path=path, load_best=load_best)
        if info.get("params") is None:
            self.logger.info("No checkpoint found — starting fresh")
            return
        step = int(info.get("step", 0))
        self.epoch = int(info.get("epoch", 0))
        best = info.get("best_val")
        self._best_val = float(best) if best is not None else float("inf")
        st = self.state

        def fill(dst: list[torch.Tensor], tree: dict[str, Any]) -> None:
            flat = from_flax_params(tree)
            for name, d in zip(st.names, dst):
                d.copy_(flat[name].to(d.device))

        fill(st.params, info["params"])
        fill(st.ema, info["ema"] if info.get("ema") is not None else info["params"])
        opt = info.get("opt")
        if isinstance(opt, dict) and "mu" in opt and "nu" in opt:
            fill(st.mu, opt["mu"])
            fill(st.nu, opt["nu"])
            st.count = int(opt.get("count", step))
        else:
            if opt is not None:
                self.logger.warning(
                    "The checkpoint's optimizer state is not in this package's "
                    "layout (opt/mu, opt/nu, opt/count); the moments start at zero")
            for t in st.mu + st.nu:
                t.zero_()
            st.count = step
        st.step = st.ema_updates = step
        self._sync_working_set(st.params)
        self.model.params_loaded = True
        self.logger.info("Resumed from step %d (epoch %d)", self.global_step, self.epoch)
