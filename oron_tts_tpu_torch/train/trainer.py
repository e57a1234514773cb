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

With ``hub_repo_id`` the checkpoint directory is mirrored to a HuggingFace
model repository after every ``hub_upload_interval``-th interval save
(``CheckpointManager.push_to_hub``; a failed upload is logged and training
goes on). Not ported: the XLA-specific machinery (AOT layouts, relayout,
the compilation cache).

Mesh (``mesh=``, or the model's ``set_mesh``; ``parallel/mesh.py``). Each
rank trains its shards: the masters, moments and EMA of the attention and
FFN projections are this rank's Megatron slices. After the backward the
gradients are summed over the data group in buckets of one flat buffer
(``CFM.loss`` gives each rank its share of the global loss's gradient), and
the clip uses the global norm: squares of model-sharded tensors summed over
the model group, replicated ones counted once, so ``ok``, the clip and the
skip agree on every rank by construction. With ``shard_opt_states: true``
(ZeRO-1) the moments of a tensor hold only this data rank's block along the
axis ``opt_specs`` names: the gradients are reduce-scattered into those
blocks in flat buckets, each rank updates its block of the masters, and the blocks are
all-gathered back; the EMA stays whole, as in the JAX trainer. Across ranks:
the host-side mel guard is off (a one-sided skip would deadlock the step's
collectives; a non-finite mel makes a non-finite loss, which the guard
skips on every rank alike), validation sums ``(total, n)`` over all ranks,
the SIGTERM flag is agreed at every optimizer step, and only rank 0 logs at
INFO, writes TensorBoard, saves and pushes. ``save_checkpoint`` gathers the
shards on every rank (a collective) before rank 0 writes the single-process
layout; ``load_checkpoint`` reads on rank 0 and broadcasts the step, epoch,
best loss and the trees by path, and every rank keeps its shards.
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
from oron_tts_tpu_torch.parallel import mesh as pmesh
from oron_tts_tpu_torch.train.checkpoint import CheckpointManager, flatten_tree, unflatten_tree
from oron_tts_tpu_torch.utils import trace
from oron_tts_tpu_torch.utils.weights import from_flax_params, to_flax_params

GRAD_BUCKET_ELEMENTS = 1 << 26  # f32 elements one gradient all-reduce carries (256 MB)


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


def _optax_adam_state(opt: Any) -> list | None:
    """``[count, mu, nu]`` of the ``ScaleByAdamState`` in a JAX checkpoint's opt tree.

    The JAX trainer's ``optax.chain(clip_by_global_norm, adamw)`` state is
    nested tuples of NamedTuples, which ``checkpoint.flatten_tree`` writes
    under positional ``#i`` keys and ``unflatten_tree`` reads back as lists
    (empty states leave no entry). The Adam state is the one list of a
    scalar count and two parameter trees; None when there is none.
    """
    if not isinstance(opt, list):
        return None
    if (len(opt) == 3 and np.ndim(opt[0]) == 0 and isinstance(opt[1], dict)
            and isinstance(opt[2], dict)):
        return opt
    for node in opt:
        found = _optax_adam_state(node)
        if found is not None:
            return found
    return None


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
        # moments just read from a checkpoint: the next update scales mu by b1
        # in f32, as the JAX trainer's first step after a resume does (its
        # restored moments are numpy arrays, whose product with b1 is not
        # rounded to bf16)
        self.resumed = False


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
    params: list[torch.Tensor] | None = None,
    after_update: Callable[[], None] | None = None,
) -> tuple[float, bool]:
    """Clip, AdamW, EMA, all skipped when the step is not finite.

    ``grads`` are f32 and may be modified. Returns (grad_norm, ok); when
    ``ok`` is false nothing in ``state`` has changed. Mirrors the JAX
    package's ``_guarded_update`` over ``optax.chain(clip_by_global_norm,
    adamw)``. ``params`` are the views of the masters the update writes
    (ZeRO-1: this rank's blocks, which ``grads`` and the moments match);
    ``after_update`` runs before the EMA reads the masters.
    """
    if grad_norm is None:
        grad_norm = float(torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads))))
    ok = math.isfinite(grad_norm) and bool(extra_ok)
    exact_b1, state.resumed = state.resumed, False
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

    for p, g, m, v in zip(state.params if params is None else params, grads, state.mu,
                          state.nu):
        if clip:
            g = (g / grad_norm) * max_grad_norm
        mu = g * (1.0 - b1)
        if m.dtype == torch.float32 or exact_b1:
            mu.add_(m.float() * b1)
        else:
            mu.add_((m * b1_lp).float())
        v.mul_(b2).add_((g * g).mul_(1.0 - b2))
        update = (mu / bc1).div_((v / bc2).sqrt_().add_(eps))
        update.add_(p, alpha=weight_decay)
        p.add_(update.mul_(-lr))
        m.copy_(mu)
    if after_update is not None:
        after_update()
    for p, e in zip(state.params, state.ema):
        e.mul_(decay).add_(p * one_minus_decay)
    state.count = count_inc
    state.step += 1
    state.ema_updates += 1
    return grad_norm, True


class TrainingPreempted(RuntimeError):
    """Raised after the emergency checkpoint when SIGTERM interrupted
    training. The checkpoint is already on disk when this propagates."""


class F5Trainer:
    """Trainer facade with the JAX package's constructor arguments. It trains
    where ``model`` lives, and ``F5TTS`` refuses a silent CPU, so there is no
    device argument here. Without a mesh the one process is the main one;
    under a mesh rank 0 is, and it alone writes the logs and checkpoints and
    pushes to the hub.
    """

    def __init__(
        self,
        config: dict[str, Any],
        model: F5TTS,
        train_loader: Any,
        val_loader: Any | None = None,
        log_dir: str = "logs",
        checkpoint_dir: str = "checkpoints",
        hub_repo_id: str | None = None,
        hub_token: str | None = None,
        hub_private: bool = False,
        hub_upload_interval: int = 1,
        mesh: pmesh.Mesh | None = None,
    ) -> None:
        self.config = config
        self.model = model
        if mesh is not None and model.mesh is not mesh:
            model.set_mesh(mesh)
        self.mesh = model.mesh
        self.is_main_process = self.mesh is None or self.mesh.is_main
        self.device = model.device
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.log_dir = log_dir
        self.hub_repo_id, self.hub_token, self.hub_private = hub_repo_id, hub_token, hub_private
        self.hub_upload_interval = max(1, hub_upload_interval)
        self._upload_count = 0

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
        mesh = self.mesh
        self.specs = [pmesh.spec_for_name(n) for n in self.state.names]
        self.model_sharded = [mesh is not None and mesh.n_model > 1 and "model" in spec
                              for spec in self.specs]
        # ZeRO-1: the axis of each moment split over "data" (None: whole)
        self.zero_axes: list[int | None] = [None] * len(masters)
        self.zero_specs: list[tuple] = list(self.specs)
        if config.get("shard_opt_states", False) and mesh is not None and mesh.n_data > 1:
            ospecs = pmesh.opt_specs(
                {n: tuple(p.shape) for n, p in zip(self.state.names, masters)}, mesh.n_data)
            self.zero_specs = [ospecs[n] for n in self.state.names]
            self.zero_axes = [pmesh.axis_of(sp, "data") for sp in self.zero_specs]
            st = self.state
            for i, a in enumerate(self.zero_axes):
                if a is not None:
                    st.mu[i] = pmesh.shard_tensor(st.mu[i], self.zero_specs[i], mesh, "data")
                    st.nu[i] = pmesh.shard_tensor(st.nu[i], self.zero_specs[i], mesh, "data")
        self.zero = any(a is not None for a in self.zero_axes)

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
        logger.setLevel(logging.INFO if self.is_main_process else logging.WARNING)
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
            self._tensorboard = False
            self.logger.warning("tensorboardX not installed — console logging only")
            return None
        # every rank knows whether rank 0 writes, so all join its audio syntheses
        self._tensorboard = True
        if not self.is_main_process:
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

    # ── the mesh's collectives ───────────────────────────────────────────

    def _all_reduce_flat(self, tensors: list[torch.Tensor], group) -> None:
        """Sum ``tensors`` in place over ``group``, in flat buckets."""
        bucket: list[torch.Tensor] = []

        def flush() -> None:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            pmesh.all_reduce_sum(flat, group)
            for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(part.view_as(t))
            bucket.clear()

        size = 0
        for t in tensors:
            bucket.append(t)
            size += t.numel()
            if size >= GRAD_BUCKET_ELEMENTS:
                flush()
                size = 0
        if bucket:
            flush()

    def _reduce_grads(self, grads: list[torch.Tensor]) -> None:
        """Sum the gradients over the data group, in place in ``grads``.

        Under ZeRO-1 a split tensor's entry becomes this rank's block,
        reduce-scattered in flat buckets; the whole gradient is dropped as its
        bucket is done, so the blocks never coexist with all the whole ones.
        """
        mesh = self.mesh
        if mesh is None or mesh.data_group is None:
            return
        whole = [g for g, a in zip(grads, self.zero_axes) if a is None]
        if whole:
            self._all_reduce_flat(whole, mesh.data_group)
        n, bucket = mesh.n_data, []

        def flush() -> None:
            moved = [grads[i].movedim(self.zero_axes[i], 0) for i in bucket]
            # [n, k]: row d holds block d of every tensor, so rank d's chunk is its blocks
            flat = torch.cat([m.reshape(n, -1) for m in moved], dim=1).reshape(-1)
            mine = pmesh.reduce_scatter_flat(flat, mesh.data_group)
            for i, m, part in zip(bucket, moved, mine.split([m.numel() // n for m in moved])):
                block = part.view(m.shape[0] // n, *m.shape[1:])
                grads[i] = block.movedim(0, self.zero_axes[i]).contiguous()
            bucket.clear()

        size = 0
        for i, a in enumerate(self.zero_axes):
            if a is None:
                continue
            bucket.append(i)
            size += grads[i].numel()
            if size >= GRAD_BUCKET_ELEMENTS:
                flush()
                size = 0
        if bucket:
            flush()

    def _grad_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm (device scalar).

        Without TP or ZeRO-1 every rank holds whole summed gradients and the
        single-process formula applies. Otherwise squares of ZeRO-1 blocks are
        summed over the data group, those of model-sharded tensors over the
        model group, and replicated tensors count once.
        """
        mesh = self.mesh
        if mesh is None or not (self.zero or mesh.n_model > 1):
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        sq = torch.stack([n.float() ** 2 for n in torch._foreach_norm(grads)])
        zero = torch.tensor([a is not None for a in self.zero_axes], device=sq.device)
        msh = torch.tensor(self.model_sharded, device=sq.device)
        parts = torch.stack([(sq * (zero & msh)).sum(), (sq * (zero & ~msh)).sum()])
        if self.zero:
            pmesh.all_reduce_sum(parts, mesh.data_group)
        sharded = parts[0] + (sq * (~zero & msh)).sum()
        sharded = pmesh.all_reduce_sum(sharded.reshape(1), mesh.model_group)[0]
        return torch.sqrt(sharded + parts[1] + (sq * (~zero & ~msh)).sum())

    def _zero_views(self) -> list[torch.Tensor] | None:
        """ZeRO-1: views of this rank's blocks of the masters (None: whole tensors)."""
        if not self.zero:
            return None
        mesh, views = self.mesh, []
        for p, a in zip(self.state.params, self.zero_axes):
            if a is None:
                views.append(p)
            else:
                size = p.shape[a] // mesh.n_data
                views.append(p.narrow(a, mesh.data_rank * size, size))
        return views

    def _gather_zero_params(self) -> None:
        """ZeRO-1: every rank's updated blocks of the masters, gathered back."""
        mesh = self.mesh
        for p, a, spec in zip(self.state.params, self.zero_axes, self.zero_specs):
            if a is not None:
                size = p.shape[a] // mesh.n_data
                block = p.narrow(a, mesh.data_rank * size, size)
                p.copy_(pmesh.gather_tensor(block, spec, mesh, "data"))

    def _agreed(self, flag: bool) -> bool:
        """True on every rank when it is true on any (a collective over all ranks)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(pmesh.all_reduce_sum(t, self.mesh.world_group).item() > 0)

    def _loss_and_grads(self, batch, generator) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Training loss (device scalar, not read) and f32 gradients."""
        step = self.state.step
        with trace.span("train.h2d", step=step):
            b = self._to_device(batch)
        with trace.span("train.forward", step=step):
            loss = self.model.cfm.loss(
                b["mel"], b["text_ids"], b["mel_lengths"], generator, train=True)
        with trace.span("train.backward", step=step):
            loss.backward()
        with trace.span("train.grads", step=step):
            grads = []
            for p in self.work:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                grads.append(g.float())
                p.grad = None
        return loss.detach(), grads

    def _apply(self, grads, loss: torch.Tensor, extra_ok: torch.Tensor | None = None) -> dict:
        """One guarded update; the step's single host read happens here."""
        self._reduce_grads(grads)
        step = self.state.step
        with trace.span("train.read", step=step):
            norm = self._grad_norm(grads)
            flag = torch.ones((), device=norm.device) if extra_ok is None else extra_ok.float()
            loss_v, norm_v, flag_v = torch.stack([loss.float(), norm.float(), flag]).tolist()
        with trace.span("train.update", step=step):
            _, ok = guarded_update(
                self.state, grads, self.schedule, self.ema_decay, betas=self.betas,
                weight_decay=self.weight_decay, max_grad_norm=self.max_grad_norm,
                extra_ok=math.isfinite(loss_v) and flag_v > 0.5, grad_norm=norm_v,
                params=self._zero_views(),
                after_update=self._gather_zero_params if self.zero else None,
            )
            if ok:
                self._sync_working_set(self.state.params)
        return {"loss": loss_v, "grad_norm": norm_v, "ok": ok}

    def train_step(self, batch: dict[str, np.ndarray], generator: torch.Generator) -> dict:
        """Fused step: loss, gradients, guarded update. Returns host metrics."""
        with trace.span("train.step", step=self.state.step) as sp:
            if sp is not None:
                mel = np.asarray(batch["mel"])
                sp.update(rows=int(mel.shape[0]),
                          frames_kept=int(np.asarray(batch["mel_lengths"]).sum()),
                          frames_collated=int(mel.shape[0] * mel.shape[2]))
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
        # the host-side mel guard only in one process: a rank-local skip would
        # deadlock the step's collectives
        one_process = self.mesh is None or self.mesh.world == 1
        for accum_step, batch in enumerate(iterator):
            if one_process and not np.isfinite(batch["mel"]).all():
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
        if self.mesh is not None:  # agreed over every rank (a collective)
            sums = torch.zeros(2, device=self.device)
            if losses:
                sums[0], sums[1] = torch.stack(losses).sum(), len(losses)
            total, n = pmesh.all_reduce_sum(sums, self.mesh.world_group).tolist()
            return total / n if n else 0.0
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean())  # one host read

    def _log_audio_samples(self, epoch: int) -> None:
        # every rank joins a sharded model's syntheses; rank 0 writes them
        if not self._tensorboard or epoch % self.config.get("audio_sample_interval", 10) != 0:
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
                    if self.writer:
                        self.writer.add_audio(
                            f"audio/{tag}", wav[None, :], epoch,
                            sample_rate=self.model.sample_rate)
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
        # agreed over all ranks: a SIGTERM that reached one rank stops them all
        if not self._preempt_installed or not self._agreed(self._preempt_requested):
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
                self._maybe_push_to_hub()
            elif is_best and self.config.get("save_best_between_intervals", True):
                # a best epoch between intervals still reaches disk:
                # f5tts_best.npz only, no step file, no rotation
                trees = self._checkpoint_trees(avg_loss)  # a collective under a mesh
                if self.is_main_process:
                    self.checkpoint_manager.save_best(**trees)
        self.finish()

    def finish(self) -> None:
        self.checkpoint_manager.wait()  # surface a writer failure
        if self.writer:
            self.writer.flush()
            self.writer.close()
            self.writer = None
        self._sync_working_set(self.state.params)
        self.model.params_loaded = True

    # ── hub ──────────────────────────────────────────────────────────────

    def _maybe_push_to_hub(self) -> None:
        if self.hub_repo_id is None or not self.is_main_process:
            return
        self._upload_count += 1
        if self._upload_count < self.hub_upload_interval:
            return
        self._upload_count = 0
        try:
            url = self.push_to_hub(self.hub_repo_id, token=self.hub_token,
                                   private=self.hub_private)
            self.logger.info("Uploaded checkpoints and logs to %s", url)
        except Exception as exc:  # an upload failure must not stop training
            self.logger.warning("HuggingFace upload failed: %s", exc, exc_info=True)

    def push_to_hub(self, repo_id: str, token: str | None = None, private: bool = False) -> str:
        if self.writer:
            self.writer.flush()
        return self.checkpoint_manager.push_to_hub(
            repo_id, token=token, private=private, log_dir=self.log_dir)

    # ── checkpointing ────────────────────────────────────────────────────

    def _flax_tree(self, tensors: list[torch.Tensor], moments: bool = False) -> dict[str, Any]:
        """A flax-layout tree of whole tensors: under a mesh the shards (and,
        for ``moments``, the ZeRO-1 blocks) are gathered first, a collective."""
        mesh = self.mesh
        if mesh is not None:
            whole = []
            for i, t in enumerate(tensors):
                if moments and self.zero_axes[i] is not None:
                    t = pmesh.gather_tensor(t, self.zero_specs[i], mesh, "data")
                whole.append(pmesh.gather_tensor(t, self.specs[i], mesh, "model").cpu())
            tensors = whole
        return to_flax_params(dict(zip(self.state.names, tensors)))

    def _checkpoint_trees(self, loss: float | None) -> dict[str, Any]:
        st = self.state
        return {
            "step": self.global_step,
            "params": self._flax_tree(st.params),
            "opt_state": {
                "mu": self._flax_tree(st.mu, moments=True),
                "nu": self._flax_tree(st.nu, moments=True),
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
        for i, (name, p, e) in enumerate(zip(self.state.names, self.state.params,
                                             self.state.ema)):
            p.copy_(self._local(flat[name], i).to(p.device))
            e.copy_(p)
        self._sync_working_set(self.state.params)
        self.model.params_loaded = True

    def _local(self, whole: torch.Tensor, i: int, moment: bool = False) -> torch.Tensor:
        """This rank's part of tensor ``i`` given whole: its TP shard (and ZeRO-1 block)."""
        if self.mesh is None:
            return whole
        t = pmesh.shard_tensor(whole, self.specs[i], self.mesh, "model")
        if moment and self.zero_axes[i] is not None:
            t = pmesh.shard_tensor(t, self.zero_specs[i], self.mesh, "data")
        return t

    def save_checkpoint(self, is_best: bool = False, loss: float | None = None) -> Path | None:
        # the gather is a collective under a mesh: every rank, before the rank gate
        trees = self._checkpoint_trees(loss)
        if not self.is_main_process:
            return None
        return self.checkpoint_manager.save(is_best=is_best, **trees)

    def _sync_checkpoint_from_main(self, info: dict[str, Any]) -> dict[str, Any]:
        """Rank 0's checkpoint on every rank (a collective; every rank calls it).

        Only rank 0 reads (and writes) files. ``(found, step, epoch, best)``
        goes first; the trees follow by path, in their flat on-disk form.
        """
        mesh = self.mesh
        meta = {k: info.get(k) for k in ("step", "epoch", "best_val")}
        meta["found"] = info.get("params") is not None
        meta = pmesh.broadcast_tree(meta if mesh.is_main else None, device=mesh.device)
        if not meta["found"]:
            return {"params": None}
        out = dict(meta)
        for key in ("params", "ema", "opt"):
            has = pmesh.broadcast_tree(info.get(key) is not None if mesh.is_main else None,
                                       device=mesh.device)
            if not has:
                out[key] = None
                continue
            flat = (dict(sorted(flatten_tree(info[key]).items())) if mesh.is_main else None)
            out[key] = unflatten_tree(pmesh.broadcast_tree(flat, device=mesh.device))
        return out

    @torch.no_grad()
    def load_checkpoint(self, path: str | Path | None = None, load_best: bool = False) -> None:
        if self.mesh is not None and self.mesh.world > 1:
            info = (self.checkpoint_manager.load(path=path, load_best=load_best)
                    if self.is_main_process else {})
            info = self._sync_checkpoint_from_main(info)
        else:
            info = self.checkpoint_manager.load(path=path, load_best=load_best)
        if info.get("params") is None:
            self.logger.info("No checkpoint found — starting fresh")
            return
        step = int(info.get("step", 0))
        self.epoch = int(info.get("epoch", 0))
        best = info.get("best_val")
        self._best_val = float(best) if best is not None else float("inf")
        st = self.state

        def fill(dst: list[torch.Tensor], tree: dict[str, Any], moment: bool = False) -> None:
            flat = from_flax_params(tree)
            for i, (name, d) in enumerate(zip(st.names, dst)):
                d.copy_(self._local(flat[name], i, moment).to(d.device))

        fill(st.params, info["params"])
        fill(st.ema, info["ema"] if info.get("ema") is not None else info["params"])
        opt = info.get("opt")
        adam = _optax_adam_state(opt)
        if isinstance(opt, dict) and "mu" in opt and "nu" in opt:
            fill(st.mu, opt["mu"], moment=True)
            fill(st.nu, opt["nu"], moment=True)
            st.count = int(opt.get("count", step))
            st.resumed = True
        elif adam is not None:  # the JAX package's optax tree
            count, mu, nu = adam
            fill(st.mu, mu, moment=True)
            fill(st.nu, nu, moment=True)
            st.count = int(count)
            st.resumed = True
        else:
            if opt is not None:
                self.logger.warning(
                    "The checkpoint's optimizer state is in neither this package's "
                    "layout (opt/mu, opt/nu, opt/count) nor optax's; the moments "
                    "start at zero")
            for t in st.mu + st.nu:
                t.zero_()
            st.count = step
        st.step = st.ema_updates = step
        self._sync_working_set(st.params)
        self.model.params_loaded = True
        self.logger.info("Resumed from step %d (epoch %d)", self.global_step, self.epoch)
