"""The trainer's AdamW + EMA + working copy: one multi-tensor CUDA kernel, its plain version.

:func:`adamw_ema` applies one optimizer step to every leaf: the clip (when
the host decided to clip), AdamW on the f32 masters with the first moment
``mu`` (bf16 or f32) and the f32 second moment ``nu``, the f32 EMA of the new
masters, and the masters' cast into the model's working parameters.

- CUDA tensors launch ``csrc/fused_adamw_ema.cu`` over all leaves at once
  (replaces no TPU kernel: XLA fuses optax's update for the JAX package), or
  raise.
- CPU tensors take :func:`adamw_ema_plain`, the eager tensor ops after
  optax's ``adamw`` that the kernel repeats rounding for rounding.

A launch reads a table of leaf descriptors (:func:`leaf_table`: addresses,
size, the master's layout, first chunk, flags) that is copied to the device
through pinned memory, without a synchronisation. The master a leaf writes
may be a strided view: ZeRO-1's block of it along any axis (``params``). Then
the AdamW half runs on the views, ``after_update`` gathers the masters, and a
second launch takes the EMA and the working copy from the whole masters.
Each call adds to the tracer's ``update.fused_leaves`` (leaves) and
``update.fused_launches`` (1 or 2) counters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from oron_tts_tpu_torch.utils import trace

CHUNK = 16384  # elements of one leaf a block takes (a multiple of 4)
LEAF_FIELDS = ("p", "g", "m", "v", "e", "w", "n", "run", "stride", "chunk0", "flags")
VEC, M_BF16, W_BF16 = 1, 2, 4     # a leaf's flags
CLIP, MU_EXACT, ADAM, EMA = 1, 2, 4, 8  # a launch's flags


@dataclasses.dataclass(frozen=True)
class Step:
    """One update's scalars, as Python floats (``lr``, ``bc1``, ``bc2``,
    ``decay`` and ``one_minus_decay`` already rounded to f32)."""

    lr: float
    betas: tuple[float, float]
    eps: float
    weight_decay: float
    bc1: float              # 1 − b1^t
    bc2: float              # 1 − b2^t
    decay: float            # the EMA's decay this step
    one_minus_decay: float
    max_grad_norm: float
    clip_norm: float | None = None  # the global norm to clip by; None: no clip
    exact_b1: bool = False  # a bf16 mu times b1 in f32 (the first step after a resume)


def _bf16(b1: float) -> float:
    """b1 as optax multiplies a bf16 moment by it: rounded to bf16 too."""
    return float(torch.tensor(b1).to(torch.bfloat16))


@torch.no_grad()
def adamw_ema_plain(masters: list[torch.Tensor], grads: list[torch.Tensor],
                    mu: list[torch.Tensor], nu: list[torch.Tensor], ema: list[torch.Tensor],
                    work: list[torch.Tensor] | None, step: Step,
                    params: list[torch.Tensor] | None = None,
                    after_update: Callable[[], None] | None = None) -> None:
    """The update in eager tensor ops, on any device; ``grads`` may be modified."""
    b1, b2 = step.betas
    b1_lp = _bf16(b1)
    for p, g, m, v in zip(masters if params is None else params, grads, mu, nu):
        if step.clip_norm is not None:
            g = (g / step.clip_norm) * step.max_grad_norm
        new_mu = g * (1.0 - b1)
        if m.dtype == torch.float32 or step.exact_b1:
            new_mu.add_(m.float() * b1)
        else:
            new_mu.add_((m * b1_lp).float())
        v.mul_(b2).add_((g * g).mul_(1.0 - b2))
        update = (new_mu / step.bc1).div_((v / step.bc2).sqrt_().add_(step.eps))
        update.add_(p, alpha=step.weight_decay)
        p.add_(update.mul_(-step.lr))
        m.copy_(new_mu)
    if after_update is not None:
        after_update()
    for p, e in zip(masters, ema):
        e.mul_(step.decay).add_(p * step.one_minus_decay)
    for w, p in zip(work or (), masters):
        w.copy_(p)


def master_layout(t: torch.Tensor) -> tuple[int, int]:
    """``(run, stride)``: element ``i`` of ``t`` in row-major order lies ``(i // run)
    · stride + i % run`` elements after ``t.data_ptr()``. A narrowed view of a
    contiguous tensor along any axis has this form; another layout raises."""
    n = t.numel()
    if t.is_contiguous():
        return n, n
    dims = [(s, st) for s, st in zip(t.shape, t.stride()) if s != 1]
    run, k = 1, len(dims) - 1
    while k >= 0 and dims[k][1] == run:
        run *= dims[k][0]
        k -= 1
    if k < 0:
        return n, n
    stride = dims[k][1]
    if stride < run:
        raise ValueError(f"fused_adamw_ema: overlapping runs (strides {t.stride()})")
    for j in range(k):
        if dims[j][1] != dims[j + 1][1] * dims[j + 1][0]:
            raise ValueError(f"fused_adamw_ema: a master of shape {tuple(t.shape)} and strides "
                             f"{t.stride()} is not runs of one stride")
    return run, stride


def _ptrs(ts: list[torch.Tensor] | None, n: int) -> np.ndarray:
    if ts is None:
        return np.zeros(n, np.int64)
    return np.fromiter(map(torch.Tensor.data_ptr, ts), np.int64, n)


def leaf_table(p: list[torch.Tensor], g: list[torch.Tensor] | None,
               m: list[torch.Tensor] | None, v: list[torch.Tensor] | None,
               e: list[torch.Tensor] | None, w: list[torch.Tensor] | None,
               chunk: int = CHUNK) -> tuple[np.ndarray, int]:
    """The launch's table, int64 ``[leaves, len(LEAF_FIELDS)]``, and its chunks.

    ``p`` are the masters a launch reads and writes (views allowed); ``g``,
    ``m``, ``v`` are given for the AdamW half and ``e``, ``w`` for the EMA
    half, each contiguous and shaped as its ``p``. A leaf takes the vector
    path where every address is 16-byte aligned (8 for a bf16 tensor) and a
    strided master's run and stride are multiples of 4.
    """
    n_leaves = len(p)
    shapes = [t.shape for t in p]
    for name, ts in (("g", g), ("m", m), ("v", v), ("e", e), ("w", w)):
        if ts is None:
            continue
        if len(ts) != n_leaves:
            raise ValueError(f"fused_adamw_ema: {len(ts)} {name} for {n_leaves} masters")
        if [t.shape for t in ts] != shapes or not all(map(torch.Tensor.is_contiguous, ts)):
            a, b = next((a, b) for a, b in zip(ts, p)
                        if a.shape != b.shape or not a.is_contiguous())
            raise ValueError(f"fused_adamw_ema: {name} of shape {tuple(a.shape)} "
                             f"(contiguous: {a.is_contiguous()}) for a master of shape "
                             f"{tuple(b.shape)}")
    table = np.zeros((n_leaves, len(LEAF_FIELDS)), np.int64)
    cols = {f: table[:, i] for i, f in enumerate(LEAF_FIELDS)}
    for f, ts in (("p", p), ("g", g), ("m", m), ("v", v), ("e", e), ("w", w)):
        cols[f][:] = _ptrs(ts, n_leaves)
    n = np.fromiter(map(torch.Tensor.numel, p), np.int64, n_leaves)
    cols["n"][:] = n
    cols["run"][:] = n
    cols["stride"][:] = n
    for i, whole in enumerate(map(torch.Tensor.is_contiguous, p)):
        if not whole:
            cols["run"][i], cols["stride"][i] = master_layout(p[i])
    chunks = -(-n // chunk)
    cols["chunk0"][:] = np.cumsum(chunks) - chunks
    bf16 = {f: np.array([t.dtype == torch.bfloat16 for t in ts], bool) if ts is not None
            else np.zeros(n_leaves, bool) for f, ts in (("m", m), ("w", w))}
    aligned = np.ones(n_leaves, bool)
    for f in ("p", "g", "v", "e"):
        aligned &= cols[f] % 16 == 0
    for f in ("m", "w"):
        aligned &= cols[f] % np.where(bf16[f], 8, 16) == 0
    whole = cols["run"] == n
    aligned &= whole | ((cols["run"] % 4 == 0) & (cols["stride"] % 4 == 0))
    cols["flags"][:] = aligned * VEC + bf16["m"] * M_BF16 + bf16["w"] * W_BF16
    return table, int(chunks.sum())


def _check(name: str, ts: list[torch.Tensor], dtypes: tuple, device: torch.device) -> None:
    index = -1 if device.type == "cpu" else device.index
    found = set(map(torch.Tensor.get_device, ts))
    if found - {index} or {t.dtype for t in ts} - set(dtypes):
        raise ValueError(f"fused_adamw_ema: {name} on devices {sorted(found)} in "
                         f"{sorted(map(str, {t.dtype for t in ts}))}; it takes "
                         f"{' or '.join(map(str, dtypes))} on {device}")


def _launch(table: np.ndarray, n_chunks: int, step: Step, flags: int,
            device: torch.device) -> None:
    import ctypes

    from oron_tts_tpu_torch.ops import _build

    host = torch.empty(table.size, dtype=torch.int64, pin_memory=True)
    host.numpy()[:] = table.reshape(-1)
    # the caching host allocator keeps ``host`` from reuse until this copy is done
    dev_table = host.to(device, non_blocking=True)
    f32 = np.float32
    b1, b2 = step.betas
    clip = step.clip_norm is not None
    scalars = (
        -step.lr, b1, _bf16(b1), 1.0 - b1, b2, 1.0 - b2,
        float(f32(1) / f32(step.bc1)), float(f32(1) / f32(step.bc2)), step.eps,
        step.weight_decay, step.decay, step.one_minus_decay,
        float(f32(1) / f32(step.clip_norm)) if clip else 1.0, step.max_grad_norm,
    )
    flags |= (CLIP if clip else 0) | (MU_EXACT if step.exact_b1 else 0)
    lib = _build.load("fused_adamw_ema")
    err = lib.fused_adamw_ema(
        dev_table.data_ptr(), table.shape[0], CHUNK, n_chunks,
        *(ctypes.c_float(x) for x in scalars), flags, _build.stream_ptr(device))
    _build.check(err, "fused_adamw_ema")
    adamw_ema.launches += 1


def adamw_ema(masters: list[torch.Tensor], grads: list[torch.Tensor], mu: list[torch.Tensor],
              nu: list[torch.Tensor], ema: list[torch.Tensor], work: list[torch.Tensor] | None,
              step: Step, params: list[torch.Tensor] | None = None,
              after_update: Callable[[], None] | None = None) -> None:
    """One update of every leaf; the kernel on CUDA, the plain version on CPU.

    ``params`` are the views of the masters the AdamW half writes (ZeRO-1:
    this rank's blocks, which ``grads``, ``mu`` and ``nu`` match) and
    ``after_update`` runs before the EMA reads the masters; with either the
    kernel launches twice.
    """
    if not masters:
        return
    device = masters[0].device
    if device.type == "cpu":
        adamw_ema_plain(masters, grads, mu, nu, ema, work, step, params, after_update)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_adamw_ema: unsupported device {device}")
    _fused(masters, grads, mu, nu, ema, work, step, params, after_update, device)


def _fused(masters, grads, mu, nu, ema, work, step: Step, params, after_update,
           device: torch.device) -> None:
    """The kernel's launches: checks, tables, one launch or the split pair, counters."""
    if work is None:
        raise ValueError("fused_adamw_ema: the kernel writes the working parameters; pass work")
    f32, lp = (torch.float32,), (torch.bfloat16, torch.float32)
    views = masters if params is None else params
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    for name, ts, dtypes in (("master", masters, f32), ("view", params or [], f32),
                             ("grad", grads, f32), ("mu", mu, lp), ("nu", nu, f32),
                             ("ema", ema, f32), ("work", work, lp)):
        _check(name, ts, dtypes, device)
    split = params is not None or after_update is not None
    if split:
        table, n_chunks = leaf_table(views, grads, mu, nu, None, None)
        _launch(table, n_chunks, step, ADAM, device)
        if after_update is not None:
            after_update()
        table, n_chunks = leaf_table(masters, None, None, None, ema, work)
        _launch(table, n_chunks, step, EMA, device)
    else:
        table, n_chunks = leaf_table(masters, grads, mu, nu, ema, work)
        _launch(table, n_chunks, step, ADAM | EMA, device)
    trace.count("update.fused_leaves", len(masters))
    trace.count("update.fused_launches", 2 if split else 1)


adamw_ema.launches = 0
