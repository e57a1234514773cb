"""Plain float32 training step of F5-TTS: the CFM loss, its gradients, clipping, AdamW, EMA.

The conditional flow-matching loss (arXiv:2410.06885): per row a
contiguous span of 70–100% of its frames is masked out of the conditioning,
``t ~ U(0, 1)``, ``φ = (1 − t)·x0 + t·x1`` from noise ``x0``, and the loss is
the squared error of the predicted flow ``x1 − x0`` over the span's frames ×
mel bins; one dropout decision a batch drops the audio (30%) or the text
and the audio (20%). Dropout (10%) follows the attention output and the
FFN's GELU, under a counter-hash mask (a murmur3 finaliser over each
element's flat index and the block's seed). Every random number is drawn from
one CPU ``torch.Generator`` in the served program's order: the span
fractions, the span starts, the times, the two drop decisions, ``x0``, then
the architecture's (attention, FFN) seed pairs (``dropout_pairs``). The
velocity is the architecture's (``portbench/reference/__init__.py``).

The optimizer: gradients clipped to a global norm of ``max_grad_norm``,
AdamW (weight decay 0.01, f32 moments) under a linear warm-up from
``lr·1e-4``, and an EMA with the ``min(d, (1 + n)/(10 + n))`` ramp.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def keep_mask(shape: tuple[int, ...], seed: int, rate: float, offset: int, device) -> torch.Tensor:
    """Bool keep-mask of a tensor whose flat index starts at ``offset``."""
    n = math.prod(shape)
    idx = (torch.arange(n, dtype=torch.int64, device=device) + offset) & _M32
    z = (idx * 2654435761 + (int(seed) & _M32)) & _M32
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _M32
    z = z ^ (z >> 16)
    return (z >= min(int(round(rate * 2 ** 32)), 2 ** 32 - 1)).reshape(shape)


def draws(gen: torch.Generator, rows: int, frames: int, n_mels: int, pairs: int,
          probs: tuple[float, float]) -> dict:
    """One step's random numbers, in the program's order, with ``pairs`` dropout seed
    pairs."""
    u = torch.rand((3, rows), generator=gen)
    drop = (torch.rand(2, generator=gen) < torch.tensor(list(probs))).tolist()
    x0 = torch.randn((rows, frames, n_mels), generator=gen)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (pairs, 2), generator=gen).tolist()
    return {"u": u, "drop_audio": bool(drop[0]) or bool(drop[1]), "drop_text": bool(drop[1]),
            "x0": x0, "seeds": seeds}


def loss_and_grads(P, mel: torch.Tensor, ids: torch.Tensor, lens: torch.Tensor, d: dict,
                   frac_range: tuple[float, float], rate: float, rows_per_block: int,
                   velocity) -> tuple[float, list[torch.Tensor]]:
    """The CFM loss of a collated batch (mel [B, M, T]) and its gradient for every
    parameter of ``P`` (in ``P.p``'s order), accumulated over blocks of rows.

    ``P`` and ``velocity`` are an architecture's ``params`` and ``velocity``."""
    dev = mel.device
    B, M, T = mel.shape
    x1 = mel.transpose(1, 2).float()
    lens = lens.to(dev, torch.int32)
    mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    lo, hi = frac_range
    frac = (lo + (hi - lo) * d["u"][0]).to(dev)
    span_len = (frac * lens).to(torch.int32)
    start = torch.clamp(((lens - span_len) * d["u"][1].to(dev)).to(torch.int32), min=0)
    pos = torch.arange(T, device=dev)[None, :]
    span = (pos >= start[:, None]) & (pos < (start + span_len)[:, None]) & mask
    t = d["u"][2].to(dev)
    x0 = d["x0"].to(dev)
    denom = float(span.sum()) * M
    params = list(P.p.values())
    for p in params:
        p.requires_grad_(True)
        p.grad = None
    total = 0.0
    for r0 in range(0, B, rows_per_block):
        sl = slice(r0, min(B, r0 + rows_per_block))
        tb = t[sl][:, None, None]
        phi = (1 - tb) * x0[sl] + tb * x1[sl]
        cond = torch.where(span[sl][..., None], 0.0, x1[sl])

        def dropout(i: int, r0=r0):
            a_seed, f_seed = d["seeds"][i]

            def drop(kind: str, x: torch.Tensor) -> torch.Tensor:
                seed = a_seed if kind == "attn" else f_seed
                off = r0 * x.shape[1] * x.shape[2]
                keep = keep_mask(tuple(x.shape), seed, rate, off, x.device)
                return x * keep.float() * (1.0 / (1.0 - rate))
            return drop

        pred = velocity(P, phi, cond, ids[sl].to(dev), t[sl], mask[sl], d["drop_audio"],
                        d["drop_text"], dropout=dropout)
        num = (((pred - (x1[sl] - x0[sl])) ** 2) * span[sl][..., None]).sum()
        part = num / max(denom, 1.0)
        part.backward()
        total += float(part.detach())
    grads = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p in params:
        p.requires_grad_(False)
        p.grad = None
    return total, grads


class AdamW:
    """Clipped AdamW with f32 moments and the EMA of the weights."""

    def __init__(self, params: list[torch.Tensor], lr: float, betas, warmup: int,
                 ema_decay: float, max_norm: float, weight_decay: float = 0.01) -> None:
        self.p = params
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.ema = [p.clone() for p in params]
        self.lr, self.b1, self.b2 = lr, betas[0], betas[1]
        self.warmup, self.decay, self.max_norm, self.wd = warmup, ema_decay, max_norm, weight_decay
        self.count = 0

    def lr_at(self, step: int) -> float:
        if step < self.warmup:
            return (self.lr * 1e-4 - self.lr) * (1.0 - step / self.warmup) + self.lr
        return self.lr  # the cosine decay starts after the warm-up; three steps never reach it

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """One update; returns the clipped gradients it used."""
        norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
        if norm >= self.max_norm:
            grads = [g / norm * self.max_norm for g in grads]
        n = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** n, 1.0 - self.b2 ** n
        lr = self.lr_at(self.count)
        for p, g, m, v in zip(self.p, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g * (1.0 - self.b1))
            v.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            p.add_(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8) + self.wd * p))
        d = min(self.decay, (1.0 + n) / (10.0 + n))
        for p, e in zip(self.p, self.ema):
            e.mul_(d).add_(p * (1.0 - d))
        self.count = n
        return grads


def leaf_gap(got: list[np.ndarray], ref: list[np.ndarray], keep: list[bool]) -> tuple[float, int]:
    """The worst leaf's gap between two norms, over the larger of the reference's norm
    of that leaf and of the median leaf: (gap, index of the worst leaf)."""
    ref_n = np.array([float(np.linalg.norm(r)) for r in ref])
    got_n = np.array([float(np.linalg.norm(g)) for g in got])
    med = float(np.median(ref_n[np.array(keep)]))
    gaps = np.where(keep, np.abs(got_n - ref_n) / np.maximum(ref_n, med), 0.0)
    worst = int(np.argmax(gaps))
    return float(gaps[worst]), worst
