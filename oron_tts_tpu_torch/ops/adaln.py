"""AdaLN-Zero around a DiT block's sublayers: the CUDA passes and their plain forms.

Three entry points, each a ``torch.autograd.Function`` on the card, on ``x``/``y``
``[B, T, dim]`` and modulation rows ``gate``/``scale``/``shift`` ``[1 or B, dim]``
(LN: a LayerNorm without scale or bias, eps 1e-6):

- :func:`adaln_modulate`: ``LN(x)·(1 + scale) + shift``, the attention's input and
  ``norm_out``;
- :func:`gate_residual_modulate`: ``x1 = x + gate·y`` and the FFN's input
  ``LN(x1)·(1 + scale) + shift``, the block's middle;
- :func:`gate_residual`: ``x + gate·y``, the block's end.

- CUDA tensors launch ``csrc/adaln.cu``, one pass each forward and one pass plus
  one fixed-order sum each backward (:func:`adaln_fwd`, :func:`adaln_bwd`), or
  raise. The passes compute in f32 and round once; the forward keeps each row's
  mean and rstd, not the normalised row. ``adaln.fused_calls`` counts every launch.
- CPU tensors take the plain forms (``*_plain``), the eager expressions the DiT
  block always had, under eager autograd.

A modulation argument is a view with unit column stride (a chunk of the AdaLN
projection's ``[B, 6·dim]``, or one row hoisted by the sampler); the kernel reads it
by stride, with no broadcast copy.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from oron_tts_tpu_torch.utils import trace

MODULATE, GATE_RESIDUAL_MODULATE, GATE_RESIDUAL = 0, 1, 2
FWD_TILE_ROWS, BWD_TILE_ROWS = 16, 64  # rows of one batch row a CTA takes
_SUMS = {MODULATE: 2, GATE_RESIDUAL_MODULATE: 3, GATE_RESIDUAL: 1}  # d scale, d shift, d gate


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without scale or bias (flax ``use_scale=False, use_bias=False``)."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def adaln_modulate_plain(x, y, gate, scale, shift):
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def gate_residual_plain(x, y, gate, scale, shift):
    return x + gate[:, None] * y


def gate_residual_modulate_plain(x, y, gate, scale, shift):
    x1 = gate_residual_plain(x, y, gate, None, None)
    return x1, adaln_modulate_plain(x1, None, None, scale, shift)


PLAIN = {MODULATE: adaln_modulate_plain, GATE_RESIDUAL_MODULATE: gate_residual_modulate_plain,
         GATE_RESIDUAL: gate_residual_plain}


def _check(x: torch.Tensor, rows: list[torch.Tensor | None],
           mods: list[torch.Tensor | None]) -> int:
    """Raise on what the kernels do not take; the modulation's row count (1 or B)."""
    if x.ndim != 3:
        raise ValueError(f"adaln: x must be [B, T, dim], got {tuple(x.shape)}")
    batch, _, dim = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"adaln takes bf16 or f32, got {x.dtype}")
    widest = 32 * 16 * 16 // x.element_size()  # a warp a row, 16 vectors of 16 bytes a lane
    if dim % 8 or dim > widest:
        raise ValueError(f"adaln: dim must be a multiple of 8 up to {widest}, got {dim}")
    for t in rows:
        if t is None:
            continue
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"adaln: {tuple(t.shape)} {t.dtype} does not match x's "
                             f"{tuple(x.shape)} {x.dtype}")
        if not t.is_contiguous():
            raise ValueError("adaln: x and y must be contiguous")
    n_rows = {m.shape[0] for m in mods if m is not None}
    for m in mods:
        if m is None:
            continue
        if m.ndim != 2 or m.shape[1] != dim or m.shape[0] not in (1, batch):
            raise ValueError(f"adaln: a modulation must be [1 or B={batch}, {dim}], "
                             f"got {tuple(m.shape)}")
        if m.stride(1) != 1:
            raise ValueError("adaln: a modulation row must be contiguous")
        if m.dtype != x.dtype:
            raise ValueError(f"adaln: modulation {m.dtype} against x {x.dtype}")
    if len(n_rows) > 1:
        raise ValueError(f"adaln: modulations of {sorted(n_rows)} rows in one call")
    if x.device.type != "cuda":
        raise ValueError(f"adaln: unsupported device {x.device}")
    size = x.element_size()
    if any(t is not None and t.data_ptr() % 16 for t in [*rows, *mods]) or any(
            m is not None and m.shape[0] > 1 and m.stride(0) * size % 16 for m in mods):
        raise ValueError("adaln needs 16-byte aligned tensors and modulation rows")
    return n_rows.pop() if n_rows else 1


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p | None:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stride(m: torch.Tensor | None) -> int:
    return 0 if m is None or m.shape[0] == 1 else m.stride(0)


def adaln_fwd(op: int, x, y, gate, scale, shift):
    """One forward pass on the card: ``(out, x1, stats)``, each None where ``op`` has none."""
    _check(x, [x, y], [gate, scale, shift])
    from oron_tts_tpu_torch.ops import _build

    B, T, D = x.shape
    out = None if op == GATE_RESIDUAL else torch.empty_like(x)
    x1 = None if op == MODULATE else torch.empty_like(x)
    stats = None if op == GATE_RESIDUAL else torch.empty(2, B * T, dtype=torch.float32,
                                                         device=x.device)
    err = _build.load("adaln").adaln_fwd(
        op, _ptr(x), _ptr(y), _ptr(out), _ptr(x1), _ptr(stats), _ptr(gate), _stride(gate),
        _ptr(scale), _stride(scale), _ptr(shift), _stride(shift), B, T, D, FWD_TILE_ROWS,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check(err, "adaln_fwd")
    adaln_fwd.launches += 1
    trace.count("adaln.fused_calls", 1)
    return out, x1, stats


adaln_fwd.launches = 0


def adaln_bwd(op: int, x, y, dh, dres, stats, gate, scale):
    """One backward pass and its fixed-order sum on the card: ``(dx, dy, sums)``.

    ``x`` is the LayerNorm's input (``x1`` for :data:`GATE_RESIDUAL_MODULATE`),
    ``dh`` the gradient of the modulated output, ``dres`` that of ``x1``; ``sums``
    ``[Q, 1 or B, dim]`` holds d scale, d shift and d gate, those ``op`` has, in that order.
    """
    ref = y if x is None else x
    dh, dres = (None if g is None else g.to(ref.dtype).contiguous() for g in (dh, dres))
    mods_rows = _check(ref, [x, y, dh, dres], [gate, scale])
    from oron_tts_tpu_torch.ops import _build

    B, T, D = ref.shape
    dx = None if op == GATE_RESIDUAL else torch.empty_like(ref)
    dy = None if op == MODULATE else torch.empty_like(ref)
    tiles = B * -(-T // BWD_TILE_ROWS)
    partials = torch.empty(tiles, _SUMS[op], D, dtype=torch.float32, device=ref.device)
    sums = torch.empty(_SUMS[op], mods_rows, D, dtype=ref.dtype, device=ref.device)
    err = _build.load("adaln").adaln_bwd(
        op, _ptr(x), _ptr(y), _ptr(dh), _ptr(dres), _ptr(stats), _ptr(gate), _stride(gate),
        _ptr(scale), _stride(scale), _ptr(dx), _ptr(dy), _ptr(partials), _ptr(sums), mods_rows,
        B, T, D, BWD_TILE_ROWS, int(ref.dtype == torch.bfloat16), _build.stream_ptr(ref.device))
    _build.check(err, "adaln_bwd")
    adaln_bwd.launches += 2
    trace.count("adaln.fused_calls", 2)
    return dx, dy, sums


adaln_bwd.launches = 0


class _AdaLN(torch.autograd.Function):
    """The kernels, each way; inputs ``(x, y, gate, scale, shift)``, those ``op``
    does not read None."""

    @staticmethod
    def forward(ctx, op, x, y, gate, scale, shift):
        ctx.op = op
        out, x1, stats = adaln_fwd(op, x, y, gate, scale, shift)
        if op == MODULATE:
            ctx.save_for_backward(x, scale, stats)
            return out
        if op == GATE_RESIDUAL_MODULATE:
            ctx.save_for_backward(x1, y, gate, scale, stats)
            return x1, out
        ctx.save_for_backward(y, gate)
        return x1

    @staticmethod
    def backward(ctx, *grads):
        op = ctx.op
        if op == MODULATE:
            x, scale, stats = ctx.saved_tensors
            dx, _, (dscale, dshift) = adaln_bwd(op, x, None, grads[0], None, stats, None, scale)
            return None, dx, None, None, dscale, dshift
        if op == GATE_RESIDUAL_MODULATE:
            x1, y, gate, scale, stats = ctx.saved_tensors
            dres, dh = grads
            dx, dy, (dscale, dshift, dgate) = adaln_bwd(op, x1, y, dh, dres, stats, gate, scale)
            return None, dx, dy, dgate, dscale, dshift
        y, gate = ctx.saved_tensors
        (dout,) = grads
        _, dy, (dgate,) = adaln_bwd(op, None, y, None, dout, None, gate, None)
        return None, dout, dy, dgate, None, None


def adaln_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``LN(x)·(1 + scale) + shift``; ``scale``, ``shift`` ``[1 or B, dim]``, ``x [B, T, dim]``."""
    if x.device.type == "cpu":
        return adaln_modulate_plain(x, None, None, scale, shift)
    return _AdaLN.apply(MODULATE, x, None, None, scale, shift)


def gate_residual_modulate(x: torch.Tensor, y: torch.Tensor, gate: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor):
    """``(x1, LN(x1)·(1 + scale) + shift)`` with ``x1 = x + gate·y``."""
    if x.device.type == "cpu":
        return gate_residual_modulate_plain(x, y, gate, scale, shift)
    return _AdaLN.apply(GATE_RESIDUAL_MODULATE, x, y, gate, scale, shift)


def gate_residual(x: torch.Tensor, y: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``x + gate·y``."""
    if x.device.type == "cpu":
        return gate_residual_plain(x, y, gate, None, None)
    return _AdaLN.apply(GATE_RESIDUAL, x, y, gate, None, None)
