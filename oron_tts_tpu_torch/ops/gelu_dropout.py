"""Fused tanh-GELU + seeded dropout: the CUDA kernels and their plain versions.

``gelu_dropout(x, seed, rate)`` computes ``gelu_tanh(x)`` in f32, drops each
element with probability ``rate`` and scales the kept ones by
``1/(1 − rate)``, in one pass; its backward regenerates the mask from the
seed, so autograd keeps ``x`` and the seed only. ``rate = 0`` is plain
fused GELU.

- CUDA tensors launch ``csrc/gelu_dropout.cu`` (forward replaces
  ``oron_tts_tpu/ops/gelu_dropout.py:76`` ``_fwd_kernel``, backward ``:87``
  ``_bwd_kernel``), or raise.
- CPU tensors take :func:`gelu_dropout_plain` and
  :func:`gelu_dropout_bwd_plain`, through the same ``autograd.Function``.

The mask is the JAX package's bit for bit (``gelu_dropout.py:58-73``): a
murmur3 finaliser over ``idx·2654435761 + seed`` in uint32 wrap-around,
``idx`` the element's index in the flattened tensor, kept where the hash is
at least ``min(round(rate·2³²), 2³² − 1)``.

Under a mesh a rank holds a shard of the tensor the JAX package drops out
as a whole: its rows of the batch (data parallelism) and, in the FFN, its
columns of the hidden features (tensor parallelism). ``row0``, ``gcols``
and ``col0`` place the shard, seen as ``[rows, cols]`` (``cols`` its last
axis), at global row ``row0`` and column ``col0`` of a tensor ``gcols``
wide; ``idx`` is then the global index ``(row0 + r)·gcols + col0 + c``, so
every shard draws its slice of the one global mask. The defaults (0,
``cols``, 0) are the flat index of a single call.

:func:`hash_dropout` applies the same mask without the GELU (the attention
output's dropout, which the JAX package leaves to XLA), so a whole training
step is a function of its seeds on the CPU and on the card alike. It also
zeroes the rows its ``rows`` mask leaves out (a batch's padded frames) in
the same pass: ``dropout_fwd``/``dropout_bwd`` in ``csrc/gelu_dropout.cu``
on CUDA, :func:`dropout_plain` on the CPU, with the mask regenerated in the
backward, so autograd keeps the seed and the row mask only.
"""

from __future__ import annotations

import torch

from oron_tts_tpu_torch.utils import trace

SQRT_2_OVER_PI = 0.7978845608028654
GELU_C = 0.044715
_M32 = 0xFFFFFFFF


def _threshold(rate: float) -> int:
    if rate <= 0.0:
        return 0
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1): {rate}")
    return min(int(round(rate * 2**32)), 2**32 - 1)


def _inv_keep(rate: float) -> float:
    return 1.0 / (1.0 - rate) if rate else 1.0


def keep_mask_plain(numel: int, seed: int, threshold: int, device, cols: int | None = None,
                    row0: int = 0, gcols: int | None = None, col0: int = 0) -> torch.Tensor:
    """Flat bool keep-mask: uint32 hash arithmetic in int64, masked to 32 bits.

    ``cols``, ``row0``, ``gcols`` and ``col0`` place a shard in its global
    tensor (module docstring); left out, the index is the flat one.
    """
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    cols = cols or max(numel, 1)
    gcols = cols if gcols is None else gcols
    if gcols != cols:
        idx = (idx // cols) * gcols + idx % cols
    if row0 or col0:
        idx = idx + (row0 * gcols + col0)
    idx = idx & _M32
    z = (idx * 2654435761 + (int(seed) & _M32)) & _M32
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _M32
    z = z ^ (z >> 16)
    return z >= threshold


def _gelu_f32(x: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(SQRT_2_OVER_PI * (x + GELU_C * x * x * x))
    return 0.5 * x * (1.0 + t)


def _dgelu_f32(x: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(SQRT_2_OVER_PI * (x + GELU_C * x * x * x))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * SQRT_2_OVER_PI * (
        1.0 + 3.0 * GELU_C * x * x
    )


def _keep(t: torch.Tensor, seed: int, threshold: int, row0: int, gcols: int | None,
          col0: int) -> torch.Tensor:
    cols = t.shape[-1] if t.ndim else 1
    return keep_mask_plain(t.numel(), seed, threshold, t.device, cols, row0, gcols,
                           col0).reshape(t.shape)


def _masked(r: torch.Tensor, seed: int, rate: float, row0: int = 0, gcols: int | None = None,
            col0: int = 0, rows: torch.Tensor | None = None) -> torch.Tensor:
    """``r`` (f32) where kept, times ``1/(1 − rate)`` in f32, else 0.

    ``rows``, a bool for each row of ``r`` seen as ``[-1, cols]``, also zeroes
    the rows it is False on.
    """
    threshold = _threshold(rate)
    if threshold == 0 and rows is None:
        return r
    keep = None if rows is None else _row_keep(rows, r).reshape(*r.shape[:-1], 1)
    if threshold:
        hashed = _keep(r, seed, threshold, row0, gcols, col0)
        keep = hashed if keep is None else keep & hashed
    inv = torch.tensor(_inv_keep(rate), dtype=torch.float32, device=r.device)
    return torch.where(keep, r * inv, torch.zeros_like(r))


def _row_keep(rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``rows`` as one contiguous bool a row of ``x`` seen as ``[-1, cols]``."""
    n_rows = x.numel() // x.shape[-1] if x.ndim and x.shape[-1] else 0
    if rows.dtype != torch.bool or rows.numel() != n_rows:
        raise ValueError(f"rows must be bool with one element a row ({n_rows}), "
                         f"got {rows.dtype} of {rows.numel()}")
    return rows.reshape(-1).contiguous()


def gelu_dropout_plain(x: torch.Tensor, seed: int, rate: float, row0: int = 0,
                       gcols: int | None = None, col0: int = 0) -> torch.Tensor:
    return _masked(_gelu_f32(x.float()), seed, rate, row0, gcols, col0).to(x.dtype)


def gelu_dropout_bwd_plain(x: torch.Tensor, dy: torch.Tensor, seed: int, rate: float,
                           row0: int = 0, gcols: int | None = None,
                           col0: int = 0) -> torch.Tensor:
    return _masked(dy.float() * _dgelu_f32(x.float()), seed, rate, row0, gcols,
                   col0).to(x.dtype)


def dropout_plain(x: torch.Tensor, seed: int, rate: float, row0: int = 0,
                  gcols: int | None = None, col0: int = 0,
                  rows: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout under the hash mask, rows left out of ``rows`` zeroed: the
    product in f32, rounded once to ``x``'s type. Its own backward on ``dy``."""
    return _masked(x.float(), seed, rate, row0, gcols, col0, rows).to(x.dtype)


def _launch(entry: str, x: torch.Tensor, dy: torch.Tensor | None, seed: int,
            rate: float, row0: int, gcols: int | None, col0: int,
            rows: torch.Tensor | None = None) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{entry} takes bf16 or f32, got {x.dtype}")
    from oron_tts_tpu_torch.ops import _build

    x = x.contiguous()
    out = torch.empty_like(x)
    ptrs = [x.data_ptr()]
    if dy is not None:
        if dy.shape != x.shape:
            raise ValueError("dy must match x's shape")
        dy = dy.to(x.dtype).contiguous()
        ptrs.append(dy.data_ptr())
    ptrs.append(out.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError(f"{entry} needs 16-byte aligned tensors")
    if entry.startswith("dropout"):  # x (or dy), a byte a row or null, out
        if rows is not None:
            rows = _row_keep(rows.to(x.device), x)
        ptrs.insert(1, None if rows is None else rows.data_ptr())
    cols = x.shape[-1] if x.ndim else 1
    lib = _build.load("gelu_dropout")
    err = getattr(lib, entry)(
        *ptrs, x.numel(), int(seed) & _M32, _threshold(rate), _inv_keep(rate),
        int(x.dtype == torch.bfloat16), cols, int(row0), cols if gcols is None else int(gcols),
        int(col0), _build.stream_ptr(x.device),
    )
    _build.check(err, entry)
    return out


def gelu_dropout_fwd(x: torch.Tensor, seed: int, rate: float, row0: int = 0,
                     gcols: int | None = None, col0: int = 0) -> torch.Tensor:
    """The forward pass; the kernel on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return gelu_dropout_plain(x, seed, rate, row0, gcols, col0)
    out = _launch("gelu_dropout_fwd", x, None, seed, rate, row0, gcols, col0)
    gelu_dropout_fwd.launches += 1
    return out


gelu_dropout_fwd.launches = 0


def gelu_dropout_bwd(x: torch.Tensor, dy: torch.Tensor, seed: int, rate: float,
                     row0: int = 0, gcols: int | None = None, col0: int = 0) -> torch.Tensor:
    """``dy · dgelu(x)`` under the regenerated mask; the kernel on CUDA."""
    if x.device.type == "cpu":
        return gelu_dropout_bwd_plain(x, dy, seed, rate, row0, gcols, col0)
    out = _launch("gelu_dropout_bwd", x, dy, seed, rate, row0, gcols, col0)
    gelu_dropout_bwd.launches += 1
    return out


gelu_dropout_bwd.launches = 0


class _GeluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, row0, gcols, col0):
        ctx.save_for_backward(x)
        ctx.seed, ctx.rate, ctx.place = int(seed), float(rate), (row0, gcols, col0)
        return gelu_dropout_fwd(x, ctx.seed, ctx.rate, *ctx.place)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return (gelu_dropout_bwd(x, dy, ctx.seed, ctx.rate, *ctx.place),
                None, None, None, None, None)


def gelu_dropout(x: torch.Tensor, seed: int, rate: float, row0: int = 0,
                 gcols: int | None = None, col0: int = 0) -> torch.Tensor:
    """Differentiable fused GELU + dropout; ``seed`` is one int per call, and
    ``row0``/``gcols``/``col0`` place a shard in its global tensor."""
    return _GeluDropout.apply(x, seed, rate, row0, gcols, col0)


def dropout_fwd(x: torch.Tensor, seed: int, rate: float, row0: int = 0,
                gcols: int | None = None, col0: int = 0,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """The attention output's dropout and row zeroing; the kernel on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return dropout_plain(x, seed, rate, row0, gcols, col0, rows)
    out = _launch("dropout_fwd", x, None, seed, rate, row0, gcols, col0, rows)
    dropout_fwd.launches += 1
    trace.count("attn_dropout.fused_calls", 1)
    return out


dropout_fwd.launches = 0


def dropout_bwd(dy: torch.Tensor, seed: int, rate: float, row0: int = 0,
                gcols: int | None = None, col0: int = 0,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`dropout_fwd`'s gradient: the same mask, regenerated, on ``dy``."""
    if dy.device.type == "cpu":
        return dropout_plain(dy, seed, rate, row0, gcols, col0, rows)
    out = _launch("dropout_bwd", dy, None, seed, rate, row0, gcols, col0, rows)
    dropout_bwd.launches += 1
    trace.count("attn_dropout.fused_calls", 1)
    return out


dropout_bwd.launches = 0


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate, row0, gcols, col0, rows):
        ctx.save_for_backward(rows)
        ctx.seed, ctx.rate, ctx.place = int(seed), float(rate), (row0, gcols, col0)
        return dropout_fwd(x, ctx.seed, ctx.rate, *ctx.place, rows)

    @staticmethod
    def backward(ctx, dy):
        (rows,) = ctx.saved_tensors
        return (dropout_bwd(dy, ctx.seed, ctx.rate, *ctx.place, rows),
                None, None, None, None, None, None)


def hash_dropout(x: torch.Tensor, seed: int, rate: float, row0: int = 0,
                 gcols: int | None = None, col0: int = 0,
                 rows: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable inverted dropout of ``x`` under the counter-hash mask.

    ``rows`` (bool, one a row of ``x`` seen as ``[-1, cols]``; None: all kept)
    zeroes the rows it is False on in the same pass. ``rate`` 0 with no
    ``rows`` returns ``x`` itself.
    """
    if _threshold(rate) == 0 and rows is None:
        return x
    return _HashDropout.apply(x, seed, rate, row0, gcols, col0, rows)
