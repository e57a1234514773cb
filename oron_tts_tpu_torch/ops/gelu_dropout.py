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
at least ``min(round(rate·2³²), 2³² − 1)``. :func:`hash_dropout` applies the
same mask without the GELU in plain tensor ops (the attention output's
dropout, which the JAX package leaves to XLA), so a whole training step is a
function of its seeds on the CPU and on the card alike.
"""

from __future__ import annotations

import torch

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


def keep_mask_plain(numel: int, seed: int, threshold: int, device) -> torch.Tensor:
    """Flat bool keep-mask: uint32 hash arithmetic in int64, masked to 32 bits."""
    idx = torch.arange(numel, dtype=torch.int64, device=device) & _M32
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


def _masked(r: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    threshold = _threshold(rate)
    if threshold == 0:
        return r
    keep = keep_mask_plain(r.numel(), seed, threshold, r.device).reshape(r.shape)
    inv = torch.tensor(_inv_keep(rate), dtype=torch.float32, device=r.device)
    return torch.where(keep, r * inv, torch.zeros_like(r))


def gelu_dropout_plain(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    return _masked(_gelu_f32(x.float()), seed, rate).to(x.dtype)


def gelu_dropout_bwd_plain(x: torch.Tensor, dy: torch.Tensor, seed: int,
                           rate: float) -> torch.Tensor:
    return _masked(dy.float() * _dgelu_f32(x.float()), seed, rate).to(x.dtype)


def hash_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Inverted dropout of ``x`` under the counter-hash mask, in plain ops."""
    threshold = _threshold(rate)
    if threshold == 0:
        return x
    keep = keep_mask_plain(x.numel(), seed, threshold, x.device).reshape(x.shape)
    return x * (keep.to(x.dtype) * _inv_keep(rate))


def _launch(entry: str, x: torch.Tensor, dy: torch.Tensor | None, seed: int,
            rate: float) -> torch.Tensor:
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
    lib = _build.load("gelu_dropout")
    err = getattr(lib, entry)(
        *ptrs, x.numel(), int(seed) & _M32, _threshold(rate), _inv_keep(rate),
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device),
    )
    _build.check(err, entry)
    return out


def gelu_dropout_fwd(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """The forward pass; the kernel on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return gelu_dropout_plain(x, seed, rate)
    out = _launch("gelu_dropout_fwd", x, None, seed, rate)
    gelu_dropout_fwd.launches += 1
    return out


gelu_dropout_fwd.launches = 0


def gelu_dropout_bwd(x: torch.Tensor, dy: torch.Tensor, seed: int,
                     rate: float) -> torch.Tensor:
    """``dy · dgelu(x)`` under the regenerated mask; the kernel on CUDA."""
    if x.device.type == "cpu":
        return gelu_dropout_bwd_plain(x, dy, seed, rate)
    out = _launch("gelu_dropout_bwd", x, dy, seed, rate)
    gelu_dropout_bwd.launches += 1
    return out


gelu_dropout_bwd.launches = 0


class _GeluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.save_for_backward(x)
        ctx.seed, ctx.rate = int(seed), float(rate)
        return gelu_dropout_fwd(x, ctx.seed, ctx.rate)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return gelu_dropout_bwd(x, dy, ctx.seed, ctx.rate), None, None


def gelu_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Differentiable fused GELU + dropout; ``seed`` is one int per call."""
    return _GeluDropout.apply(x, seed, rate)
