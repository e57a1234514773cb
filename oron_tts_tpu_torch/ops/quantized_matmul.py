"""Int8 weight-quantized matmuls for serving: the CUDA kernel and its plain version.

Counterpart of the JAX package's ``ops/quantized_matmul.py``. Two modes:

- **w8a16** (``quantized_matmul``): int8 weights with one f32 scale per
  output channel, dequantized inside the kernel; the product runs in the
  activation's type with f32 accumulation, is scaled in f32 and cast once;
  an optional bias is then added in the activation's type and rounded again
  (the JAX ``QDense``'s order). CUDA tensors launch ``csrc/qmm.cu`` (which
  replaces ``oron_tts_tpu/ops/quantized_matmul.py:55`` ``_qmm_kernel``; bf16 on
  ``wgmma`` with the tile that :func:`qmm_plan` picks), or raise;
  CPU tensors take :func:`quantized_matmul_plain`. The weight never exists in
  device memory in the activation's type.
- **w8a8** (``w8a8_matmul``): per-token absmax activations in int8, an exact
  s8×s8→s32 product, rescaled in f32. Plain PyTorch on every device, as it
  is plain XLA in the JAX package.

Layout: the port keeps a quantized weight as ``[N, K]`` int8 with K
contiguous (``nn.Linear``'s layout, rows of K that the kernel's copies take).
The JAX package keeps ``[K, N]``; ``utils.weights.from_flax_params``
transposes once at load.

Per-channel symmetric quantization: ``q = round(w / s)`` (half to even) with
``s = absmax / 127`` over K; an all-zero channel gets ``s = 1``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

QMM_BN = 128  # the bf16 kernel's weight rows a block (csrc/qmm.cu)
H100_SMS = 132  # the plan's card: one block an SM, a wave of 132
QMM_TILES = (64, 128, 192, 256)  # x rows a block (the wgmma N) the kernel is built for
QMM_BLOCK_COST = 64  # a block's fixed cost (fill, epilogue) in x rows of work


class QmmPlan(NamedTuple):
    bm: int      # x rows a block (the wgmma N): one of QMM_TILES
    blocks: int  # blocks of the launch, one an SM at a time


@functools.lru_cache(maxsize=4096)
def qmm_plan(m: int, k: int, n: int) -> QmmPlan:
    """The bf16 kernel's tile for ``[m, k] x [n, k]^T``.

    One block an SM at a time, so a launch takes ``ceil(blocks / 132)``
    waves, each as long as one block: ``bm`` rows of work plus a fixed cost
    (the ring's fill and the epilogue). The tile with the fewest waves times
    that length is taken, the narrowest on a tie. At M = 1,664, N = 1,024
    this leaves 104 blocks in one partial wave, which measured faster on the
    H100 than 64-row tiles in two waves (``chip_smoke.py``'s ``qmm_grid``
    line, PERF.md).
    """
    if m < 1 or n < 1 or k < 16 or k % 16:
        raise ValueError(f"qmm_plan needs m, n >= 1 and K a multiple of 16, got "
                         f"m={m} k={k} n={n}")
    cols = -(-n // QMM_BN)

    def cost(bm: int) -> int:
        return -(-(-(-m // bm) * cols) // H100_SMS) * (bm + QMM_BLOCK_COST)

    bm = min(QMM_TILES, key=cost)
    return QmmPlan(bm, -(-m // bm) * cols)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., N, K]`` float weights → (int8 ``[..., N, K]``, f32 scale ``[..., N]``)."""
    w = w.detach().to(torch.float32)
    absmax = w.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[..., N, K]`` in ``dtype``: the weight the kernel multiplies by, scale applied."""
    return (q.to(dtype) * scale[..., None].to(dtype)).to(dtype)


def quantized_matmul_plain(
    x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain ops: f32 product, f32 scale, one cast;
    then the bias, in x's dtype (a second rounding)."""
    acc = torch.matmul(x.to(torch.float32), w_q.to(torch.float32).t())
    y = (acc * scale.to(torch.float32)).to(x.dtype)
    return y if bias is None else y + bias.to(y.dtype)


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """w8a16: ``x @ dequant(w_q).T (+ bias)`` with the dequantization inside the kernel.

    x: ``[..., K]`` bf16 or f32; w_q: ``[N, K]`` int8; scale: ``[N]`` f32;
    bias: ``[N]`` or None, added in the kernel's epilogue in x's dtype after
    the scaled product is rounded to it. Returns ``[..., N]`` in x's dtype.
    """
    if w_q.dtype != torch.int8 or w_q.ndim != 2:
        raise ValueError(f"w_q must be int8 [N, K], got {w_q.dtype} {tuple(w_q.shape)}")
    n, k = w_q.shape
    if x.shape[-1] != k or scale.shape != (n,) or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"x {tuple(x.shape)}, scale {tuple(scale.shape)} and bias "
                         f"{None if bias is None else tuple(bias.shape)} do not fit "
                         f"a weight of [N={n}, K={k}]")
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, w_q, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantized_matmul takes bf16 or f32 activations, got {x.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be f32, got {scale.dtype}")
    if any(t is not None and t.device != x.device for t in (w_q, scale, bias)):
        raise ValueError("x, w_q, scale and bias must lie on one device")
    if k % 16:
        raise ValueError(f"the kernel needs K to be a multiple of 16, got {k}")
    from oron_tts_tpu_torch.ops import _build

    x2 = x.reshape(-1, k).contiguous()
    w_q, scale = w_q.contiguous(), scale.contiguous()
    if bias is not None:
        bias = bias.to(x.dtype).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    if any(t.data_ptr() % 16 for t in (x2, w_q, out)):
        raise ValueError("quantized_matmul needs 16-byte aligned tensors")
    bf16 = x.dtype == torch.bfloat16
    lib = _build.load("qmm")
    err = lib.qmm_w8a16(
        x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, k, n,
        qmm_plan(m, k, n).bm if bf16 else 0, int(bf16), _build.stream_ptr(x.device),
    )
    _build.check(err, "quantized_matmul")
    quantized_matmul.launches += 1
    return out.reshape(*x.shape[:-1], n)


quantized_matmul.launches = 0


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token dynamic absmax: ``[..., K]`` → (int8 ``[..., K]``, f32 scale ``[..., 1]``)."""
    xf = x.to(torch.float32)
    x_scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    return x_q, x_scale


def int8_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact s8×s8→s32 product of ``x_q [M, K]`` with ``w_q [N, K]`` transposed.

    ``torch._int_mm`` where it takes the shape (more than 16 rows, K and N
    multiples of 8); otherwise a float64 product, which is exact too: every
    partial sum stays below 127²·K, far inside 2⁵³.
    """
    m, k = x_q.shape
    n = w_q.shape[0]
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(x_q.contiguous(), w_q.t())
    return torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64).t()).to(torch.int32)


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """w8a8: per-token int8 activations × int8 weights, rescaled in f32, one cast."""
    x_q, x_scale = quantize_activations(x)
    acc = int8_product(x_q.reshape(-1, x.shape[-1]), w_q).reshape(*x.shape[:-1], w_q.shape[0])
    return (acc.to(torch.float32) * x_scale * scale.to(torch.float32)).to(x.dtype)
