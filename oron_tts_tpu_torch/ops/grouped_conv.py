"""Grouped 1-D conv + bias + Mish: the CUDA kernel and its plain version.

``grouped_conv1d_mish(x, w, bias, groups)`` computes the SAME-padded
grouped convolution of ``x [B, T, C]`` with ``w [K, C/groups, C]`` (the
JAX package's ``nn.Conv`` layout), adds ``bias`` and applies Mish, all in
f32, and returns ``x``'s dtype — the forward of the JAX package's
``grouped_conv1d_pallas(..., fuse_mish=True)``.

- CUDA tensors launch ``csrc/grouped_conv.cu`` (bf16: ``wgmma`` at group
  widths 16, 32, 64 and 128, the taps' weights streamed through a
  ``cp.async`` ring; a SIMT kernel with
  f32 sums at widths 1, 2, 4 and 8; f32: true-f32 SIMT at widths that are
  multiples of 8 or divide 8), or raise. Together that is every width the
  JAX rule sends to its kernel (``models/layers.conv_route``).
- CPU tensors take :func:`grouped_conv1d_mish_plain`.

The kernel replaces ``oron_tts_tpu/ops/grouped_conv.py:34``
(``_conv_kernel``); see the source note in the ``.cu`` file.

:func:`grouped_conv1d_mish_grad` is the differentiable form for training.
Its forward is the same launch; its backward differentiates the library
reference (``F.conv1d`` with groups + bias + Mish, recomputed from the
saved inputs), as the JAX package takes this gradient from XLA's
convolution and not from a Pallas kernel (``grouped_conv.py:113-119``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


BF16_GROUP_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128)
WGMMA_GROUP_WIDTHS = (16, 32, 64, 128)  # bf16 widths on the wgmma kernel


def kernel_group_width_ok(width: int, dtype: torch.dtype) -> bool:
    """Whether the conv kernel takes this group width in this dtype."""
    if dtype == torch.bfloat16:
        return width in BF16_GROUP_WIDTHS
    return width > 0 and (width % 8 == 0 or 8 % width == 0)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def grouped_conv1d_mish_plain(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, groups: int
) -> torch.Tensor:
    """F.pad + K shifted grouped einsums + bias + Mish, in f32."""
    B, T, C = x.shape
    K, cin_g, _ = w.shape
    out_g = C // groups
    pad_l = K // 2
    xp = F.pad(x.float(), (0, 0, pad_l, K - 1 - pad_l)).reshape(B, T + K - 1, groups, cin_g)
    wg = w.float().reshape(K, cin_g, groups, out_g)
    acc = None
    for i in range(K):
        term = torch.einsum("btgi,igo->btgo", xp[:, i: i + T], wg[i])
        acc = term if acc is None else acc + term
    y = acc.reshape(B, T, C) + bias.float()
    return mish(y).to(x.dtype)


def grouped_conv1d_mish(
    x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, groups: int
) -> torch.Tensor:
    """SAME grouped conv + bias + Mish over ``[B, T, C]``; the kernel on CUDA."""
    if x.device.type == "cpu":
        return grouped_conv1d_mish_plain(x, w, bias, groups)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_conv1d_mish: unsupported device {x.device}")
    from oron_tts_tpu_torch.ops import _build

    B, T, C = x.shape
    K, cin_g, c_out = w.shape
    if c_out != C or C % groups or cin_g != C // groups:
        raise ValueError(f"weight {tuple(w.shape)} does not fit C={C}, groups={groups}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"grouped_conv1d_mish takes bf16 or f32, got {x.dtype}")
    if not kernel_group_width_ok(cin_g, x.dtype) or C % 8:
        raise ValueError(f"the grouped-conv kernel takes group widths {BF16_GROUP_WIDTHS} in "
                         "bf16 (and multiples of 8 in f32) and C a multiple of 8; got width "
                         f"{cin_g} (C={C}, groups={groups}, {x.dtype})")
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    b32 = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    lib = _build.load("grouped_conv")
    err = lib.grouped_conv1d_mish(
        x.data_ptr(), w.data_ptr(), b32.data_ptr(), y.data_ptr(), B, T, C,
        groups, K, int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device),
    )
    _build.check(err, "grouped_conv1d_mish")
    grouped_conv1d_mish.launches += 1
    return y


grouped_conv1d_mish.launches = 0


def conv_mish_reference(x, w, bias, groups):
    """``F.conv1d`` with groups + bias + Mish on the JAX weight layout.

    The route of shapes the JAX package hands to XLA's convolution, and the
    backward of :func:`grouped_conv1d_mish_grad`.
    """
    K = w.shape[0]
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), bias.to(x.dtype),
                 padding=K // 2, groups=groups)
    return mish(y.float()).to(x.dtype).transpose(1, 2)


class _GroupedConvMish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, groups):
        ctx.save_for_backward(x, w, bias)
        ctx.groups = groups
        return grouped_conv1d_mish(x, w, bias, groups)

    @staticmethod
    def backward(ctx, dy):
        x, w, bias = ctx.saved_tensors
        with torch.enable_grad():
            xs, ws, bs = (t.detach().requires_grad_(True) for t in (x, w, bias))
            y = conv_mish_reference(xs, ws.to(xs.dtype), bs, ctx.groups)
            dx, dw, db = torch.autograd.grad(y, (xs, ws, bs), dy.to(y.dtype))
        return dx, dw, db, None


def grouped_conv1d_mish_grad(x, w, bias, groups):
    """Differentiable :func:`grouped_conv1d_mish` (kernel forward, reference backward)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or bias.requires_grad):
        return _GroupedConvMish.apply(x, w, bias, groups)
    return grouped_conv1d_mish(x, w, bias, groups)
