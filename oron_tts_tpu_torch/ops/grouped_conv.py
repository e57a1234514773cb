"""Grouped 1-D conv + bias + Mish: the CUDA kernel and its plain version.

``grouped_conv1d_mish(x, w, bias, groups)`` computes the SAME-padded
grouped convolution of ``x [B, T, C]`` with ``w [K, C/groups, C]`` (the
JAX package's ``nn.Conv`` layout), adds ``bias`` and applies Mish, all in
f32, and returns ``x``'s dtype — the forward of the JAX package's
``grouped_conv1d_pallas(..., fuse_mish=True)``.

- CUDA tensors launch ``csrc/grouped_conv.cu`` (bf16: ``mma.sync``; f32:
  true-f32 SIMT), or raise.
- CPU tensors take :func:`grouped_conv1d_mish_plain`.

The kernel replaces ``oron_tts_tpu/ops/grouped_conv.py:34``
(``_conv_kernel``); see the source note in the ``.cu`` file.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    if x.dtype == torch.bfloat16 and (cin_g != 64 or (C // groups) % 32):
        raise ValueError("the bf16 kernel needs 64 channels per group")
    if x.dtype == torch.float32 and (C // groups) % 8:
        raise ValueError("the f32 kernel needs a multiple of 8 channels per group")
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
