"""Plain float32 pieces that more than one reference uses: norms, activations, a grouped
conv, and the roundings that the controls put in float32's place.

Every product runs in float32 with TF32 off; nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a row (last axis), back in float32."""
    scale = x.detach().abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest), back in float32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def layer_norm(x: torch.Tensor, weight=None, bias=None) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + EPS)
    if weight is not None:
        y = y * weight + bias
    return y


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3)))


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int,
                dilation: int = 1, rnd=None) -> torch.Tensor:
    """[B, T, C] by a ``[K, cin/groups, C]`` kernel, zero-padded to keep T; ``rnd``
    rounds both operands of the product."""
    K, cin_g, C = w.shape
    B, T, _ = x.shape
    pad = dilation * (K // 2)
    xp = F.pad(x, (0, 0, pad, dilation * (K - 1) - pad))
    out_g = C // groups
    xg = xp.reshape(B, -1, groups, cin_g)
    wg = w.reshape(K, cin_g, groups, out_g)
    if rnd is not None:
        xg, wg = rnd(xg), rnd(wg)
    acc = torch.zeros(B, T, groups, out_g, dtype=x.dtype, device=x.device)
    for i in range(K):
        acc = acc + torch.einsum("btgi,igo->btgo", xg[:, i * dilation: i * dilation + T], wg[i])
    return acc.reshape(B, T, C) + b
