"""DiT building blocks in PyTorch, feature-last ``[B, T, C]`` layout.

Counterparts of the JAX package's ``models/layers.py``. Submodules carry
the flax parameter names (``to_q``, ``attn_norm.linear``, ``conv1``, …) so
``utils.weights.from_flax_params`` loads a flax tree as a state dict.
Modules compute in the dtype their parameters are cast to (bf16 on the
card, f32 on the CPU); masks are boolean ``[B, T]`` prefixes. Training
keeps f32 master weights outside these modules (``train/trainer.py``) and
copies them into this working set each step, so inference and training run
the same forward.

Attention takes the JAX package's ``attn_impl`` switch: "lanes" (the
default) runs the lanes kernels (``ops/flash_attention.py``: forward, and
stats forward + backward when a gradient is needed), "flash" the classic
``[B, H, T, D]`` kernels (forward, and the recomputing backward), "packed"
the head-pair forward, "einsum" and "skip" plain tensor ops. The
position-embedding convs run the grouped-conv kernel
(``ops/grouped_conv.py``) where the JAX package runs its Pallas conv and
``F.conv1d`` where it hands the shape to XLA, and the training FFN runs the
fused GELU+dropout kernels (``ops/gelu_dropout.py``);
under int8 serving the six projections of a block are :class:`QDense` and run
the w8a16 kernel (``ops/quantized_matmul.py``). On CPU tensors all take their
plain versions.

Dropout has no module state: a block is deterministic unless it is handed
``seeds = (attention seed, FFN seed)``, two ints drawn by the caller from
its ``torch.Generator``. Both masks are pure functions of their seed, so a
rematerialised block redraws the same ones.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from oron_tts_tpu_torch.ops.flash_attention import (
    flash_attention_lanes,
    flash_attention_packed,
    flash_attention_trainable,
)
from oron_tts_tpu_torch.ops.gelu_dropout import gelu_dropout, hash_dropout
from oron_tts_tpu_torch.ops.grouped_conv import (
    conv_mish_reference,
    grouped_conv1d_mish_grad,
    mish,
)
from oron_tts_tpu_torch.ops.quantized_matmul import (
    quantize_weight,
    quantized_matmul,
    w8a8_matmul,
)

__all__ = [
    "mish", "sinusoidal_embedding", "rope_tables", "apply_rope", "apply_rope_lanes",
    "text_position_table", "TimestepEmbedding", "conv_route", "ConvPositionEmbedding",
    "DepthwiseConv1d", "GRN", "ConvNeXtV2Block", "AdaLayerNorm",
    "AdaLayerNormFinal", "QDense", "make_dense", "ATTN_IMPLS", "resolve_attn_impl",
    "Attention", "FeedForward", "DiTBlock",
]


def sinusoidal_embedding(
    t: torch.Tensor, dim: int, scale: float = 1000.0, theta: float = 10000.0
) -> torch.Tensor:
    """[B] → [B, dim] f32: cat(sin, cos)."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * (-math.log(theta) / (half - 1))
    )
    args = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rope_tables(seq_len: int, dim_head: int, theta: float = 10000.0) -> tuple[np.ndarray, np.ndarray]:
    """RoPE cos/sin [seq_len, dim_head] (rotate-half convention), float64 → f32."""
    inv_freq = 1.0 / (theta ** (np.arange(0, dim_head, 2, dtype=np.float64) / dim_head))
    freqs = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


@functools.lru_cache(maxsize=16)
def lanes_rope(seq_len: int, dim_head: int, heads: int, device: str, dtype: torch.dtype):
    """cos/sin tiled over heads to [1, T, H·D] on ``device`` in ``dtype``."""
    cos, sin = rope_tables(seq_len, dim_head)
    return tuple(
        torch.from_numpy(np.tile(a, (1, heads))[None]).to(device=device, dtype=dtype)
        for a in (cos, sin)
    )


@functools.lru_cache(maxsize=16)
def heads_rope(seq_len: int, dim_head: int, device: str, dtype: torch.dtype):
    """cos/sin [T, D] on ``device`` in ``dtype``, for :func:`apply_rope`."""
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in rope_tables(seq_len, dim_head))


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE heads-first: q, k [B, H, T, D]; cos/sin [T, D], cast to q's dtype."""
    half = q.shape[-1] // 2

    def rot_half(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([-x[..., half:], x[..., :half]], dim=-1)

    cos, sin = cos.to(q.dtype)[None, None], sin.to(q.dtype)[None, None]
    return q * cos + rot_half(q) * sin, k * cos + rot_half(k) * sin


def apply_rope_lanes(
    q: torch.Tensor, k: torch.Tensor, cos_l: torch.Tensor, sin_l: torch.Tensor, heads: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE on the lanes layout: q, k [B, T, H·D]; cos_l/sin_l [1, T, H·D]."""
    B, T, HD = q.shape
    d = HD // heads

    def rot(x: torch.Tensor) -> torch.Tensor:
        x4 = x.reshape(B, T, heads, d)
        return torch.cat([-x4[..., d // 2:], x4[..., : d // 2]], dim=-1).reshape(B, T, HD)

    return q * cos_l + rot(q) * sin_l, k * cos_l + rot(k) * sin_l


def text_position_table(dim: int, max_pos: int = 8192, theta: float = 10000.0) -> np.ndarray:
    """Sinusoidal text positions [max_pos, dim]: cat(cos, sin)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    angles = np.outer(np.arange(max_pos, dtype=np.float64), freqs)
    return np.concatenate([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without scale or bias (flax ``use_scale=False, use_bias=False``)."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, freq_embed_dim: int = 256) -> None:
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        self.mlp_in = nn.Linear(freq_embed_dim, dim)
        self.mlp_out = nn.Linear(dim, dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = sinusoidal_embedding(t, self.freq_embed_dim).to(self.mlp_in.weight.dtype)
        return self.mlp_out(F.silu(self.mlp_in(h)))


class ConvWeights(nn.Module):
    """A 1-D conv's parameters in the JAX layout: weight [K, cin/g, C], bias [C]."""

    def __init__(self, kernel_size: int, cin_g: int, dim: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(kernel_size, cin_g, dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def conv_route(dim: int, groups: int) -> str:
    """"kernel" where the JAX package runs its Pallas conv, else "library".

    The rule of the JAX ``ConvPositionEmbedding`` (``layers.py:220-225``):
    dim a multiple of 128 and a group width dividing 128. Decided from the
    shapes alone, before anything is launched.
    """
    return "kernel" if dim % 128 == 0 and 128 % (dim // groups) == 0 else "library"


class ConvPositionEmbedding(nn.Module):
    """Two grouped 1-D convs (k=31, groups=16) with Mish, padding re-masked.

    On the "kernel" route (:func:`conv_route`) each conv is one launch of the
    grouped-conv kernel with bias and Mish fused; the kernel takes group
    widths 16 to 128 in bf16, so a width of 1 to 8 (dim 128 or less) raises
    there and names the width. On the "library" route each is ``F.conv1d``
    with groups, then Mish, as the JAX package hands such shapes to XLA.
    mish(0) = 0, so masking after the conv is exact.
    """

    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16) -> None:
        super().__init__()
        self.groups = groups
        self.route = conv_route(dim, groups)
        self.conv1 = ConvWeights(kernel_size, dim // groups, dim)
        self.conv2 = ConvWeights(kernel_size, dim // groups, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        keep = None if mask is None else mask[..., None]
        if keep is not None:
            x = x.masked_fill(~keep, 0.0)
        conv_fn = grouped_conv1d_mish_grad if self.route == "kernel" else conv_mish_reference
        for conv in (self.conv1, self.conv2):
            x = conv_fn(x, conv.weight, conv.bias, self.groups)
            if keep is not None:
                x = x.masked_fill(~keep, 0.0)
        return x


class DepthwiseConv1d(nn.Module):
    """Depthwise 1-D conv as K shifted multiply-adds (SAME padding)."""

    def __init__(self, dim: int, kernel_size: int = 7, dilation: int = 1) -> None:
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.weight = nn.Parameter(torch.zeros(kernel_size, 1, dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        pad = self.dilation * (self.kernel_size // 2)
        t = x.shape[-2]
        xp = F.pad(x, (0, 0, pad, pad))
        out = None
        for i in range(self.kernel_size):
            tap = xp[..., i * self.dilation: i * self.dilation + t, :]
            term = tap * self.weight[i, 0]
            out = term if out is None else out + term
        return out + self.bias


class GRN(nn.Module):
    """Global Response Normalization over time, with the safe sqrt."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sumsq = torch.sum(x * x, dim=1, keepdim=True)
        gx = torch.sqrt(torch.clamp(sumsq, min=1e-24))
        nx = gx / (torch.mean(gx, dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, dilation: int = 1) -> None:
        super().__init__()
        self.dwconv = DepthwiseConv1d(dim, kernel_size=7, dilation=dilation)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.dwconv(x))
        h = self.grn(F.gelu(self.pwconv1(h)))
        return x + self.pwconv2(h)


def _split_mods(mods: torch.Tensor, n: int) -> list[torch.Tensor]:
    if mods.ndim == 1:
        mods = mods[None, :]
    return list(torch.chunk(mods, n, dim=-1))


class AdaLayerNorm(nn.Module):
    """6-way AdaLN: MSA shift/scale/gate and MLP shift/scale/gate.

    ``mods`` replaces ``linear(silu(emb))`` with a precomputed row (the
    sampler hoists these projections out of the Euler loop).
    """

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.linear = nn.Linear(dim, dim * 6)

    def forward(self, x, emb, mods=None):
        if mods is None:
            mods = self.linear(F.silu(emb))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = _split_mods(mods, 6)
        out = layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return out, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormFinal(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.linear = nn.Linear(dim, dim * 2)

    def forward(self, x, emb, mods=None):
        if mods is None:
            mods = self.linear(F.silu(emb))
        scale, shift = _split_mods(mods, 2)
        return layer_norm(x) * (1 + scale)[:, None] + shift[:, None]


QUANT_MODES = ("int8", "int8_dynamic")


class QDense(nn.Module):
    """Linear layer with int8 weights for serving (``ops/quantized_matmul.py``).

    Stands in for ``nn.Linear`` once ``dit.quantize_dit_params`` has converted
    it: ``weight`` becomes ``weight_q`` int8 ``[out, in]`` and ``scale`` f32
    ``[out]`` (per output channel, symmetric); ``bias`` is unchanged and is
    added after the product in the output's type. ``mode="int8"`` is w8a16
    through the kernel, ``mode="int8_dynamic"`` is w8a8 with dynamic per-token
    activation scales. Inference only: the integer weights carry no gradient.
    ``scale`` must stay f32, so move a quantized model with ``.to(device)``
    and never with ``.to(dtype)``.
    """

    def __init__(self, in_features: int, out_features: int, mode: str = "int8") -> None:
        super().__init__()
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode: {mode!r}")
        self.in_features, self.out_features, self.mode = in_features, out_features, mode
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features))

    @classmethod
    def from_linear(cls, linear: nn.Linear, mode: str) -> "QDense":
        """Quantize a loaded ``nn.Linear`` on its own device; the bias keeps its type."""
        out = cls(linear.in_features, linear.out_features, mode).to(linear.weight.device)
        out.weight_q, out.scale = quantize_weight(linear.weight)
        out.bias = nn.Parameter(linear.bias.detach().clone(), requires_grad=False)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.bias.dtype)
        if self.mode == "int8_dynamic":
            y = w8a8_matmul(x, self.weight_q, self.scale)
        else:
            y = quantized_matmul(x, self.weight_q, self.scale)
        return y + self.bias.to(y.dtype)


def make_dense(in_features: int, out_features: int, quant: str | None = None) -> nn.Module:
    """``nn.Linear``, or :class:`QDense` when a quant mode is set (serving only)."""
    if quant:
        return QDense(in_features, out_features, quant)
    return nn.Linear(in_features, out_features)


ATTN_IMPLS = ("einsum", "lanes", "flash", "packed", "skip")


def resolve_attn_impl(heads: int, dim_head: int, use_flash: bool = True,
                      attn_impl: str | None = None) -> str:
    """The JAX ``Attention``'s choice (``layers.py:484-500``).

    An explicit ``attn_impl`` wins; otherwise ``use_flash`` means "lanes",
    else "einsum". The lanes layout needs H·D ≤ 128, or a multiple of 128
    with D dividing 128: a lanes choice that does not fit falls back to the
    classic "flash", and an explicit "lanes" that does not fit raises.
    """
    impl = attn_impl or ("lanes" if use_flash else "einsum")
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {impl!r}")
    if impl == "lanes":
        inner = heads * dim_head
        if not (inner <= 128 or (inner % 128 == 0 and 128 % dim_head == 0)):
            if attn_impl == "lanes":
                raise ValueError(
                    f"attn_impl='lanes' needs heads*dim_head <= 128 or a "
                    f"multiple of 128 with dim_head dividing 128; got "
                    f"heads={heads}, dim_head={dim_head}")
            impl = "flash"
    return impl


class Attention(nn.Module):
    """Self-attention with RoPE and a key-padding prefix.

    ``impl`` is :func:`resolve_attn_impl`'s choice. "lanes" keeps q/k/v
    ``[B, T, H·D]`` from the projections through the kernel; the others
    reshape to heads-first ``[B, H, T, D]`` and take RoPE there. With
    ``seed`` the projected output is dropped out before the re-mask. The
    parameter names do not depend on ``impl``, so one weight tree loads into
    any of them.
    """

    def __init__(self, dim: int, heads: int, dim_head: int = 64, dropout: float = 0.0,
                 quant: str | None = None, use_flash: bool = True,
                 attn_impl: str | None = None) -> None:
        super().__init__()
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.impl = resolve_attn_impl(heads, dim_head, use_flash, attn_impl)
        inner = heads * dim_head
        self.to_q = make_dense(dim, inner, quant)
        self.to_k = make_dense(dim, inner, quant)
        self.to_v = make_dense(dim, inner, quant)
        self.to_out = make_dense(inner, dim, quant)

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,
        rope: tuple[torch.Tensor, torch.Tensor] | None = None,
        kv_lens: torch.Tensor | None = None,
        seed: int | None = None,
    ) -> torch.Tensor:
        """``rope`` is ``lanes_rope``'s tables for "lanes", ``heads_rope``'s otherwise."""
        B, T, _ = x.shape
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if kv_lens is None:
            kv_lens = (
                mask.sum(dim=-1, dtype=torch.int32) if mask is not None
                else torch.full((B,), T, dtype=torch.int32, device=x.device)
            )
        if self.impl == "lanes":
            if rope is not None:
                q, k = apply_rope_lanes(q, k, rope[0], rope[1], self.heads)
            out = flash_attention_lanes(q, k, v, kv_lens, self.heads)
        else:
            q, k, v = (y.view(B, T, self.heads, self.dim_head).transpose(1, 2) for y in (q, k, v))
            if rope is not None:
                q, k = apply_rope(q, k, rope[0], rope[1])
            if self.impl == "skip":
                out = v + 0.0 * q
            elif self.impl == "flash":
                out = flash_attention_trainable(q, k, v, kv_lens)
            elif self.impl == "packed":
                out = flash_attention_packed(q, k, v, kv_lens)
            else:
                logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
                logits = logits * (1.0 / math.sqrt(self.dim_head))
                if mask is not None:
                    logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
                probs = torch.softmax(logits, dim=-1).to(q.dtype)
                out = torch.matmul(probs, v)
            out = out.transpose(1, 2).reshape(B, T, self.heads * self.dim_head)
        out = self.to_out(out)
        if seed is not None:
            out = hash_dropout(out, seed, self.dropout)
        if mask is not None:
            out = out.masked_fill(~mask[..., None], 0.0)
        return out


class FeedForward(nn.Module):
    """Linear → GELU(tanh) → Dropout → Linear.

    With ``seed`` and ``dropout > 0`` the middle is one fused GELU+dropout
    pass; otherwise (inference, or no dropout) it is ``F.gelu``.
    """

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 quant: str | None = None) -> None:
        super().__init__()
        self.dropout = dropout
        self.in_proj = make_dense(dim, dim * mult, quant)
        self.out_proj = make_dense(dim * mult, dim, quant)

    def forward(self, x: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        h = self.in_proj(x)
        if seed is not None and self.dropout > 0:
            return self.out_proj(gelu_dropout(h, seed, self.dropout))
        return self.out_proj(F.gelu(h, approximate="tanh"))


class DiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int = 64, ff_mult: int = 4,
                 dropout: float = 0.0, quant: str | None = None, use_flash: bool = True,
                 attn_impl: str | None = None) -> None:
        super().__init__()
        self.attn_norm = AdaLayerNorm(dim)
        self.attn = Attention(dim, heads, dim_head, dropout, quant, use_flash, attn_impl)
        self.ff = FeedForward(dim, ff_mult, dropout, quant)

    def forward(self, x, t, mask=None, rope=None, tmods=None, kv_lens=None, seeds=None):
        attn_seed, ff_seed = seeds if seeds is not None else (None, None)
        normed, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.attn_norm(x, t, mods=tmods)
        x = x + gate_msa[:, None] * self.attn(
            normed, mask=mask, rope=rope, kv_lens=kv_lens, seed=attn_seed)
        ff_in = layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        return x + gate_mlp[:, None] * self.ff(ff_in, seed=ff_seed)
