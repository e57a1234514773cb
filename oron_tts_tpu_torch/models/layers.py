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
fused GELU+dropout kernels (``ops/gelu_dropout.py``); AdaLN-Zero's LayerNorm,
modulation, gate and residual add run as three passes a block each way
(``ops/adaln.py``: :class:`AdaLayerNorm`, :class:`AdaLayerNormFinal`, :class:`DiTBlock`);
under int8 serving the six projections of a block are :class:`QDense` and run
the w8a16 kernel (``ops/quantized_matmul.py``). On CPU tensors all take their
plain versions.

Dropout has no module state: a block is deterministic unless it is handed
``seeds = (attention seed, FFN seed)``, two ints drawn by the caller from
its ``torch.Generator``. Both masks are pure functions of their seed and of
each element's place in the global batch (``batch0``, the global index of
the first row a rank holds), so a rematerialised block redraws the same
ones and a mesh rank draws its slice of the single-process masks.

Tensor parallelism (Megatron, ``parallel/mesh.py``): after
:meth:`Attention.shard` and :meth:`FeedForward.shard` a module holds
``heads/TP`` heads and ``ff_mult·dim/TP`` hidden features of the
column-parallel ``to_q``/``to_k``/``to_v`` and ``in_proj``, and the matching
input columns of the row-parallel ``to_out`` and ``out_proj``. The input of
the column-parallel projections passes :class:`CopyToModel` (its gradient
is summed over the model group in the backward); the row-parallel products
are summed over the model group by :class:`SumOverModel` and their bias is
added once, after the sum. The attention impl is resolved again on the
local head count; ``unshard`` on each module restores the whole-model state
once the backbone has gathered the projections back.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from oron_tts_tpu_torch.ops.adaln import adaln_modulate, gate_residual, gate_residual_modulate
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
from oron_tts_tpu_torch.parallel.mesh import all_reduce_sum
from oron_tts_tpu_torch.utils import trace

__all__ = [
    "mish", "sinusoidal_embedding", "rope_tables", "apply_rope", "apply_rope_lanes",
    "apply_partial_rope", "apply_partial_rope_lanes",
    "text_position_table", "RMSNorm", "TimestepEmbedding", "conv_route", "ConvPositionEmbedding",
    "DepthwiseConv1d", "GRN", "ConvNeXtV2Block", "AdaLayerNorm",
    "AdaLayerNormFinal", "QDense", "make_dense", "ATTN_IMPLS", "resolve_attn_impl",
    "Attention", "JointAttention", "FeedForward", "DiTBlock", "CopyToModel", "SumOverModel",
    "TensorParallel",
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
def lanes_rope(seq_len: int, dim_head: int, heads: int, device: str, dtype: torch.dtype,
               streams: int = 1):
    """cos/sin tiled over heads to [1, streams·T, H·D] on ``device`` in ``dtype``: each of
    ``streams`` streams laid end to end over its own positions 0 .. T − 1."""
    cos, sin = rope_tables(seq_len, dim_head)
    return tuple(
        torch.from_numpy(np.tile(a, (streams, heads))[None]).to(device=device, dtype=dtype)
        for a in (cos, sin)
    )


@functools.lru_cache(maxsize=16)
def heads_rope(seq_len: int, dim_head: int, device: str, dtype: torch.dtype, streams: int = 1):
    """cos/sin [streams·T, D] on ``device`` in ``dtype``, for :func:`apply_rope`."""
    return tuple(torch.from_numpy(np.tile(a, (streams, 1))).to(device=device, dtype=dtype)
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


def apply_partial_rope(q, k, cos, sin, n: int):
    """RoPE on the first ``n`` heads of heads-first q, k ``[B, H, T, D]``; the rest as
    they are (F5-TTS's ``pe_attn_head``)."""
    qr, kr = apply_rope(q[:, :n], k[:, :n], cos, sin)
    return torch.cat([qr, q[:, n:]], dim=1), torch.cat([kr, k[:, n:]], dim=1)


def apply_partial_rope_lanes(q, k, cos_l, sin_l, n: int):
    """RoPE on the first ``n`` heads of the lanes layout ``[B, T, H·D]``, whose lanes
    lead; ``cos_l``/``sin_l`` are :func:`lanes_rope`'s tables for ``n`` heads."""
    w = cos_l.shape[-1]
    qr, kr = apply_rope_lanes(q[..., :w], k[..., :w], cos_l, sin_l, n)
    return torch.cat([qr, q[..., w:]], dim=-1), torch.cat([kr, k[..., w:]], dim=-1)


def text_position_table(dim: int, max_pos: int = 8192, theta: float = 10000.0) -> np.ndarray:
    """Sinusoidal text positions [max_pos, dim]: cat(cos, sin)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    angles = np.outer(np.arange(max_pos, dtype=np.float64), freqs)
    return np.concatenate([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


class RMSNorm(nn.Module):
    """F5-TTS's RMSNorm: the mean square in f32, eps 1e-6, then a weight; the
    normalised input is cast to a half-precision weight's type before the product."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        variance = x.float().pow(2).mean(-1, keepdim=True)
        x = x * torch.rsqrt(variance + self.eps)
        if self.weight.dtype in (torch.float16, torch.bfloat16):
            x = x.to(self.weight.dtype)
        return x * self.weight


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
    grouped-conv kernel with bias and Mish fused; the kernel takes every
    width that route sends it (1 to 128). On the "library" route each is
    ``F.conv1d`` with groups, then Mish, as the JAX package hands such shapes
    to XLA.
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
        return adaln_modulate(x, scale_msa, shift_msa), gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormFinal(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.linear = nn.Linear(dim, dim * 2)

    def forward(self, x, emb, mods=None):
        if mods is None:
            mods = self.linear(F.silu(emb))
        scale, shift = _split_mods(mods, 2)
        return adaln_modulate(x, scale, shift)


QUANT_MODES = ("int8", "int8_dynamic")


class QDense(nn.Module):
    """Linear layer with int8 weights for serving (``ops/quantized_matmul.py``).

    Stands in for ``nn.Linear`` once ``dit.quantize_dit_params`` has converted
    it: ``weight`` becomes ``weight_q`` int8 ``[out, in]`` and ``scale`` f32
    ``[out]`` (per output channel, symmetric); ``bias`` is unchanged and is
    added to the product rounded to the output's type, in that type (the JAX
    ``QDense``'s two roundings). ``mode="int8"`` is w8a16 through the kernel,
    which adds the bias in its epilogue; ``mode="int8_dynamic"`` is w8a8 with
    dynamic per-token activation scales, the bias added after it. Inference only: the integer weights carry no gradient.
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
            return y + self.bias.to(y.dtype)
        return quantized_matmul(x, self.weight_q, self.scale, bias=self.bias)

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The product without the bias: a row-parallel shard's partial sum.

        ``int8_dynamic`` only (the w8a16 kernel has no sharded form); its
        per-token activation scale is then taken over this shard's columns.
        """
        if self.mode != "int8_dynamic":
            raise NotImplementedError("w8a16 int8 serving is single-device; use int8_dynamic")
        return w8a8_matmul(x.to(self.bias.dtype), self.weight_q, self.scale)


def make_dense(in_features: int, out_features: int, quant: str | None = None) -> nn.Module:
    """``nn.Linear``, or :class:`QDense` when a quant mode is set (serving only)."""
    if quant:
        return QDense(in_features, out_features, quant)
    return nn.Linear(in_features, out_features)


class CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.group), None


class SumOverModel(torch.autograd.Function):
    """Sums the row-parallel partial products over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TensorParallel:
    """This module's place in the model group: rank, size and the group."""

    def __init__(self, rank: int, size: int, group) -> None:
        self.rank, self.size, self.group = rank, size, group

    def split(self, n: int, what: str) -> int:
        if n % self.size:
            raise ValueError(f"{what} ({n}) does not split over {self.size} model ranks")
        return n // self.size


def _take(param: torch.Tensor, axis: int, tp: TensorParallel) -> nn.Parameter | torch.Tensor:
    size = param.shape[axis] // tp.size
    part = param.detach().narrow(axis, tp.rank * size, size).clone()
    if isinstance(param, nn.Parameter):
        return nn.Parameter(part, requires_grad=param.requires_grad)
    return part


def _shard_dense(layer: nn.Module, axis: int, tp: TensorParallel) -> None:
    """Keep this rank's slice of a projection: axis 0 column-, 1 row-parallel."""
    if isinstance(layer, QDense):
        layer.weight_q = _take(layer.weight_q, axis, tp)
        if axis == 0:
            layer.scale = _take(layer.scale, 0, tp)
    else:
        layer.weight = _take(layer.weight, axis, tp)
    if axis == 0:
        layer.bias = _take(layer.bias, 0, tp)


def _column_input(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    return x if tp is None else CopyToModel.apply(x, tp.group)


def _row_parallel(layer: nn.Module, x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """``layer(x)``; under TP the partial products summed, then the bias once."""
    if tp is None:
        return layer(x)
    if isinstance(layer, QDense):
        y = layer.product(x)
    else:
        y = F.linear(x, layer.weight)
    y = SumOverModel.apply(y, tp.group)
    return y + layer.bias.to(y.dtype)


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


def kv_lengths(mask: torch.Tensor | None, rows: int, length: int, device) -> torch.Tensor:
    """Keys each row attends to, int32 ``[rows]``: the mask's count, or ``length``."""
    return (mask.sum(dim=-1, dtype=torch.int32) if mask is not None
            else torch.full((rows,), length, dtype=torch.int32, device=device))


class Attention(nn.Module):
    """Self-attention with RoPE and a key-padding prefix.

    ``impl`` is :func:`resolve_attn_impl`'s choice. "lanes" keeps q/k/v
    ``[B, T, H·D]`` from the projections through the kernel; the others
    reshape to heads-first ``[B, H, T, D]`` and take RoPE there. With
    ``seed`` the projected output is dropped out and re-masked in one pass
    (:func:`hash_dropout`); without, only re-masked. The
    parameter names do not depend on ``impl``, so one weight tree loads into
    any of them. ``pe_attn_head`` rotates only the model's first heads (E2's
    UNetT: 1); ``rope_heads`` is how many of this module's heads that is
    (None: all), and the key bias then reaches those heads alone
    (:meth:`_keys`). The RoPE tables are built here, for ``impl``, the heads
    rotated and the input's length, device and dtype (:func:`lanes_rope`,
    :func:`heads_rope`, both cached): none where no head is rotated.
    """

    def __init__(self, dim: int, heads: int, dim_head: int = 64, dropout: float = 0.0,
                 quant: str | None = None, use_flash: bool = True,
                 attn_impl: str | None = None, pe_attn_head: int | None = None) -> None:
        super().__init__()
        self.dim_head, self.dropout = dim_head, dropout
        self.pe_attn_head = pe_attn_head
        self._impl_choice = (use_flash, attn_impl)
        self._place(heads, None)
        inner = heads * dim_head
        self.to_q = make_dense(dim, inner, quant)
        self.to_k = make_dense(dim, inner, quant)
        self.to_v = make_dense(dim, inner, quant)
        self.to_out = make_dense(inner, dim, quant)

    def _place(self, heads: int, tp: TensorParallel | None) -> None:
        """Hold ``heads`` heads at ``tp``'s rank, which holds the model's heads
        ``[rank·heads, (rank + 1)·heads)``: it rotates a prefix of its own, maybe none."""
        self.heads, self.tp = heads, tp
        self.rope_heads = None if self.pe_attn_head is None else max(
            0, min(heads, self.pe_attn_head - (0 if tp is None else tp.rank * heads)))
        self.impl = resolve_attn_impl(heads, self.dim_head, *self._impl_choice)

    def shard(self, tp: TensorParallel) -> None:
        """Keep ``heads/TP`` heads (Megatron): q/k/v by rows, ``to_out`` by columns."""
        heads = tp.split(self.heads, "heads")
        for layer in (self.to_q, self.to_k, self.to_v):
            _shard_dense(layer, 0, tp)
        _shard_dense(self.to_out, 1, tp)
        self._place(heads, tp)

    def unshard(self) -> None:
        """Every head again, once the projections are whole (the backbone gathers them)."""
        if self.tp is not None:
            self._place(self.heads * self.tp.size, None)

    def _keys(self, x: torch.Tensor) -> torch.Tensor:
        """``to_k(x)``; under ``pe_attn_head`` the bias only on the rotated heads' lanes.

        A key bias adds ``q·b`` to every score of a query, which softmax takes no
        notice of, unless RoPE turns ``b`` with each key's position. So an unrotated
        head's bias is inert: left out, it gets an exact zero gradient rather than
        rounding noise that AdamW would make into full-size steps."""
        layer = self.to_k
        if self.rope_heads is None or not isinstance(layer, nn.Linear):
            return layer(x)
        width = self.rope_heads * self.dim_head
        bias = torch.cat([layer.bias[:width], torch.zeros_like(layer.bias[width:])])
        return F.linear(x, layer.weight, bias)

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,
        kv_lens: torch.Tensor | None = None,
        seed: int | None = None,
        batch0: int = 0,
    ) -> torch.Tensor:
        """``batch0`` is the global index of ``x``'s first row (the dropout mask's place)."""
        B, T, _ = x.shape
        xc = _column_input(x, self.tp)
        q, k, v = self.to_q(xc), self._keys(xc), self.to_v(xc)
        if kv_lens is None:
            kv_lens = kv_lengths(mask, B, T, x.device)
        return self._output(self._attend(q, k, v, kv_lens, mask, T, x.dtype), mask, seed, batch0)

    def _attend(self, q, k, v, kv_lens, key_mask, positions: int, dtype) -> torch.Tensor:
        """RoPE and attention of q, k, v ``[B, L, H·D]``, ``L`` being one or more streams of
        ``positions`` laid end to end, each rotated over its own positions; keys past a
        row's ``kv_lens`` (``key_mask``'s prefix) are masked. Returns ``[B, L, H·D]``."""
        B, L, _ = q.shape
        n, dev, streams = self.rope_heads, str(q.device), L // positions
        if self.impl == "lanes":
            if n is None:
                cos, sin = lanes_rope(positions, self.dim_head, self.heads, dev, dtype, streams)
                q, k = apply_rope_lanes(q, k, cos, sin, self.heads)
            elif n:
                cos, sin = lanes_rope(positions, self.dim_head, n, dev, dtype, streams)
                q, k = apply_partial_rope_lanes(q, k, cos, sin, n)
            return flash_attention_lanes(q, k, v, kv_lens, self.heads)
        q, k, v = (y.view(B, L, self.heads, self.dim_head).transpose(1, 2) for y in (q, k, v))
        if n != 0:
            cos, sin = heads_rope(positions, self.dim_head, dev, dtype, streams)
            q, k = (apply_rope(q, k, cos, sin) if n is None
                    else apply_partial_rope(q, k, cos, sin, n))
        if self.impl == "skip":
            out = v + 0.0 * q
        elif self.impl == "flash":
            out = flash_attention_trainable(q, k, v, kv_lens)
        elif self.impl == "packed":
            out = flash_attention_packed(q, k, v, kv_lens)
        else:
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
            logits = logits * (1.0 / math.sqrt(self.dim_head))
            if key_mask is not None:
                logits = logits.masked_fill(~key_mask[:, None, None, :], -1e9)
            probs = torch.softmax(logits, dim=-1).to(q.dtype)
            out = torch.matmul(probs, v)
        return out.transpose(1, 2).reshape(B, L, self.heads * self.dim_head)

    def _output(self, out, mask, seed: int | None, batch0: int) -> torch.Tensor:
        """``to_out``, then with ``seed`` dropout and the re-mask in one pass each way;
        without, the re-mask alone."""
        T = out.shape[1]
        out = _row_parallel(self.to_out, out, self.tp)
        if seed is not None:
            return hash_dropout(out, seed, self.dropout, row0=batch0 * T, rows=mask)
        if mask is not None:
            out = out.masked_fill(~mask[..., None], 0.0)
        return out


class JointAttention(Attention):
    """SD3's joint attention (MMDiT): audio ``x`` and text ``c`` ``[B, T, dim]``, each with
    its own q/k/v projections, attend as one sequence ``[c; x]`` of ``2T``.

    RoPE turns each stream over its own positions 0 .. T − 1. Every text key is
    admitted (upstream masks none), so the joint key mask is still a per-row prefix,
    ``kv_lens = T + len``, and the lanes kernels take it unchanged. The output is split
    back: the audio part through ``to_out``, dropout and the pad-row re-mask
    (:meth:`Attention._output`), the text part through ``to_out_c`` alone. With
    ``context_pre_only`` (the last block) the text gives keys and values only: there is
    no ``to_q_c`` and no ``to_out_c``, and the text rows of the joint query are zeros,
    since the lanes kernels take one length for queries and keys (their output is
    dropped). Span ``mmdit.joint`` (``utils/trace.py``) covers the concatenation of the
    streams and the split of the output. Tensor parallelism is not built for it.
    """

    def __init__(self, dim: int, heads: int, dim_head: int = 64, dropout: float = 0.0,
                 quant: str | None = None, use_flash: bool = True,
                 attn_impl: str | None = None, context_pre_only: bool = False) -> None:
        super().__init__(dim, heads, dim_head, dropout, quant, use_flash, attn_impl)
        inner = heads * dim_head
        self.context_pre_only = context_pre_only
        if not context_pre_only:
            self.to_q_c = make_dense(dim, inner, quant)
        self.to_k_c = make_dense(dim, inner, quant)
        self.to_v_c = make_dense(dim, inner, quant)
        if not context_pre_only:
            self.to_out_c = make_dense(inner, dim, quant)

    def shard(self, tp: TensorParallel) -> None:
        raise NotImplementedError("JointAttention has no tensor-parallel split")

    def forward(self, x, c, kv_lens, mask=None, key_mask=None, seed=None, batch0=0):
        """``(audio output, text output)``; the text output is None with
        ``context_pre_only``. ``kv_lens`` and ``key_mask`` are the joint keys (``T + len``;
        ``[B, 2T]``), ``mask`` the audio's ``[B, T]`` prefix (None: no padding)."""
        T = x.shape[1]
        qx, kx, vx = self.to_q(x), self.to_k(x), self.to_v(x)
        qc = None if self.context_pre_only else self.to_q_c(c)
        kc, vc = self.to_k_c(c), self.to_v_c(c)
        with trace.span("mmdit.joint"):
            q = F.pad(qx, (0, 0, T, 0)) if qc is None else torch.cat([qc, qx], dim=1)
            k, v = torch.cat([kc, kx], dim=1), torch.cat([vc, vx], dim=1)
        out = self._attend(q, k, v, kv_lens, key_mask, T, x.dtype)
        with trace.span("mmdit.joint"):
            out_c, out_x = out[:, :T], out[:, T:]
        y_c = None if self.context_pre_only else self.to_out_c(out_c)
        return self._output(out_x, mask, seed, batch0), y_c


class FeedForward(nn.Module):
    """Linear → GELU(tanh) → Dropout → Linear.

    With ``seed`` and ``dropout > 0`` the middle is one fused GELU+dropout
    pass; otherwise (inference, or no dropout) it is ``F.gelu``.
    """

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 quant: str | None = None) -> None:
        super().__init__()
        self.dropout = dropout
        self.hidden = dim * mult
        self.in_proj = make_dense(dim, dim * mult, quant)
        self.out_proj = make_dense(dim * mult, dim, quant)
        self.tp: TensorParallel | None = None

    def shard(self, tp: TensorParallel) -> None:
        """Keep ``ff_mult·dim/TP`` hidden features: ``in_proj`` by rows, ``out_proj`` by columns."""
        tp.split(self.hidden, "ff_mult*dim")
        _shard_dense(self.in_proj, 0, tp)
        _shard_dense(self.out_proj, 1, tp)
        self.tp = tp

    def unshard(self) -> None:
        """Every hidden feature again, once the projections are whole."""
        self.tp = None

    def forward(self, x: torch.Tensor, seed: int | None = None, batch0: int = 0) -> torch.Tensor:
        h = self.in_proj(_column_input(x, self.tp))
        if seed is not None and self.dropout > 0:
            col0 = 0 if self.tp is None else self.tp.rank * h.shape[-1]
            h = gelu_dropout(h, seed, self.dropout, row0=batch0 * x.shape[1],
                             gcols=self.hidden, col0=col0)
        else:
            h = F.gelu(h, approximate="tanh")
        return _row_parallel(self.out_proj, h, self.tp)


class DiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int = 64, ff_mult: int = 4,
                 dropout: float = 0.0, quant: str | None = None, use_flash: bool = True,
                 attn_impl: str | None = None) -> None:
        super().__init__()
        self.attn_norm = AdaLayerNorm(dim)
        self.attn = Attention(dim, heads, dim_head, dropout, quant, use_flash, attn_impl)
        self.ff = FeedForward(dim, ff_mult, dropout, quant)

    def shard(self, tp: TensorParallel) -> None:
        self.attn.shard(tp)
        self.ff.shard(tp)

    def unshard(self) -> None:
        self.attn.unshard()
        self.ff.unshard()

    def forward(self, x, t, mask=None, tmods=None, kv_lens=None, seeds=None, batch0=0):
        attn_seed, ff_seed = seeds if seeds is not None else (None, None)
        normed, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.attn_norm(x, t, mods=tmods)
        y = self.attn(normed, mask=mask, kv_lens=kv_lens, seed=attn_seed, batch0=batch0)
        x, ff_in = gate_residual_modulate(x, y, gate_msa, scale_mlp, shift_mlp)
        return gate_residual(x, self.ff(ff_in, seed=ff_seed, batch0=batch0), gate_mlp)
