"""Attention kernels, lanes and classic layout, and their plain PyTorch versions.

``flash_lanes_fwd(q, k, v, kv_lens, heads)`` computes non-causal softmax
attention on ``[B, T, H·D]`` tensors, keys at or beyond ``kv_lens[b]``
masked, exactly as the JAX package's ``flash_attention_lanes`` forward.
Every kernel of this module takes the head widths :func:`kernel_head_dim_ok`
admits: any width, as the JAX kernels do, except the lanes backward, which
stops at 128 (the widest head the lanes rule admits) and raises above it
before any launch. The kernels themselves take multiples of 8 (16-byte rows),
so the wrappers zero-pad any other width to the next multiple of 8 (per head,
inside ``[B, T, H·D]`` for the lanes layout), pass the score scale 1/√D of
the true width, and slice the outputs and gradients back; inside, a width to
256 that is not a multiple of 16 runs padded to the next one, and a wider one
runs the kernels' wide bodies (D in chunks, 128 output columns a block).

- CUDA tensors launch ``csrc/flash_lanes.cu`` (bf16: ``wgmma`` tensor cores
  fed by a ``cp.async`` ring, ``csrc/flash_fwd.cuh``; f32: true-f32 SIMT), or
  raise.
- CPU tensors take :func:`flash_lanes_plain`.

The kernel replaces ``oron_tts_tpu/ops/flash_attention.py:387``
(``_flash_lanes_kernel``). The source note in the ``.cu`` file says what
bounds it on the H100 and how its design answers that.

Training goes through :func:`flash_attention_lanes`, a
``torch.autograd.Function`` like the JAX package's custom VJP
(``flash_attention.py:710-743``): when a gradient is needed its forward is
:func:`flash_lanes_fwd_stats` (the same output bit for bit, plus the row
statistic ``lse2``; replaces ``_flash_lanes_fwd_stats_kernel``, ``:424``)
and its backward is :func:`flash_lanes_bwd` (``csrc/flash_lanes_bwd.cu``;
replaces ``_flash_lanes_bwd_kernel``, ``:528``; bf16 on ``wgmma``, two
launches). ``lse2`` is
``m + log2(max(l, 1e-30))`` in base-2 units of the scaled scores, stored
``[B, H, T]`` f32 (the JAX package keeps ``[B, H·D/128, 128/D, T]``). On CPU
tensors the same Function calls the plain versions. A row with
``kv_len = 0`` has ``lse2 = log2 T`` here and −1e30 in the JAX package
(its −1e30 mask absorbs ``log2 T``), and zero gradients; training never
sends a non-zero gradient into such a row.

The classic ``[B, H, T, D]`` family (the JAX package's ``attn_impl`` "flash"
and "packed", and the attention bench's split) is at the end of the module:
:func:`flash_attention` (kernel ``flash_classic_fwd``, replaces ``:32``
``_flash_kernel``), :func:`flash_attention_trainable` (its backward
:func:`flash_attention_bwd`, ``csrc/flash_classic_bwd.cu``, replaces ``:749``
``_flash_bwd_kernel``), :func:`flash_attention_packed` (``flash_packed_fwd``,
replaces ``:246`` ``_flash_packed_kernel``) and :func:`flash_nosm`
(``flash_nosm``, replaces ``scripts/bench_attention.py:128 _nosm_kernel``).
Their TPU tiling arguments (``block_q``, ``block_k``, ``dim_semantics``,
``ORON_FLASH_BLOCK_Q``) size VMEM and have no counterpart here. Unlike the
lanes backward, the classic one gives a ``kv_len = 0`` row the JAX kernel's
gradients (equal weights over all T keys, non-zero dq, dk, dv).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # the TPU kernel's key mask value
LOG2_E = 1.4426950408889634
# The lanes backward keeps 128: the lanes rule (models/layers.py
# resolve_attn_impl, after the JAX layers.py:484-500) sends no wider head to
# the lanes kernels, so flash_lanes_bwd.cu builds no wider variant.
LANES_BWD_MAX_HEAD_DIM = 128


def kernel_head_dim_ok(dim_head: int) -> bool:
    """Whether the attention kernels take this head width (either dtype).

    Every classic kernel and the lanes forwards take any width, as the JAX
    kernels do (above 256 through the kernels' wide bodies, whose shared
    memory and registers do not grow with the width); the lanes backward
    stops at ``LANES_BWD_MAX_HEAD_DIM``, which the lanes rule never exceeds.
    """
    return dim_head >= 1


def _width(name: str, dim_head: int) -> int:
    """The kernel width for ``dim_head``: the next multiple of 8, or raise."""
    if not kernel_head_dim_ok(dim_head):
        raise ValueError(f"{name} takes head widths of 1 or more, got {dim_head}")
    return -(-dim_head // 8) * 8


def _pad_lanes(x: torch.Tensor, heads: int, dp: int) -> torch.Tensor:
    """``[B, T, H·D]`` → ``[B, T, H·dp]``, each head's columns zero-padded to dp."""
    B, T, HD = x.shape
    d = HD // heads
    if d == dp:
        return x
    return F.pad(x.reshape(B, T, heads, d), (0, dp - d)).reshape(B, T, heads * dp)


def _unpad_lanes(x: torch.Tensor, heads: int, d: int) -> torch.Tensor:
    B, T, HDp = x.shape
    if HDp == heads * d:
        return x
    return x.reshape(B, T, heads, HDp // heads)[..., :d].reshape(B, T, heads * d)


def _pad_last(x: torch.Tensor, dp: int) -> torch.Tensor:
    return x if x.shape[-1] == dp else F.pad(x, (0, dp - x.shape[-1]))


def _unpad_last(x: torch.Tensor, d: int) -> torch.Tensor:
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def flash_lanes_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_lens: torch.Tensor,
    heads: int,
) -> torch.Tensor:
    """Heads-first matmul + masked softmax in f32; output in q's dtype.

    P is cast to v's dtype before the PV product and the sum is divided by
    max(l, 1e-30), as the TPU kernel does.
    """
    return flash_lanes_fwd_stats_plain(q, k, v, kv_lens, heads)[0]


def _heads_first(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, HD = x.shape
    return x.reshape(B, T, heads, HD // heads).transpose(1, 2)


def _scaled_scores(q, k, kv_lens, heads):
    """Masked scores in base-2 units, f32 ``[B, H, T, T]``, and the key mask."""
    d = q.shape[-1] // heads
    qh, kh = _heads_first(q, heads), _heads_first(k, heads)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    s = s * (1.0 / math.sqrt(d) * math.log2(math.e))
    valid = torch.arange(q.shape[1], device=q.device)[None, :] < kv_lens.to(q.device)[:, None]
    valid = valid[:, None, None, :]
    return torch.where(valid, s, torch.full_like(s, NEG_INF)), valid


def flash_lanes_fwd_stats_plain(q, k, v, kv_lens, heads):
    """:func:`flash_lanes_plain` plus ``lse2 [B, H, T]`` f32.

    ``lse2 = m + log2(max(l, 1e-30))``; a row whose keys are all masked gets
    ``log2 T`` (equal weights), as the kernel writes it.
    """
    B, T, HD = q.shape
    s, valid = _scaled_scores(q, k, kv_lens, heads)
    s = torch.where(valid.any(dim=-1, keepdim=True), s, torch.zeros_like(s))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), _heads_first(v, heads).float())
    out = (acc / l).transpose(1, 2).reshape(B, T, HD).to(q.dtype)
    return out, (m + torch.log2(l)).squeeze(-1)


def flash_lanes_bwd_plain(q, k, v, kv_lens, out, dout, lse2, heads):
    """dq, dk, dv as the TPU backward computes them (``flash_attention.py:528``).

    ``p = exp2(s − lse2)`` with masked keys 0, ``dp = dO·Vᵀ``,
    ``delta = rowsum(dO ∘ O)`` in f32, ``ds = p·(dp − delta)/√D``; ``ds`` and
    ``p`` are rounded to the input dtype before ``dq = ds·K``, ``dk = dsᵀ·Q``
    and ``dv = pᵀ·dO``, which accumulate in f32. Rows with ``kv_len ≤ 0``
    get zeros.
    """
    B, T, HD = q.shape
    d = HD // heads
    s, valid = _scaled_scores(q, k, kv_lens, heads)
    p = torch.where(valid, torch.exp2(s - lse2[..., None]), torch.zeros_like(s))
    qh, kh, vh = (_heads_first(x, heads).float() for x in (q, k, v))
    doh, oh = _heads_first(dout, heads).float(), _heads_first(out, heads).float()
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * (1.0 / math.sqrt(d))).to(q.dtype).float()
    p = p.to(q.dtype).float()

    def lanes(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2).reshape(B, T, HD).to(like.dtype)

    dq = lanes(torch.matmul(ds, kh), q)
    dk = lanes(torch.matmul(ds.transpose(-1, -2), qh), k)
    dv = lanes(torch.matmul(p.transpose(-1, -2), doh), v)
    return dq, dk, dv


def _dense(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernels load 16 bytes at a time)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _checked(name, q, k, v, kv_lens, heads):
    """Validate a CUDA call's arguments.

    Returns q, k, v contiguous and padded to the kernel width dp, int32 lens,
    the true head width d and dp.
    """
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, T, HD = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B, T, H·D] shape")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes bf16 or f32 q/k/v, got {q.dtype}")
    if HD % heads:
        raise ValueError(f"{name}: H·D = {HD} is not a multiple of heads = {heads}")
    d = HD // heads
    dp = _width(name, d)
    lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError(f"kv_lens must be [B]={B}, got {tuple(lens.shape)}")
    q, k, v = (_dense(_pad_lanes(x, heads, dp)) for x in (q, k, v))
    return q, k, v, lens, d, dp


def flash_lanes_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_lens: torch.Tensor,
    heads: int,
) -> torch.Tensor:
    """Attention over ``[B, T, H·D]``; the kernel on CUDA, the plain version on CPU."""
    if q.device.type == "cpu":
        return flash_lanes_plain(q, k, v, kv_lens, heads)
    from oron_tts_tpu_torch.ops import _build

    q, k, v, lens, d, dp = _checked("flash_lanes_fwd", q, k, v, kv_lens, heads)
    B, T, _ = q.shape
    out = torch.empty_like(q)
    lib = _build.load("flash_lanes")
    err = lib.flash_lanes_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, T, heads, dp, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_lanes_fwd")
    flash_lanes_fwd.launches += 1
    return _unpad_lanes(out, heads, d)


flash_lanes_fwd.launches = 0


def flash_lanes_fwd_stats(q, k, v, kv_lens, heads):
    """``(out, lse2 [B, H, T] f32)``: the forward a backward will follow."""
    if q.device.type == "cpu":
        return flash_lanes_fwd_stats_plain(q, k, v, kv_lens, heads)
    from oron_tts_tpu_torch.ops import _build

    q, k, v, lens, d, dp = _checked("flash_lanes_fwd_stats", q, k, v, kv_lens, heads)
    B, T, _ = q.shape
    out = torch.empty_like(q)
    lse2 = torch.empty((B, heads, T), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_lanes")
    err = lib.flash_lanes_fwd_stats(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), lse2.data_ptr(), B, T, heads, dp, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_lanes_fwd_stats")
    flash_lanes_fwd_stats.launches += 1
    return _unpad_lanes(out, heads, d), lse2


flash_lanes_fwd_stats.launches = 0


def flash_lanes_bwd(q, k, v, kv_lens, out, dout, lse2, heads):
    """``(dq, dk, dv)``; the kernel on CUDA, the plain version on CPU."""
    if q.device.type == "cpu":
        return flash_lanes_bwd_plain(q, k, v, kv_lens, out, dout, lse2, heads)
    from oron_tts_tpu_torch.ops import _build

    shape = q.shape
    if shape[-1] // heads > LANES_BWD_MAX_HEAD_DIM:
        raise ValueError(f"flash_lanes_bwd takes head widths from 1 to "
                         f"{LANES_BWD_MAX_HEAD_DIM}, got {shape[-1] // heads}")
    q, k, v, lens, d, dp = _checked("flash_lanes_bwd", q, k, v, kv_lens, heads)
    B, T, _ = q.shape
    if out.shape != shape or dout.shape != shape or out.dtype != q.dtype:
        raise ValueError("out and dout must match q's shape and dtype")
    if lse2.shape != (B, heads, T) or lse2.dtype != torch.float32:
        raise ValueError(f"lse2 must be f32 [B, H, T], got {tuple(lse2.shape)} {lse2.dtype}")
    out, dout = (_dense(_pad_lanes(x, heads, dp)) for x in (out, dout.to(q.dtype)))
    lse2 = lse2.contiguous()
    delta = torch.empty_like(lse2)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    lib = _build.load("flash_lanes_bwd")
    err = lib.flash_lanes_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse2.data_ptr(), lens.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, heads, dp, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), 3, _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_lanes_bwd")
    flash_lanes_bwd.launches += 1
    return tuple(_unpad_lanes(x, heads, d) for x in (dq, dk, dv))


flash_lanes_bwd.launches = 0


class _FlashAttentionLanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lens, heads):
        out, lse2 = flash_lanes_fwd_stats(q, k, v, kv_lens, heads)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse2)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, out, lse2 = ctx.saved_tensors
        dq, dk, dv = flash_lanes_bwd(q, k, v, kv_lens, out, dout, lse2, ctx.heads)
        return dq, dk, dv, None, None


def flash_attention_lanes(q, k, v, kv_lens, heads):
    """Differentiable lanes attention: stats forward + backward kernel when a
    gradient is needed, the plain forward kernel otherwise."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttentionLanes.apply(q, k, v, kv_lens, heads)
    return flash_lanes_fwd(q, k, v, kv_lens, heads)


# ── classic layout [B, H, T, D] ──────────────────────────────────────────


def _lens(kv_mask, kv_lens):
    """Prefix lengths from ``kv_lens`` or a prefix mask; None stays None (no mask)."""
    if kv_lens is None and kv_mask is not None:
        kv_lens = kv_mask.to(torch.int32).sum(dim=-1)
    return kv_lens


def _classic_scores(q, k, kv_lens, use_exp2=True):
    """f32 scores times the scale (with log2 e under exp2), masked keys −1e30."""
    T, D = q.shape[-2:]
    sm_scale = 1.0 / math.sqrt(D)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * (sm_scale * LOG2_E if use_exp2 else sm_scale)
    if kv_lens is not None:
        valid = torch.arange(T, device=q.device)[None, :] < kv_lens.to(q.device)[:, None]
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_plain(q, k, v, kv_mask=None, kv_lens=None, use_exp2=True):
    """The TPU kernel's arithmetic (``flash_attention.py:32``) in plain PyTorch.

    Scores in f32, masked keys −1e30 after scaling, ``p = exp2(s − m)`` (or
    ``exp``), ``l`` summed in f32, P cast to v's dtype before P·V, the output
    divided by ``max(l, 1e-30)`` and returned in q's dtype. A row with
    ``kv_len = 0`` averages V over all T keys, as the −1e30 fill gives.
    """
    s = _classic_scores(q, k, _lens(kv_mask, kv_lens), use_exp2)
    p = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp2(p) if use_exp2 else torch.exp(p)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype)


def _checked_classic(name, q, k, v, kv_lens):
    """Validate a classic CUDA call.

    Returns q, k, v contiguous and padded to the kernel width dp, int32 lens
    (T if None), the true head width d and dp.
    """
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k and v must share one [B, H, T, D] shape")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes bf16 or f32 q/k/v, got {q.dtype}")
    B, H, T, d = q.shape
    dp = _width(name, d)
    if kv_lens is None:
        lens = torch.full((B,), T, dtype=torch.int32, device=q.device)
    else:
        lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError(f"kv_lens must be [B]={B}, got {tuple(lens.shape)}")
    q, k, v = (_dense(_pad_last(x, dp)) for x in (q, k, v))
    return q, k, v, lens, d, dp


def flash_attention(q, k, v, kv_mask=None, kv_lens=None, use_exp2=True):
    """Attention over ``[B, H, T, D]`` with prefix ``kv_lens`` (or ``kv_mask``).

    Returns ``[B, H, T, D]`` in q's dtype. With neither, every key counts.
    CUDA tensors launch ``flash_classic_fwd`` (``csrc/flash_classic.cu``) or
    raise; CPU tensors take :func:`flash_attention_plain`.
    """
    kv_lens = _lens(kv_mask, kv_lens)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lens=kv_lens, use_exp2=use_exp2)
    from oron_tts_tpu_torch.ops import _build

    q, k, v, lens, d, dp = _checked_classic("flash_attention", q, k, v, kv_lens)
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    err = _build.load("flash_classic").flash_classic_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, H, T, dp, 1.0 / math.sqrt(d), int(use_exp2), int(q.dtype == torch.bfloat16),
        _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_classic_fwd")
    flash_attention.launches += 1
    return _unpad_last(out, d)


flash_attention.launches = 0


def flash_attention_bwd_plain(q, k, v, kv_lens, out, dout):
    """dq, dk, dv as the TPU backward computes them (``flash_attention.py:749``).

    The row max and sum are recomputed from ``s = q·Kᵀ`` (no saved
    statistics): ``p = exp2(s − m) / max(l, 1e-30)``, ``dp = dO·Vᵀ`` (dO cast
    to v's dtype), ``delta = rowsum(dO ∘ O)`` in f32, ``ds = p·(dp − delta)/√D``;
    ``ds`` and ``p`` are rounded to q's dtype before ``dq = ds·K``,
    ``dk = dsᵀ·Q`` and ``dv = pᵀ·dO``, which accumulate in f32. A
    ``kv_len = 0`` row has p = 1/T on every key and non-zero gradients.
    """
    D = q.shape[-1]
    s = _classic_scores(q, k, kv_lens)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    do = dout.float()
    dp = torch.matmul(do.to(v.dtype).float(), v.float().transpose(-1, -2))
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * (1.0 / math.sqrt(D))).to(q.dtype).float()
    p = p.to(q.dtype).float()
    dq = torch.matmul(ds, k.float()).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), do.to(q.dtype).float()).to(v.dtype)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, kv_lens, out, dout):
    """``(dq, dk, dv)`` of :func:`flash_attention`; ``flash_classic_bwd`` on CUDA."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, kv_lens, out, dout)
    from oron_tts_tpu_torch.ops import _build

    shape = q.shape
    q, k, v, lens, d, dp = _checked_classic("flash_attention_bwd", q, k, v, kv_lens)
    B, H, T, _ = q.shape
    if out.shape != shape or dout.shape != shape or out.dtype != q.dtype:
        raise ValueError("out and dout must match q's shape and dtype")
    out, dout = (_dense(_pad_last(x, dp)) for x in (out, dout.to(q.dtype)))
    lse2 = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse2)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    err = _build.load("flash_classic_bwd").flash_classic_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lens.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, T, dp, 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), 3,
        _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_classic_bwd")
    flash_attention_bwd.launches += 1
    return tuple(_unpad_last(x, d) for x in (dq, dk, dv))


flash_attention_bwd.launches = 0


class _FlashAttentionClassic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lens):
        out = flash_attention(q, k, v, kv_lens=kv_lens)
        ctx.save_for_backward(q, k, v, kv_lens, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_lens, out, dout)
        return dq, dk, dv, None


def flash_attention_trainable(q, k, v, kv_lens=None):
    """Differentiable :func:`flash_attention`: kernel 6 forward, kernel 7 backward.

    ``kv_lens=None`` becomes T for every row, as the JAX ``_fat_fwd`` does.
    """
    if kv_lens is None:
        kv_lens = torch.full((q.shape[0],), q.shape[2], dtype=torch.int32, device=q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type == "cuda":
            q, k, v = _dense(q), _dense(k), _dense(v)
        return _FlashAttentionClassic.apply(q, k, v, kv_lens)
    return flash_attention(q, k, v, kv_lens=kv_lens)


def flash_attention_packed(q, k, v, kv_lens=None):
    """Two heads per block (``flash_packed_fwd``); the function of :func:`flash_attention`.

    Odd H falls back to :func:`flash_attention`, as the JAX function does.
    Forward only: called where a gradient would be needed it raises, since
    the JAX function has no VJP either. Its plain version, for CPU tensors,
    is :func:`flash_attention_plain` (exp2): the same function.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention_packed has no backward (neither has the JAX function); "
            "train with attn_impl='flash'")
    if q.shape[1] % 2:
        return flash_attention(q, k, v, kv_lens=kv_lens)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lens=kv_lens)
    from oron_tts_tpu_torch.ops import _build

    q, k, v, lens, d, dp = _checked_classic("flash_attention_packed", q, k, v, kv_lens)
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    err = _build.load("flash_classic").flash_packed_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, H, T, dp, 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_packed_fwd")
    flash_attention_packed.launches += 1
    return _unpad_last(out, d)


flash_attention_packed.launches = 0


def flash_nosm_plain(q, k, v):
    """The attention bench's split without softmax (``_nosm_kernel``):
    ``(q·Kᵀ in f32)·(1/T)`` cast to v's dtype, ``·V`` in f32, q's dtype out."""
    T = q.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return torch.matmul((s * (1.0 / T)).to(v.dtype).float(), v.float()).to(q.dtype)


def flash_nosm(q, k, v):
    """``[B, H, T, D]`` no-softmax attention; ``flash_nosm`` on CUDA."""
    if q.device.type == "cpu":
        return flash_nosm_plain(q, k, v)
    from oron_tts_tpu_torch.ops import _build

    q, k, v, _, d, dp = _checked_classic("flash_nosm", q, k, v, None)
    B, H, T, _ = q.shape
    out = torch.empty_like(q)
    err = _build.load("flash_classic").flash_nosm(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, T, dp,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_nosm")
    flash_nosm.launches += 1
    return _unpad_last(out, d)


flash_nosm.launches = 0
