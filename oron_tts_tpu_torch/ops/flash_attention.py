"""Lanes-layout attention: the CUDA kernel and its plain PyTorch version.

``flash_lanes_fwd(q, k, v, kv_lens, heads)`` computes non-causal softmax
attention on ``[B, T, H·D]`` tensors, keys at or beyond ``kv_lens[b]``
masked, exactly as the JAX package's ``flash_attention_lanes`` forward.

- CUDA tensors launch ``csrc/flash_lanes.cu`` (bf16: ``mma.sync`` tensor
  cores; f32: true-f32 SIMT), or raise.
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
replaces ``_flash_lanes_bwd_kernel``, ``:528``). ``lse2`` is
``m + log2(max(l, 1e-30))`` in base-2 units of the scaled scores, stored
``[B, H, T]`` f32 (the JAX package keeps ``[B, H·D/128, 128/D, T]``). On CPU
tensors the same Function calls the plain versions. A row with
``kv_len = 0`` has ``lse2 = log2 T`` here and −1e30 in the JAX package
(its −1e30 mask absorbs ``log2 T``), and zero gradients; training never
sends a non-zero gradient into such a row.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # the TPU kernel's key mask value


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


def _checked(name, q, k, v, kv_lens, heads):
    """Validate a CUDA call's arguments; contiguous q, k, v and int32 lens."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, T, HD = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B, T, H·D] shape")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes bf16 or f32 q/k/v, got {q.dtype}")
    if HD % heads or HD // heads != 64:
        raise ValueError(f"{name} needs head width 64, got {HD}/{heads}")
    lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError(f"kv_lens must be [B]={B}, got {tuple(lens.shape)}")
    return q.contiguous(), k.contiguous(), v.contiguous(), lens


def flash_lanes_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_lens: torch.Tensor,
    heads: int,
) -> torch.Tensor:
    """Attention over ``[B, T, H·D]``; the kernel on CUDA, the plain version on CPU."""
    if q.device.type == "cpu":
        return flash_lanes_plain(q, k, v, kv_lens, heads)
    from oron_tts_tpu_torch.ops import _build

    q, k, v, lens = _checked("flash_lanes_fwd", q, k, v, kv_lens, heads)
    B, T, HD = q.shape
    out = torch.empty_like(q)
    lib = _build.load("flash_lanes")
    err = lib.flash_lanes_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, T, heads, HD // heads,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_lanes_fwd")
    flash_lanes_fwd.launches += 1
    return out


flash_lanes_fwd.launches = 0


def flash_lanes_fwd_stats(q, k, v, kv_lens, heads):
    """``(out, lse2 [B, H, T] f32)``: the forward a backward will follow."""
    if q.device.type == "cpu":
        return flash_lanes_fwd_stats_plain(q, k, v, kv_lens, heads)
    from oron_tts_tpu_torch.ops import _build

    q, k, v, lens = _checked("flash_lanes_fwd_stats", q, k, v, kv_lens, heads)
    B, T, HD = q.shape
    out = torch.empty_like(q)
    lse2 = torch.empty((B, heads, T), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_lanes")
    err = lib.flash_lanes_fwd_stats(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), lse2.data_ptr(), B, T, heads, HD // heads,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_lanes_fwd_stats")
    flash_lanes_fwd_stats.launches += 1
    return out, lse2


flash_lanes_fwd_stats.launches = 0


def flash_lanes_bwd(q, k, v, kv_lens, out, dout, lse2, heads):
    """``(dq, dk, dv)``; the kernel on CUDA, the plain version on CPU."""
    if q.device.type == "cpu":
        return flash_lanes_bwd_plain(q, k, v, kv_lens, out, dout, lse2, heads)
    from oron_tts_tpu_torch.ops import _build

    q, k, v, lens = _checked("flash_lanes_bwd", q, k, v, kv_lens, heads)
    B, T, HD = q.shape
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("out and dout must match q's shape and dtype")
    if lse2.shape != (B, heads, T) or lse2.dtype != torch.float32:
        raise ValueError(f"lse2 must be f32 [B, H, T], got {tuple(lse2.shape)} {lse2.dtype}")
    out, dout, lse2 = out.contiguous(), dout.to(q.dtype).contiguous(), lse2.contiguous()
    delta = torch.empty_like(lse2)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    lib = _build.load("flash_lanes_bwd")
    err = lib.flash_lanes_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse2.data_ptr(), lens.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, heads, HD // heads,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_lanes_bwd")
    flash_lanes_bwd.launches += 1
    return dq, dk, dv


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
