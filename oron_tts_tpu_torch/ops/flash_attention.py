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
    B, T, HD = q.shape
    d = HD // heads

    def heads_first(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(B, T, heads, d).transpose(1, 2)

    qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    s = s * (1.0 / math.sqrt(d) * math.log2(math.e))
    cols = torch.arange(T, device=q.device)
    valid = cols[None, :] < kv_lens.to(q.device)[:, None]  # [B, T]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vh.float())
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).reshape(B, T, HD).to(q.dtype)


def flash_lanes_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_lens: torch.Tensor,
    heads: int,
) -> torch.Tensor:
    """Attention over ``[B, T, H·D]``; the kernel on CUDA, the plain version on CPU."""
    if q.device.type == "cpu":
        return flash_lanes_plain(q, k, v, kv_lens, heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_lanes_fwd: unsupported device {q.device}")
    from oron_tts_tpu_torch.ops import _build

    B, T, HD = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one [B, T, H·D] shape")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_lanes_fwd takes bf16 or f32 q/k/v, got {q.dtype}")
    if HD % heads or HD // heads != 64:
        raise ValueError(f"flash_lanes_fwd needs head width 64, got {HD}/{heads}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError(f"kv_lens must be [B]={B}, got {tuple(lens.shape)}")
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
