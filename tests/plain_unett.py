"""Plain float32 E2 TTS (UNetT): the velocity, the CFM loss and a CFG Euler solve.

Written from the published architecture (E2 TTS, arXiv:2406.18009; F5-TTS's
``src/f5_tts/model/backbones/unett.py`` and ``configs/E2TTS_Base.yaml``) in
plain ``torch`` operations, float32 with TF32 off, over a state dict whose
names and layouts are the port's (``block{i}.attn.to_q.weight`` ``[out, in]``,
``block{i}.skip_proj.weight`` ``[dim, 2·dim]``, conv weights ``[K, cin/groups,
C]``). It imports nothing of the port, of the JAX package or of their kernels;
``tests/test_torch_unett.py`` holds the port's ``UNetT`` to it.

The equations:

- ``t = Linear(SiLU(Linear(sinusoid(1000·time))))``, 256 frequencies;
- ``txt = Embedding(vocab + 1, text_dim)[ids + 1]``, the ids cut or padded to
  T with 0, the padding not masked; ``drop_text`` makes every id 0;
- ``h = proj(cat[x, cond, txt])``, then ``h + conv_pos(h)``: two grouped convs
  (k 31, 16 groups) with Mish, padding frames zeroed before and after each;
- ``h = cat[t, h]`` (T + 1 tokens, the mask left-padded with True); RoPE
  over the T + 1 positions on the first ``pe_attn_head`` heads;
- blocks ``0 .. depth/2 − 1`` push their input; each later block first takes
  ``skip_proj(cat[h, pop()])``; every block ``h += Attn(RMSNorm(h))``,
  ``h += FF(RMSNorm(h))``; RMSNorm: the mean square, eps 1e-6, a weight;
- the velocity is ``proj_out(RMSNorm(h)[:, 1:])``.

Departures from upstream, each deliberate:

- RoPE pairs lanes as rotate-half (lane i with lane i + D/2), the port's
  convention, where upstream takes x_transformers' rotary embedding, which
  pairs adjacent lanes (2i with 2i + 1). The two are the same rotation up to a
  fixed permutation of each head's lanes, so they span the same models, but a
  checkpoint's q and k rows would need that permutation to cross over.
- RMSNorm is F5-TTS's own (``modules.RMSNorm``: mean square, eps 1e-6, weight
  ``weight``). x_transformers' RMSNorm, ``x / ‖x‖ · √d · g``, is the same
  function with its eps (1e-12) on the norm; its weight is named ``g``.
- The key bias is added on the rotated heads alone. On any other head it adds
  ``q·b`` to every score of a query, which softmax takes no notice of, so it
  is inert upstream too; left out, it gets an exact zero gradient, where
  upstream's is rounding noise that AdamW turns into full-size steps.
- Dropout masks are the port's counter hash, passed in by the caller
  (``dropout``), not ``torch``'s generator; they follow the attention's
  output projection and the FFN's GELU, as upstream's ``nn.Dropout`` does.
- The vocabulary is this system's 65 Cyrillic characters, not the published
  pinyin set; the embedding is otherwise the same.
- The conv position embedding zeroes padding frames (the port's DiT does
  the same, ``models/layers.py`` ``ConvPositionEmbedding``).
- Key padding is a prefix (``mask``), so it is applied as key lengths; a
  padded row keeps its time token, so no row is without a key.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPS = 1e-6


def linear(p: dict, x: torch.Tensor, name: str) -> torch.Tensor:
    y = torch.matmul(x, p[name + ".weight"].t())
    bias = p.get(name + ".bias")
    return y if bias is None else y + bias


def rms_norm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + EPS) * weight


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3)))


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def timestep_embedding(p: dict, t: torch.Tensor) -> torch.Tensor:
    half = 128
    freqs = torch.exp(torch.arange(half, dtype=torch.float32) * (-math.log(10000.0) / (half - 1)))
    args = 1000.0 * t.float()[:, None] * freqs[None, :]
    h = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return linear(p, silu(linear(p, h, "time_embed.mlp_in")), "time_embed.mlp_out")


def text_embedding(p: dict, ids: torch.Tensor, length: int, drop: bool) -> torch.Tensor:
    """[B, Nt] ids (−1 pads) → [B, length, text_dim]; no masking of the padding."""
    shifted = ids.long() + 1
    nt = shifted.shape[1]
    shifted = shifted[:, :length] if nt >= length else F.pad(shifted, (0, length - nt))
    if drop:
        shifted = torch.zeros_like(shifted)
    return p["text_embed.embed.weight"][shifted]


def grouped_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, T, C] by a ``[K, cin/groups, C]`` kernel, zero-padded to keep T."""
    K, cin_g, C = w.shape
    B, T, _ = x.shape
    xp = F.pad(x, (0, 0, K // 2, K - 1 - K // 2))
    out_g = C // groups
    xg = xp.reshape(B, -1, groups, cin_g)
    wg = w.reshape(K, cin_g, groups, out_g)
    acc = torch.zeros(B, T, groups, out_g)
    for i in range(K):
        acc = acc + torch.einsum("btgi,igo->btgo", xg[:, i: i + T], wg[i])
    return acc.reshape(B, T, C) + b


def input_embedding(p: dict, x, cond, text_emb, mask) -> torch.Tensor:
    h = linear(p, torch.cat([x, cond, text_emb], dim=-1), "input_embed.proj")
    keep = mask[..., None].float()
    y = h * keep
    for c in ("conv1", "conv2"):
        pre = "input_embed.conv_pos_embed." + c
        y = mish(grouped_conv(y, p[pre + ".weight"], p[pre + ".bias"], groups=16)) * keep
    return y + h


def rope(length: int, d: int) -> tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float64) / d))
    f = np.outer(np.arange(length, dtype=np.float64), inv)
    emb = np.concatenate([f, f], axis=-1)
    return (torch.from_numpy(np.cos(emb).astype(np.float32)),
            torch.from_numpy(np.sin(emb).astype(np.float32)))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], dim=-1) * sin


def attention(p: dict, pre: str, x, mask, heads: int, pe_attn_head: int | None) -> torch.Tensor:
    B, T, _ = x.shape
    n = heads if pe_attn_head is None else pe_attn_head
    q, v = linear(p, x, f"{pre}.to_q"), linear(p, x, f"{pre}.to_v")
    D = q.shape[-1] // heads
    b = p[f"{pre}.to_k.bias"]
    k = torch.matmul(x, p[f"{pre}.to_k.weight"].t()) + torch.cat(
        [b[:n * D], torch.zeros_like(b[n * D:])])
    q, k, v = (y.view(B, T, heads, D).transpose(1, 2) for y in (q, k, v))
    cos, sin = rope(T, D)
    q = torch.cat([rotate(q[:, :n], cos, sin), q[:, n:]], dim=1)
    k = torch.cat([rotate(k[:, :n], cos, sin), k[:, n:]], dim=1)
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    o = torch.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, T, heads * D)
    return linear(p, o, f"{pre}.to_out")


def velocity(p: dict, x, cond, ids, t, mask, heads: int, pe_attn_head: int | None = 1,
             drop_audio: bool = False, drop_text: bool = False, dropout=None) -> torch.Tensor:
    """[B, T, n_mels]; ``dropout(i)`` gives block i's ``drop(kind, tensor)`` ("attn" or
    "ff"), the tensor being ``[B, T + 1, ·]``; without it the forward is the inference one."""
    depth = sum(1 for k in p if k.endswith(".attn.to_q.weight"))
    B, T, _ = x.shape
    if drop_audio:
        cond = torch.zeros_like(cond)
    te = text_embedding(p, ids, T, drop_text)
    h = input_embedding(p, x, cond, te, mask)
    h = torch.cat([timestep_embedding(p, t)[:, None], h], dim=1)
    mask = F.pad(mask, (1, 0), value=True)
    keep = mask[..., None].float()
    skips = []
    for i in range(depth):
        pre = f"block{i}"
        drop = None if dropout is None else dropout(i)
        if i < depth // 2:
            skips.append(h)
        else:
            h = linear(p, torch.cat([h, skips.pop()], dim=-1), pre + ".skip_proj")
        a = attention(p, pre + ".attn", rms_norm(h, p[pre + ".attn_norm.weight"]), mask, heads,
                      pe_attn_head)
        if drop is not None:
            a = drop("attn", a)
        h = h + a * keep
        f = gelu_tanh(linear(p, rms_norm(h, p[pre + ".ff_norm.weight"]), pre + ".ff.in_proj"))
        if drop is not None:
            f = drop("ff", f)
        h = h + linear(p, f, pre + ".ff.out_proj")
    return linear(p, rms_norm(h, p["norm_out.weight"])[:, 1:], "proj_out")


def draws(gen: torch.Generator, rows: int, frames: int, n_mels: int, pairs: int,
          probs: tuple[float, float]) -> dict:
    """One training step's random numbers, in the port's order: span fractions, span
    starts and times (one ``rand`` of ``[3, rows]``), the audio and text drop decisions,
    ``x0``, then ``pairs`` (attention, FFN) dropout seed pairs."""
    u = torch.rand((3, rows), generator=gen)
    drop = (torch.rand(2, generator=gen) < torch.tensor(list(probs))).tolist()
    x0 = torch.randn((rows, frames, n_mels), generator=gen)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (pairs, 2), generator=gen).tolist()
    return {"u": u, "drop_audio": bool(drop[0]) or bool(drop[1]), "drop_text": bool(drop[1]),
            "x0": x0, "seeds": seeds}


def cfm_loss(p: dict, mel: torch.Tensor, ids: torch.Tensor, lens: torch.Tensor, d: dict,
             heads: int, pe_attn_head: int | None = 1, frac_range=(0.7, 1.0),
             dropout=None) -> torch.Tensor:
    """The CFM loss of mel ``[B, n_mels, T]``: a span of 70–100% of each row's frames
    masked out of the conditioning, ``φ = (1 − t)·x0 + t·x1``, the squared error of the
    predicted flow ``x1 − x0`` averaged over the span's frames × mel bins."""
    x1 = mel.transpose(1, 2).float()
    B, T, M = x1.shape
    lens = lens.to(torch.int32)
    mask = torch.arange(T)[None, :] < lens[:, None]
    lo, hi = frac_range
    span_len = ((lo + (hi - lo) * d["u"][0]) * lens).to(torch.int32)
    start = torch.clamp(((lens - span_len) * d["u"][1]).to(torch.int32), min=0)
    pos = torch.arange(T)[None, :]
    span = (pos >= start[:, None]) & (pos < (start + span_len)[:, None]) & mask
    t = d["u"][2]
    tb = t[:, None, None]
    phi = (1 - tb) * d["x0"] + tb * x1
    cond = torch.where(span[..., None], 0.0, x1)
    pred = velocity(p, phi, cond, ids, t, mask, heads, pe_attn_head, d["drop_audio"],
                    d["drop_text"], dropout)
    se = (pred - (x1 - d["x0"])) ** 2 * span[..., None]
    return se.sum() / max(float(span.sum()) * M, 1.0)


def sway_grid(steps: int, coef: float | None) -> np.ndarray:
    t = np.linspace(0.0, 1.0, steps + 1)
    if coef is not None:
        t = t + coef * (np.cos(np.pi / 2 * t) - 1 + t)
    return t.astype(np.float32)


@torch.no_grad()
def euler_solve(p: dict, cond: torch.Tensor, ids: torch.Tensor, duration: torch.Tensor,
                lens: torch.Tensor, noise: torch.Tensor, steps: int, cfg: float,
                sway: float | None, heads: int, pe_attn_head: int | None = 1) -> torch.Tensor:
    """CFG Euler solve of ``[B, T, n_mels]`` from ``noise``: each step the velocity with
    the text and the conditioning, and without both, combined ``v + (v − v_null)·cfg``;
    the conditioning frames put back at the end."""
    B, T, M = cond.shape
    mask = torch.arange(T)[None, :] < duration[:, None]
    cmask = (torch.arange(T)[None, :] < lens[:, None])[..., None]
    step_cond = torch.where(cmask, cond, 0.0)
    x = torch.where(mask[..., None], noise, 0.0)
    grid = sway_grid(steps, sway)
    for i in range(steps):
        t = torch.full((B,), float(grid[i]))
        v = velocity(p, x, step_cond, ids, t, mask, heads, pe_attn_head)
        if cfg >= 1e-5:
            null = velocity(p, x, step_cond, ids, t, mask, heads, pe_attn_head,
                            drop_audio=True, drop_text=True)
            v = v + (v - null) * cfg
        x = x + v * float(grid[i + 1] - grid[i])
    return torch.where(cmask, cond, x)
