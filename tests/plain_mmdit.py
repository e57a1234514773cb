"""Plain float32 MMDiT: the velocity, the CFM loss and a CFG Euler solve.

Written from the published architecture (F5-TTS's ``src/f5_tts/model/backbones/
mmdit.py``; the block is Stable Diffusion 3's multimodal DiT, arXiv:2403.03206)
in plain ``torch`` operations, float32 with TF32 off, over a state dict whose
names and layouts are the port's (``block{i}.attn.to_q_c.weight`` ``[out, in]``,
``block{i}.attn_norm_x.linear``, ``block{i}.ff_c.in_proj``, conv weights ``[K,
cin/groups, C]``). It imports nothing of the port, of the JAX package or of
their kernels; ``tests/test_torch_mmdit.py`` holds the port's ``MMDiT`` to it.

The equations (``LN``: LayerNorm without scale or bias, eps 1e-6;
``mod(h, sc, sh) = LN(h)·(1 + sc) + sh``; ``e`` the time embedding):

- ``e = Linear(SiLU(Linear(sinusoid(1000·time))))``, 256 frequencies;
- audio: ``x = proj([x_t, cond])``, then ``x + conv_pos(x)``: two grouped convs
  (k 31, 16 groups) with Mish, padding frames zeroed before and after each;
  ``drop_audio`` zeroes ``cond``;
- text: ``c = Embedding(vocab + 1, dim)[ids + 1] + sinusoid(position)``, the ids
  cut or padded to T with 0, zeroed where the id was padding; ``drop_text``
  makes every id 0 (the padding stays zeroed);
- block i < depth − 1: ``(sh₁, sc₁, g₁, sh₂, sc₂, g₂) = chunk₆(W·SiLU(e))``, one
  set a stream; ``x̂ = mod(x, sc₁, sh₁)``, ``ĉ`` likewise; one attention over
  ``[ĉ; x̂]`` (RoPE on each stream over its own positions 0 .. T − 1; every
  text key admitted, audio keys past the row's length masked); its output split
  into ``A_c``, ``A_x``; ``x += g₁·Dropout(W_out A_x)`` (padded audio rows
  zeroed), ``x += g₂·FF_x(mod(x, sc₂, sh₂))``; ``c += g₁ᶜ·W_outᶜ A_c`` (no
  dropout, no row mask), ``c += g₂ᶜ·FF_c(mod(c, sc₂ᶜ, sh₂ᶜ))``;
- the last block: ``ĉ = mod(c, scᶜ, shᶜ)`` from ``chunk₂(W·SiLU(e))``; the text
  supplies keys and values only (its queries reach no output and are left out);
  the audio as above; ``c`` is dropped;
- the velocity is ``proj_out(mod(x, scale, shift))``, ``(scale, shift) =
  chunk₂(W_out·SiLU(e))``.

``order="audio_first"`` runs the joint attention in upstream's order, ``[x̂;
ĉ]`` with its two-segment key mask (audio prefix, then every text key); the
default is the port's ``[ĉ; x̂]``, whose key mask is one prefix, ``T + len``.

Departures from upstream, each deliberate:

- The text is frame-rate: each clip's characters stretched over its mel
  frames (this system's text path), so the text stream is as long as the audio
  (T), where upstream feeds one token a character. Its sinusoidal positions run
  to T unclamped (upstream clamps at 1,024, a length character text never
  reaches).
- RoPE pairs lanes as rotate-half (lane i with lane i + D/2), the port's
  convention, where upstream takes x_transformers' rotary embedding, which
  pairs adjacent lanes: the same rotation up to a fixed permutation of each
  head's lanes.
- The last block has no ``to_q_c`` (upstream builds one whose output is
  discarded): the function is the same, the state one matrix smaller.
- Dropout masks are the port's counter hash, passed in by the caller
  (``dropout``), not ``torch``'s generator; they follow the audio attention's
  output projection and each FFN's GELU, as upstream's ``nn.Dropout`` does.
  Block i's attention and audio FFN take pair i, its text FFN the FFN seed of
  pair ``depth + i``.
- The vocabulary is this system's 65 Cyrillic characters, not the published
  pinyin set.
- The conv position embedding zeroes padding frames (the port's DiT does the
  same, ``models/layers.py`` ``ConvPositionEmbedding``); upstream's MMDiT passes
  it no mask.
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
    return torch.matmul(x, p[name + ".weight"].t()) + p[name + ".bias"]


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS)


def modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


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


def text_positions(dim: int, length: int) -> torch.Tensor:
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    ang = np.outer(np.arange(length, dtype=np.float64), freqs)
    return torch.from_numpy(np.concatenate([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32))


def text_embedding(p: dict, ids: torch.Tensor, length: int, drop: bool) -> torch.Tensor:
    """[B, Nt] ids (−1 pads) → [B, length, dim]: the lookup, positions, padding zeroed."""
    shifted = ids.long() + 1
    nt = shifted.shape[1]
    shifted = shifted[:, :length] if nt >= length else F.pad(shifted, (0, length - nt))
    keep = (shifted != 0)[..., None]
    if drop:
        shifted = torch.zeros_like(shifted)
    emb = p["text_embed.embed.weight"][shifted]
    return (emb + text_positions(emb.shape[-1], length)[None]) * keep


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


def audio_embedding(p: dict, x, cond, mask) -> torch.Tensor:
    h = linear(p, torch.cat([x, cond], dim=-1), "input_embed.proj")
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


def joint_attention(p: dict, pre: str, x, c, mask, heads: int, pre_only: bool,
                    order: str = "text_first"):
    """``(A_x, A_c)``, each ``[B, T, H·D]`` before the output projections; ``A_c`` is
    None where the text gives keys and values only (its queries are left out)."""
    B, T, _ = x.shape
    D = p[f"{pre}.to_q.weight"].shape[0] // heads
    cos, sin = rope(T, D)

    def project(h, name, rotated=True):
        y = linear(p, h, f"{pre}.{name}").view(B, T, heads, D).transpose(1, 2)
        return rotate(y, cos, sin) if rotated else y

    qx, kx, vx = project(x, "to_q"), project(x, "to_k"), project(x, "to_v", rotated=False)
    kc, vc = project(c, "to_k_c"), project(c, "to_v_c", rotated=False)
    text_keys = torch.ones(B, T, dtype=torch.bool)
    if order == "text_first":
        k, v, keys = torch.cat([kc, kx], 2), torch.cat([vc, vx], 2), torch.cat([text_keys, mask], 1)
    else:
        k, v, keys = torch.cat([kx, kc], 2), torch.cat([vx, vc], 2), torch.cat([mask, text_keys], 1)
    if pre_only:
        q = qx
    else:
        qc = project(c, "to_q_c")
        q = torch.cat([qc, qx], 2) if order == "text_first" else torch.cat([qx, qc], 2)
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(~keys[:, None, None, :], -1e30)
    o = torch.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, -1, heads * D)
    if pre_only:
        return o, None
    first, second = o[:, :T], o[:, T:]
    return (second, first) if order == "text_first" else (first, second)


def velocity(p: dict, x, cond, ids, t, mask, heads: int, drop_audio: bool = False,
             drop_text: bool = False, dropout=None, order: str = "text_first") -> torch.Tensor:
    """[B, T, n_mels]; ``dropout(i)`` gives pair i's ``drop(kind, tensor)`` ("attn" or
    "ff"): block i's attention and audio FFN take pair i, its text FFN pair
    ``depth + i``; without it the forward is the inference one."""
    depth = sum(1 for k in p if k.endswith(".attn.to_q.weight"))
    B, T, _ = x.shape
    if drop_audio:
        cond = torch.zeros_like(cond)
    e = silu(timestep_embedding(p, t))
    c = text_embedding(p, ids, T, drop_text)
    x = audio_embedding(p, x, cond, mask)
    keep = mask[..., None].float()
    for i in range(depth):
        pre, last = f"block{i}", i == depth - 1
        mx = torch.chunk(linear(p, e, pre + ".attn_norm_x.linear"), 6, dim=-1)
        mc = torch.chunk(linear(p, e, pre + ".attn_norm_c.linear"), 2 if last else 6, dim=-1)
        x_hat = modulate(x, mx[1], mx[0])
        c_hat = modulate(c, mc[0], mc[1]) if last else modulate(c, mc[1], mc[0])
        a_x, a_c = joint_attention(p, pre + ".attn", x_hat, c_hat, mask, heads, last, order)
        y = linear(p, a_x, pre + ".attn.to_out")
        if dropout is not None:
            y = dropout(i)("attn", y)
        x = x + mx[2][:, None] * (y * keep)
        f = gelu_tanh(linear(p, modulate(x, mx[4], mx[3]), pre + ".ff_x.in_proj"))
        if dropout is not None:
            f = dropout(i)("ff", f)
        x = x + mx[5][:, None] * linear(p, f, pre + ".ff_x.out_proj")
        if last:
            break
        c = c + mc[2][:, None] * linear(p, a_c, pre + ".attn.to_out_c")
        f = gelu_tanh(linear(p, modulate(c, mc[4], mc[3]), pre + ".ff_c.in_proj"))
        if dropout is not None:
            f = dropout(depth + i)("ff", f)
        c = c + mc[5][:, None] * linear(p, f, pre + ".ff_c.out_proj")
    scale, shift = torch.chunk(linear(p, e, "norm_out.linear"), 2, dim=-1)
    return linear(p, modulate(x, scale, shift), "proj_out")


def draws(gen: torch.Generator, rows: int, frames: int, n_mels: int, pairs: int,
          probs: tuple[float, float]) -> dict:
    """One training step's random numbers, in the port's order: span fractions, span
    starts and times (one ``rand`` of ``[3, rows]``), the audio and text drop decisions,
    ``x0``, then ``pairs`` dropout seed pairs (``2·depth − 1`` for the MMDiT)."""
    u = torch.rand((3, rows), generator=gen)
    drop = (torch.rand(2, generator=gen) < torch.tensor(list(probs))).tolist()
    x0 = torch.randn((rows, frames, n_mels), generator=gen)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (pairs, 2), generator=gen).tolist()
    return {"u": u, "drop_audio": bool(drop[0]) or bool(drop[1]), "drop_text": bool(drop[1]),
            "x0": x0, "seeds": seeds}


def cfm_loss(p: dict, mel: torch.Tensor, ids: torch.Tensor, lens: torch.Tensor, d: dict,
             heads: int, frac_range=(0.7, 1.0), dropout=None) -> torch.Tensor:
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
    pred = velocity(p, phi, cond, ids, t, mask, heads, d["drop_audio"], d["drop_text"], dropout)
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
                sway: float | None, heads: int) -> torch.Tensor:
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
        v = velocity(p, x, step_cond, ids, t, mask, heads)
        if cfg >= 1e-5:
            null = velocity(p, x, step_cond, ids, t, mask, heads, drop_audio=True,
                            drop_text=True)
            v = v + (v - null) * cfg
        x = x + v * float(grid[i + 1] - grid[i])
    return torch.where(cmask, cond, x)
