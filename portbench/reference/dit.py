"""Plain float32 F5-TTS DiT and its CFG Euler sampler: the architecture ``"DiT"``.

A configuration whose ``model.backbone`` is ``"DiT"``, or absent, is found
here (``portbench/reference/__init__.py`` holds the contract; its functions
close this file, with the DiT's FLOP count).

Written from the published architecture (F5-TTS, arXiv:2410.06885: a DiT
with AdaLN-zero blocks, RoPE self-attention, a ConvNeXt-V2 text encoder and
a convolutional position embedding) in plain ``torch`` operations over a
state dict whose names and layouts are the served model's
(``block{i}.attn.to_q.weight`` ``[out, in]``, conv weights ``[K, cin/groups,
C]``). Every product runs in float32 with TF32 off; nothing here imports the
program.

``quant="fp8"`` puts a lower precision in float32's place, for the control:
both operands of every matrix product (the projections, the attention's
scores and its weighted sum) are rounded to float8 e4m3 with one scale a
row (each token's activations, each output channel's weights) before the
product, as an fp8 inference path would compute.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.layers import (conv1d_same, fp8_rows, gelu_erf, gelu_tanh, layer_norm,
                                        mish, silu)


class Params:
    """The state dict in float32 on one device, with the sizes read off it."""

    def __init__(self, state: dict[str, torch.Tensor], heads: int, device="cpu",
                 quant: str | None = None) -> None:
        self.p = {k: v.detach().to(device=device, dtype=torch.float32) for k, v in state.items()}
        self.heads = heads
        self.quant = quant
        self.depth = sum(1 for k in self.p if k.endswith(".attn.to_q.weight"))
        self.dim = self.p["proj_out.weight"].shape[1]
        self.dim_head = self.p["block0.attn.to_q.weight"].shape[0] // heads
        self.conv_layers = sum(1 for k in self.p if k.startswith("text_embed.block")
                               and k.endswith(".dwconv.weight"))

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.p[key]

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if self.quant == "fp8":
            return torch.matmul(fp8_rows(x), fp8_rows(w).t()) + b
        return torch.matmul(x, w.t()) + b


# ── embeddings ────────────────────────────────────────────────────────────


def timestep_embedding(P: Params, t: torch.Tensor) -> torch.Tensor:
    half = 128
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = 1000.0 * t.float()[:, None] * freqs[None, :]
    h = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return P.linear(silu(P.linear(h, "time_embed.mlp_in")), "time_embed.mlp_out")


def text_positions(dim: int, length: int, device) -> torch.Tensor:
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    ang = np.outer(np.arange(length, dtype=np.float64), freqs)
    table = np.concatenate([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def text_embedding(P: Params, ids: torch.Tensor, length: int, drop: bool) -> torch.Tensor:
    """[B, Nt] ids (−1 pads) → [B, length, text_dim]."""
    shifted = ids.long() + 1
    nt = shifted.shape[1]
    shifted = shifted[:, :length] if nt >= length else F.pad(shifted, (0, length - nt))
    keep = (shifted != 0)[..., None]
    if drop:
        shifted = torch.zeros_like(shifted)
    emb = P["text_embed.embed.weight"][shifted]
    if P.conv_layers:
        emb = emb + text_positions(emb.shape[-1], length, emb.device)[None]
        emb = emb * keep
        for i in range(P.conv_layers):
            pre = f"text_embed.block{i}"
            h = conv1d_same(emb, P[pre + ".dwconv.weight"], P[pre + ".dwconv.bias"],
                            groups=emb.shape[-1])
            h = layer_norm(h, P[pre + ".norm.weight"], P[pre + ".norm.bias"])
            h = gelu_erf(P.linear(h, pre + ".pwconv1"))
            gx = torch.sqrt(torch.clamp((h * h).sum(dim=1, keepdim=True), min=1e-24))
            nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
            h = P[pre + ".grn.gamma"] * (h * nx) + P[pre + ".grn.beta"] + h
            emb = (emb + P.linear(h, pre + ".pwconv2")) * keep
    return emb


def input_embedding(P: Params, x, cond, text_emb, mask) -> torch.Tensor:
    h = P.linear(torch.cat([x, cond, text_emb], dim=-1), "input_embed.proj")
    keep = mask[..., None].float()
    y = h * keep
    for c in ("conv1", "conv2"):
        pre = "input_embed.conv_pos_embed." + c
        y = mish(conv1d_same(y, P[pre + ".weight"], P[pre + ".bias"], groups=16)) * keep
    return y + h


# ── transformer ───────────────────────────────────────────────────────────


def rope(length: int, d: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float64) / d))
    f = np.outer(np.arange(length, dtype=np.float64), inv)
    emb = np.concatenate([f, f], axis=-1)
    return (torch.from_numpy(np.cos(emb).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(emb).astype(np.float32)).to(device))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], dim=-1) * sin


def attention(P: Params, pre: str, x, mask, cos, sin) -> torch.Tensor:
    B, T, _ = x.shape
    H, D = P.heads, P.dim_head
    q, k, v = (P.linear(x, f"{pre}.{n}").view(B, T, H, D).transpose(1, 2)
               for n in ("to_q", "to_k", "to_v"))
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    if P.quant == "fp8":
        q, k = fp8_rows(q), fp8_rows(k)
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(~mask[:, None, None, :], -1e30)  # a row with no key: equal weights
    a = torch.softmax(s, dim=-1)
    if P.quant == "fp8":
        a, v = fp8_rows(a), fp8_rows(v.transpose(-1, -2)).transpose(-1, -2)
    o = torch.matmul(a, v).transpose(1, 2).reshape(B, T, H * D)
    return P.linear(o, f"{pre}.to_out") * mask[..., None]


def block(P: Params, i: int, x, t_emb, mask, cos, sin, drop=None) -> torch.Tensor:
    """One DiT block; ``drop(kind, tensor)`` applies training dropout."""
    pre = f"block{i}"
    mods = P.linear(silu(t_emb), pre + ".attn_norm.linear")
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mods, 6, dim=-1)
    normed = layer_norm(x) * (1 + sc_a[:, None]) + sh_a[:, None]
    a = attention(P, pre + ".attn", normed, mask, cos, sin)
    if drop is not None:
        a = drop("attn", a) * mask[..., None]
    x = x + g_a[:, None] * a
    h = P.linear(layer_norm(x) * (1 + sc_m[:, None]) + sh_m[:, None], pre + ".ff.in_proj")
    h = gelu_tanh(h) if drop is None else drop("ff", gelu_tanh(h))
    return x + g_m[:, None] * P.linear(h, pre + ".ff.out_proj")


def dit_forward(P: Params, x, cond, text_emb, t, mask, drop_audio=False,
                dropout=None) -> torch.Tensor:
    """Velocity [B, T, n_mels]; ``dropout(i)`` gives block i's ``drop`` callable."""
    if drop_audio:
        cond = torch.zeros_like(cond)
    t_emb = timestep_embedding(P, t)
    h = input_embedding(P, x, cond, text_emb, mask)
    cos, sin = rope(x.shape[1], P.dim_head, x.device)
    for i in range(P.depth):
        h = block(P, i, h, t_emb, mask, cos, sin, None if dropout is None else dropout(i))
    mods = P.linear(silu(t_emb), "norm_out.linear")
    scale, shift = torch.chunk(mods, 2, dim=-1)
    h = layer_norm(h) * (1 + scale[:, None]) + shift[:, None]
    return P.linear(h, "proj_out")


# ── sampling ──────────────────────────────────────────────────────────────

_M32 = 0xFFFFFFFF


def _fmix32(z: torch.Tensor) -> torch.Tensor:
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _M32
    return z ^ (z >> 16)


def row_noise(seed: int, length: int, n_mels: int, device="cpu") -> torch.Tensor:
    """The served model's initial noise of one row: a murmur3 counter hash of
    (seed, frame, bin) through Box-Muller in float64, rounded once to f32."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    folded = (s ^ (s >> 32)) & _M32
    key = _fmix32(torch.tensor([(folded * 0x9E3779B1 + 0x165667B1) & _M32], dtype=torch.int64,
                               device=device))
    frames = torch.arange(length, dtype=torch.int64, device=device)
    fkey = _fmix32(key[:, None] ^ ((frames * 0x85EBCA77) & _M32)[None, :])
    bins = torch.arange(n_mels, dtype=torch.int64, device=device)
    counter = fkey[:, :, None] + ((bins * 0xC2B2AE3D) & _M32)[None, None, :]
    u1 = (_fmix32(counter & _M32).double() + 1.0) / 4294967296.0
    u2 = _fmix32((counter + 0x27D4EB2F) & _M32).double() / 4294967296.0
    return (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * np.pi * u2)).float()[0]


def sway_grid(steps: int, coef: float | None) -> np.ndarray:
    t = np.linspace(0.0, 1.0, steps + 1)
    if coef is not None:
        t = t + coef * (np.cos(np.pi / 2 * t) - 1 + t)
    return t.astype(np.float32)


@torch.no_grad()
def sample(P: Params, ids: list[int], cond: torch.Tensor, ref_frames: int, total: int,
           seed: int, steps: int, cfg: float, sway: float | None,
           bucket: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One row's CFG Euler solve; returns (mel [total, n_mels], initial noise [total, n_mels]).

    ``ids`` are the stretched ids of all ``total`` frames and ``cond`` the
    reference mel ``[ref_frames, n_mels]`` (empty without one). The row is
    solved padded to ``bucket`` frames (default: ``total``), keys and convs
    masked to ``total``: the text encoder's GRN pools over every position,
    padding included, so a row's output depends on the length it is padded to.
    """
    dev = cond.device
    n_mels = P["proj_out.weight"].shape[0]
    L = bucket or total
    mask = (torch.arange(L, device=dev) < total)[None]
    cond_full = torch.zeros(1, L, n_mels, device=dev)
    cond_full[0, :ref_frames] = cond
    noise = row_noise(seed, L, n_mels, dev)
    x = torch.where(mask[..., None], noise[None], 0.0)
    id_t = torch.full((1, L), -1, dtype=torch.int64, device=dev)
    id_t[0, :total] = torch.tensor(ids, dtype=torch.int64, device=dev)
    te = text_embedding(P, id_t, L, drop=False)
    te_null = text_embedding(P, id_t, L, drop=True)
    grid = sway_grid(steps, sway)
    for i in range(steps):
        t = torch.tensor([grid[i]], device=dev)
        pred = dit_forward(P, x, cond_full, te, t, mask)
        if cfg >= 1e-5:
            null = dit_forward(P, x, cond_full, te_null, t, mask, drop_audio=True)
            pred = pred + (pred - null) * cfg
        x = x + pred * float(grid[i + 1] - grid[i])
    x[0, :ref_frames] = cond
    return x[0, :total], noise[:total]


# ── the architecture's contract (portbench/reference/__init__.py) ─────────


def params(state: dict[str, torch.Tensor], cfg: dict, device="cpu",
           quant: str | None = None) -> Params:
    return Params(state, cfg["model"]["heads"], device, quant=quant)


def velocity(P: Params, x, cond, ids, t, mask, drop_audio: bool, drop_text: bool,
             dropout=None) -> torch.Tensor:
    """The text embedding of ``ids`` at ``x``'s length, then the DiT's velocity."""
    te = text_embedding(P, ids, x.shape[1], drop=drop_text)
    return dit_forward(P, x, cond, te, t, mask, drop_audio=drop_audio, dropout=dropout)


def dropout_pairs(cfg: dict) -> int:
    """One (attention, FFN) seed pair a block."""
    return cfg["model"]["depth"]


# ── model FLOPs (products only; elementwise work counts nothing) ──────────


def model_dims(cfg: dict) -> dict:
    m = cfg["model"]
    return {"dim": m["dim"], "depth": m["depth"], "heads": m["heads"], "ff_mult": m["ff_mult"],
            "text_dim": m["text_dim"], "conv_layers": m["conv_layers"],
            "mel_dim": cfg.get("n_mels", 100)}


def dit_frame_flops(m: dict) -> float:
    """Products of one frame through the DiT, attention's key loop aside."""
    dim, depth, ff, mel, td = m["dim"], m["depth"], m["ff_mult"], m["mel_dim"], m["text_dim"]
    block = 8 * dim * dim + 4 * dim * dim * ff
    inp = 2 * (2 * mel + td) * dim + 2 * (2 * dim * (dim // 16) * 31)
    final = 2 * dim * mel
    return depth * block + inp + final


def dit_row_flops(m: dict, frames: int) -> float:
    """One forward of one row of ``frames`` kept frames (attention over its own keys)."""
    attn = 4 * frames * frames * m["dim"] * m["depth"]
    return frames * dit_frame_flops(m) + attn


def text_embed_flops(m: dict, frames: int) -> float:
    td = m["text_dim"]
    return m["conv_layers"] * (2 * frames * td * 7 + 8 * frames * td * td)


def solve_flops(cfg: dict, row_frames: list[int], steps: int, guided: bool = True) -> float:
    """A CFG Euler solve: per step one forward of each row, two when guided; the text
    embedding once a branch; the AdaLN tables once a solve."""
    m = model_dims(cfg)
    branches = 2 if guided else 1
    per_step = sum(dit_row_flops(m, n) for n in row_frames)
    adaln = steps * (m["depth"] * 2 * m["dim"] * 6 * m["dim"] + 2 * m["dim"] * 2 * m["dim"])
    text = branches * sum(text_embed_flops(m, n) for n in row_frames)
    return branches * steps * per_step + text + adaln


def train_step_flops(cfg: dict, row_frames: list[int]) -> float:
    """One training step: 3 × the forward of each row at its kept frames, with the
    text embedding and each row's AdaLN (no recomputation counted)."""
    m = model_dims(cfg)
    fwd = sum(dit_row_flops(m, n) + text_embed_flops(m, n)
              + m["depth"] * 2 * m["dim"] * 6 * m["dim"] + 2 * m["dim"] * 2 * m["dim"]
              for n in row_frames if n > 0)
    return 3.0 * fwd
