"""Diffusion Transformer backbone for F5-TTS flow matching (PyTorch).

Counterpart of the JAX package's ``models/dit.py`` in the unrolled
``block{i}`` layout. The text embedding is computed once per CFG branch by
the caller (``embed_text``) and passed in; ``forward_cfg`` runs the
conditional and unconditional rows as one doubled batch, the input
embedding included (one grouped-conv launch per conv for both rows).

``use_flash`` and ``attn_impl`` are the JAX package's attention switch
(``layers.resolve_attn_impl``); the default is the lanes kernels. The RoPE
tables follow the blocks' choice: lanes-tiled for "lanes", heads-first
``[T, D]`` for the rest.

Training calls ``forward`` with ``dropout_seeds``, one ``(attention, FFN)``
pair of ints per block; without them the pass is deterministic (the JAX
package's ``deterministic=True``). ``gradient_checkpointing`` recomputes
each block in the backward through ``torch.utils.checkpoint``; the seeds
are plain arguments, so the recomputation draws the same masks. The JAX
package's ``scan_blocks``, ``remat_policy`` and AOT layouts steer XLA and
have no counterpart here.

For int8 serving, ``quantize_dit_params`` swaps the six attention and FFN
projections of every block for ``QDense`` after load; ``DiT(quant=mode)``
builds them so from the start, to load a tree that is already quantized.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from oron_tts_tpu_torch.models.layers import (
    QUANT_MODES,
    AdaLayerNormFinal,
    ConvPositionEmbedding,
    DiTBlock,
    QDense,
    TimestepEmbedding,
    heads_rope,
    lanes_rope,
)
from oron_tts_tpu_torch.models.text_embed import TextEmbedding


class InputEmbedding(nn.Module):
    """concat([x, cond, text_embed]) → Linear(dim) + residual conv-pos embed."""

    def __init__(self, mel_dim: int, text_dim: int, out_dim: int) -> None:
        super().__init__()
        self.proj = nn.Linear(2 * mel_dim + text_dim, out_dim)
        self.conv_pos_embed = ConvPositionEmbedding(out_dim)

    def forward(self, x, cond, text_embed, drop_audio_cond: bool = False, mask=None):
        if drop_audio_cond:
            cond = torch.zeros_like(cond)
        dtype = self.proj.weight.dtype
        h = self.proj(torch.cat([x, cond, text_embed.to(x.dtype)], dim=-1).to(dtype))
        return self.conv_pos_embed(h, mask=mask) + h


class DiT(nn.Module):
    def __init__(
        self,
        dim: int = 1024,
        depth: int = 22,
        heads: int = 16,
        dim_head: int = 64,
        ff_mult: int = 4,
        mel_dim: int = 100,
        vocab_size: int = 65,
        text_dim: int = 512,
        conv_layers: int = 4,
        dropout: float = 0.1,
        gradient_checkpointing: bool = False,
        quant: str | None = None,
        use_flash: bool = True,
        attn_impl: str | None = None,
    ) -> None:
        super().__init__()
        self.dim, self.depth, self.heads, self.dim_head = dim, depth, heads, dim_head
        self.dropout, self.gradient_checkpointing = dropout, gradient_checkpointing
        self.quant = quant
        self.time_embed = TimestepEmbedding(dim)
        self.text_embed = TextEmbedding(vocab_size, text_dim, conv_layers)
        self.input_embed = InputEmbedding(mel_dim, text_dim, dim)
        for i in range(depth):
            self.add_module(f"block{i}", DiTBlock(dim, heads, dim_head, ff_mult, dropout, quant,
                                                  use_flash, attn_impl))
        # every block resolves the same (heads, dim_head), so one choice
        self.attn_impl = self.block0.attn.impl if depth else None
        self.norm_out = AdaLayerNormFinal(dim)
        self.proj_out = nn.Linear(dim, mel_dim)

    @property
    def blocks(self) -> list[DiTBlock]:
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    def embed_text(self, text_ids: torch.Tensor, seq_len: int, drop_text: bool = False) -> torch.Tensor:
        """Hoistable text embedding (once per CFG branch, reused every step)."""
        return self.text_embed(text_ids, seq_len, drop_text=drop_text)

    def embed_time(self, time: torch.Tensor) -> torch.Tensor:
        """Hoistable timestep embedding: [S] → [S, dim]."""
        return self.time_embed(time)

    def _transformer(self, h, t, mask, t_mods=None, dropout_seeds=None):
        B, T, _ = h.shape
        if self.attn_impl == "lanes":
            rope = lanes_rope(T, self.dim_head, self.heads, str(h.device), h.dtype)
        else:
            rope = heads_rope(T, self.dim_head, str(h.device), h.dtype)
        kv_lens = (
            mask.sum(dim=-1, dtype=torch.int32) if mask is not None
            else torch.full((B,), T, dtype=torch.int32, device=h.device)
        )
        block_mods, final_mods = t_mods if t_mods is not None else (None, None)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            args = (h, t, mask, rope, None if block_mods is None else block_mods[i],
                    kv_lens, None if dropout_seeds is None else dropout_seeds[i])
            h = checkpoint(blk, *args, use_reentrant=False) if remat else blk(*args)
        return self.proj_out(self.norm_out(h, t, mods=final_mods))

    def forward(
        self,
        x: torch.Tensor,
        cond: torch.Tensor,
        text_ids: torch.Tensor | None,
        time: torch.Tensor | None,
        mask: torch.Tensor | None = None,
        drop_audio_cond: bool = False,
        drop_text: bool = False,
        text_embed: torch.Tensor | None = None,
        t_mods: tuple[torch.Tensor, torch.Tensor] | None = None,
        dropout_seeds: list[tuple[int, int]] | None = None,
    ) -> torch.Tensor:
        """Velocity [B, T, mel_dim] for noised mel x and conditioning cond.

        ``drop_audio_cond`` and ``drop_text`` are one decision for the whole
        batch, as in the JAX package's CFG dropout.
        """
        t = None
        if t_mods is None:
            if time.ndim == 0:
                time = time.expand(x.shape[0])
            t = self.time_embed(time)
        if text_embed is None:
            text_embed = self.embed_text(text_ids, x.shape[1], drop_text=drop_text)
        h = self.input_embed(x, cond, text_embed, drop_audio_cond=drop_audio_cond, mask=mask)
        return self._transformer(h, t, mask, t_mods=t_mods, dropout_seeds=dropout_seeds)

    def forward_cfg(
        self,
        x: torch.Tensor,
        cond: torch.Tensor,
        text_embed_cond: torch.Tensor,
        text_embed_uncond: torch.Tensor,
        time: torch.Tensor | None,
        mask: torch.Tensor | None = None,
        t_mods: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """CFG double batch: rows [cond; uncond] through one pass.

        The unconditional rows drop the audio conditioning and use the
        dropped-text embedding. Returns (pred, null_pred).
        """
        b = x.shape[0]
        t2 = None
        if t_mods is None:
            if time.ndim == 0:
                time = time.expand(b)
            t = self.time_embed(time)
            t2 = torch.cat([t, t], dim=0)
        mask2 = None if mask is None else torch.cat([mask, mask], dim=0)
        h = self.input_embed(
            torch.cat([x, x], dim=0),
            torch.cat([cond, torch.zeros_like(cond)], dim=0),
            torch.cat([text_embed_cond, text_embed_uncond], dim=0),
            mask=mask2,
        )
        out = self._transformer(h, t2, mask2, t_mods=t_mods)
        return out[:b], out[b:]


QUANT_TARGETS = frozenset({"to_q", "to_k", "to_v", "to_out", "in_proj", "out_proj"})


def quantize_dit_params(dit: DiT, mode: str = "int8") -> DiT:
    """Swap the hot projections of every block for :class:`QDense`, in memory.

    The attention and FFN projections (``QUANT_TARGETS``; the AdaLN projections
    are hoisted out of the sampling loop instead, ``precompute_t_mods``) become
    int8 weights with one f32 scale per output channel; biases and everything
    else stay as they are. Checkpoints on disk are never quantized: this runs
    after load. A model that is already quantized only switches its mode (both
    modes read the same integers).
    """
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode: {mode!r}")
    for parent in list(dit.modules()):
        for name, child in list(parent.named_children()):
            if name not in QUANT_TARGETS:
                continue
            if isinstance(child, QDense):
                child.mode = mode
            elif isinstance(child, nn.Linear):
                setattr(parent, name, QDense.from_linear(child, mode))
    dit.quant = mode
    return dit


def precompute_t_mods(dit: DiT, t_emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """AdaLN modulation tables for a whole timestep schedule.

    ``t_emb`` [S, dim] is ``dit.embed_time`` over the step grid. Returns
    (block_mods [depth, S, 6·dim], final_mods [S, 2·dim]); at step i pass
    ``(block_mods[:, i], final_mods[i])`` as ``t_mods``.
    """
    act = torch.nn.functional.silu(t_emb)
    block_mods = torch.stack([blk.attn_norm.linear(act) for blk in dit.blocks])
    return block_mods, dit.norm_out.linear(act)
