"""Text embedding: token lookup + sinusoidal positions + ConvNeXtV2 stack.

Counterpart of the JAX package's ``models/text_embed.py``: ids shift by +1
so 0 is the filler (the collator pads with -1), the sequence is cropped or
padded to the mel length, ``drop_text`` replaces every id with the filler
(the CFG unconditional branch), and padding positions are re-zeroed after
every block. With no blocks the lookup is all, unless ``positions`` asks for the
sinusoidal positions, the padding then zeroed (the MMDiT's text stream).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from oron_tts_tpu_torch.models.layers import ConvNeXtV2Block, text_position_table


class TextEmbedding(nn.Module):
    def __init__(
        self, vocab_size: int, text_dim: int, conv_layers: int = 0, conv_mult: int = 2,
        positions: bool = False,
    ) -> None:
        super().__init__()
        self.text_dim, self.conv_layers = text_dim, conv_layers
        self.positions = positions or conv_layers > 0
        self.embed = nn.Embedding(vocab_size + 1, text_dim)
        for i in range(conv_layers):
            self.add_module(f"block{i}", ConvNeXtV2Block(text_dim, text_dim * conv_mult))
        self._pos: dict[tuple, torch.Tensor] = {}

    def _positions(self, seq_len: int, like: torch.Tensor) -> torch.Tensor:
        key = (seq_len, str(like.device), like.dtype)
        if key not in self._pos:
            table = text_position_table(self.text_dim, max(seq_len, 1))
            self._pos[key] = torch.from_numpy(table[:seq_len]).to(like.device, like.dtype)
        return self._pos[key]

    def forward(self, text_ids: torch.Tensor, seq_len: int, drop_text: bool = False) -> torch.Tensor:
        """[B, Nt] int ids (−1 = padding) → [B, seq_len, text_dim]."""
        shifted = text_ids.long() + 1
        nt = shifted.shape[1]
        shifted = shifted[:, :seq_len] if nt >= seq_len else F.pad(shifted, (0, seq_len - nt))
        keep = (shifted != 0)[..., None]
        if drop_text:
            shifted = torch.zeros_like(shifted)
        emb = self.embed(shifted)
        if self.positions:
            emb = emb + self._positions(seq_len, emb)[None]
            emb = emb.masked_fill(~keep, 0.0)
            for i in range(self.conv_layers):
                emb = getattr(self, f"block{i}")(emb).masked_fill(~keep, 0.0)
        return emb
