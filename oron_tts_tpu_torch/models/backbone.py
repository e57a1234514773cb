"""What every backbone shares (PyTorch): the network ``CFM`` trains and samples.

The F5-TTS DiT (``models/dit.py``), E2 TTS's UNetT (``models/unett.py``) and
F5-TTS's two-stream MMDiT (``models/mmdit.py``) subclass :class:`Backbone`. A new
one is its module plus a row in ``models/f5tts.py`` ``BACKBONES`` (name to class)
and in ``config.py`` ``BACKBONE_DEFAULTS`` (name to defaults).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from oron_tts_tpu_torch.config import ModelConfig
from oron_tts_tpu_torch.models.layers import ConvPositionEmbedding, TensorParallel, TimestepEmbedding
from oron_tts_tpu_torch.models.text_embed import TextEmbedding
from oron_tts_tpu_torch.parallel import mesh as pmesh
from oron_tts_tpu_torch.utils.weights import init_module_params


class InputEmbedding(nn.Module):
    """concat([x, cond, text_embed]) → Linear(dim) + residual conv-pos embed; with
    ``text_dim`` 0 (a text stream of its own) concat([x, cond]) alone."""

    def __init__(self, mel_dim: int, text_dim: int, out_dim: int) -> None:
        super().__init__()
        self.proj = nn.Linear(2 * mel_dim + text_dim, out_dim)
        self.conv_pos_embed = ConvPositionEmbedding(out_dim)

    def forward(self, x, cond, text_embed, drop_audio_cond: bool = False, mask=None):
        if drop_audio_cond:
            cond = torch.zeros_like(cond)
        dtype = self.proj.weight.dtype
        parts = [x, cond] if text_embed is None else [x, cond, text_embed.to(x.dtype)]
        h = self.proj(torch.cat(parts, dim=-1).to(dtype))
        return self.conv_pos_embed(h, mask=mask) + h


class Backbone(nn.Module):
    """The text, time and input embeddings, ``forward``, ``forward_cfg`` and the Megatron
    split. A subclass builds ``block{i}`` (each with ``attn``, ``shard`` and ``unshard``)
    and its output head, defines ``_transformer`` and ``precompute_t_mods``, and may
    override what is its own: :meth:`initial_params`, :meth:`param_count` (what
    ``gradient_checkpointing: auto`` budgets for), ``config_fields`` (the ``ModelConfig``
    fields its constructor takes beyond the shared widths) and ``torch_layout`` (whether
    the reference's torch checkpoints, ``utils/torch_compat.py``, convert to it).

    With ``text_stream`` the text is not part of the input projection: it is embedded
    at ``text_dim`` with its sinusoidal positions and handed to ``_transformer`` beside
    the audio, as ``(audio, text)`` (:meth:`_embed`)."""

    config_fields: tuple[str, ...] = ()
    torch_layout = False
    text_stream = False

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, ff_mult: int,
                 mel_dim: int, vocab_size: int, text_dim: int, conv_layers: int,
                 dropout: float, gradient_checkpointing: bool, quant: str | None) -> None:
        super().__init__()
        self.dim, self.depth, self.heads, self.dim_head = dim, depth, heads, dim_head
        self.ff_mult = ff_mult
        self.dropout, self.gradient_checkpointing = dropout, gradient_checkpointing
        self.quant = quant
        self.mesh = None  # set by shard()
        self.time_embed = TimestepEmbedding(dim)
        self.text_embed = TextEmbedding(vocab_size, text_dim, conv_layers,
                                        positions=self.text_stream)
        self.input_embed = InputEmbedding(mel_dim, 0 if self.text_stream else text_dim, dim)

    @classmethod
    def from_config(cls, m: ModelConfig, n_mels: int, gradient_checkpointing: bool = False,
                    use_flash: bool = True) -> "Backbone":
        """The backbone at ``m``'s widths."""
        return cls(dim=m.dim, depth=m.depth, heads=m.heads, dim_head=m.dim_head,
                   ff_mult=m.ff_mult, mel_dim=n_mels, vocab_size=m.vocab_size,
                   text_dim=m.text_dim, conv_layers=m.conv_layers, dropout=m.p_dropout,
                   gradient_checkpointing=gradient_checkpointing, use_flash=use_flash,
                   **{k: getattr(m, k) for k in cls.config_fields})

    @classmethod
    def param_count(cls, m: ModelConfig, n_mels: int) -> int:
        """Parameters of the backbone at ``m``'s widths, built on the meta device (no memory)."""
        with torch.device("meta"):
            return sum(p.numel() for p in cls.from_config(m, n_mels).parameters())

    @classmethod
    def activation_depth(cls, m: ModelConfig) -> int:
        """Block-streams whose activations a step holds (``utils/memory.py``): one a block."""
        return m.depth

    def initial_params(self, seed: int = 0) -> dict[str, Any]:
        """A fresh flax-layout tree for this (whole) backbone: flax's default initialisers."""
        return init_module_params(self, seed)

    @property
    def dropout_pairs(self) -> int:
        """(attention, FFN) dropout seed pairs a training forward takes: one a block."""
        return self.depth

    @property
    def blocks(self) -> list[nn.Module]:
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    @property
    def attn_impl(self) -> str | None:
        """The blocks' attention implementation (every block resolves the same one)."""
        return self.block0.attn.impl if self.depth else None

    @property
    def local_heads(self) -> int:
        """Heads this rank computes: ``heads / TP`` once sharded."""
        return self.block0.attn.heads if self.depth else self.heads

    def shard(self, mesh) -> None:
        """Keep this rank's Megatron slice of every block (a no-op at TP 1).

        Refuses a head count or FFN width the model axis does not divide,
        before anything is sliced.
        """
        if self.mesh is not None:
            raise RuntimeError(f"the {type(self).__name__} is already sharded; unshard it first")
        tp = TensorParallel(mesh.model_rank, mesh.n_model, mesh.model_group)
        tp.split(self.heads, "heads")
        tp.split(self.ff_mult * self.dim, "ff_mult*dim")
        if mesh.n_model > 1:
            for blk in self.blocks:
                blk.shard(tp)
        self.mesh = mesh

    def unshard(self) -> None:
        """Gather every sharded tensor back (a collective over the model group)."""
        mesh, self.mesh = self.mesh, None
        if mesh is None or mesh.n_model == 1:
            return
        for name, t in list(self.named_parameters()) + list(self.named_buffers()):
            spec = pmesh.spec_for_name(name)
            if "model" not in spec:
                continue
            parent = self.get_submodule(name.rsplit(".", 1)[0])
            leaf = name.rsplit(".", 1)[1]
            whole = pmesh.gather_tensor(t.detach(), spec, mesh)
            setattr(parent, leaf, nn.Parameter(whole, requires_grad=t.requires_grad)
                    if isinstance(t, nn.Parameter) else whole)
        for blk in self.blocks:
            blk.unshard()

    def embed_text(self, text_ids: torch.Tensor, seq_len: int, drop_text: bool = False) -> torch.Tensor:
        """Hoistable text embedding (once per CFG branch, reused every step)."""
        return self.text_embed(text_ids, seq_len, drop_text=drop_text)

    def embed_time(self, time: torch.Tensor) -> torch.Tensor:
        """Hoistable timestep embedding: [S] → [S, dim]."""
        return self.time_embed(time)

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
        t_mods: tuple[torch.Tensor, ...] | None = None,
        dropout_seeds: list[tuple[int, int]] | None = None,
        batch0: int = 0,
    ) -> torch.Tensor:
        """Velocity [B, T, mel_dim] for noised mel x and conditioning cond.

        ``drop_audio_cond`` and ``drop_text`` are one decision for the whole
        batch, as in the JAX package's CFG dropout; ``batch0`` is the global
        index of ``x``'s first row (where a data rank's dropout masks start).
        ``t_mods`` replaces ``time``: each of ``precompute_t_mods``'s tables at
        one step (its second-last axis taken).
        """
        t = None
        if t_mods is None:
            if time.ndim == 0:
                time = time.expand(x.shape[0])
            t = self.time_embed(time)
        if text_embed is None:
            text_embed = self.embed_text(text_ids, x.shape[1], drop_text=drop_text)
        h = self._embed(x, cond, text_embed, drop_audio_cond=drop_audio_cond, mask=mask)
        return self._transformer(h, t, mask, t_mods=t_mods, dropout_seeds=dropout_seeds,
                                 batch0=batch0)

    def _embed(self, x, cond, text_embed, drop_audio_cond: bool = False, mask=None):
        """What ``_transformer`` takes: ``[x, cond, text]`` projected, one stream; with
        ``text_stream``, ``(audio, text)``, ``[x, cond]`` projected beside the text."""
        if self.text_stream:
            return (self.input_embed(x, cond, None, drop_audio_cond=drop_audio_cond, mask=mask),
                    text_embed)
        return self.input_embed(x, cond, text_embed, drop_audio_cond=drop_audio_cond, mask=mask)

    def forward_cfg(
        self,
        x: torch.Tensor,
        cond: torch.Tensor,
        text_embed_cond: torch.Tensor,
        text_embed_uncond: torch.Tensor,
        time: torch.Tensor | None,
        mask: torch.Tensor | None = None,
        t_mods: tuple[torch.Tensor, ...] | None = None,
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
        h = self._embed(
            torch.cat([x, x], dim=0),
            torch.cat([cond, torch.zeros_like(cond)], dim=0),
            torch.cat([text_embed_cond, text_embed_uncond], dim=0),
            mask=mask2,
        )
        out = self._transformer(h, t2, mask2, t_mods=t_mods)
        return out[:b], out[b:]
