"""PyTorch port, the backbone as a seam (CPU).

A backbone is one module plus one row in each of two tables: ``config.py``
``BACKBONE_DEFAULTS`` (names and their defaults) and ``models/f5tts.py``
``BACKBONES`` (names and their classes). Held here: the two tables name the
same backbones; a toy third backbone, registered in both and nowhere else,
builds through ``F5TTS``, is counted for ``gradient_checkpointing: auto`` from
its own module and takes one ``F5Trainer`` step; the DiT's initial weights are
still the JAX package's scheme; and ``Attention`` undoes its own ``shard``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch import nn

from oron_tts_tpu_torch import config as port_config
from oron_tts_tpu_torch.config import F5Config, ModelConfig
from oron_tts_tpu_torch.models import f5tts
from oron_tts_tpu_torch.models.backbone import Backbone
from oron_tts_tpu_torch.models.layers import Attention, RMSNorm, TensorParallel
from oron_tts_tpu_torch.models.unett import UNetTBlock
from oron_tts_tpu_torch.utils.weights import flax_init, seeded_dit_params

from test_torch_serve_load import one_thread  # noqa: F401 (autouse: tiny models)


class PlainT(Backbone):
    """A third backbone, for the test only: pre-RMSNorm blocks without skips, the time
    embedding added to every frame, no AdaLN."""

    config_fields = ("pe_attn_head",)

    def __init__(self, dim, depth, heads, dim_head, ff_mult, mel_dim, vocab_size, text_dim,
                 conv_layers, dropout, gradient_checkpointing=False, quant=None,
                 use_flash=True, attn_impl=None, pe_attn_head=None) -> None:
        super().__init__(dim, depth, heads, dim_head, ff_mult, mel_dim, vocab_size, text_dim,
                         conv_layers, dropout, gradient_checkpointing, quant)
        for i in range(depth):
            self.add_module(f"block{i}", UNetTBlock(dim, heads, dim_head, ff_mult, dropout,
                                                    quant, use_flash, attn_impl, pe_attn_head))
        self.norm_out = RMSNorm(dim)
        self.proj_out = nn.Linear(dim, mel_dim)

    def _transformer(self, h, t, mask, t_mods=None, dropout_seeds=None, batch0=0):
        if t is None:
            t = t_mods[0].expand(h.shape[0], -1)
        h = h + t[:, None].to(h.dtype)
        for i, blk in enumerate(self.blocks):
            h = blk(h, None, mask, None, None if dropout_seeds is None else dropout_seeds[i],
                    batch0)
        return self.proj_out(self.norm_out(h))

    def precompute_t_mods(self, t_emb):
        return (t_emb,)


def test_the_name_tables_agree():
    assert list(port_config.BACKBONE_DEFAULTS) == list(f5tts.BACKBONES)
    for name, cls in f5tts.BACKBONES.items():
        assert issubclass(cls, Backbone) and cls.__name__ == name
    with pytest.raises(ValueError, match="model.backbone must be one of"):
        F5Config.from_dict({"model": {"backbone": "PlainT"}})


def test_a_third_backbone_needs_its_module_and_a_row_in_each_table(monkeypatch, tmp_path):
    from oron_tts_tpu_torch.cli import train as train_cli
    from oron_tts_tpu_torch.data.dataset import FixedBatchSampler, TTSCollator, TTSDataset
    from oron_tts_tpu_torch.data.loader import DataLoader
    from oron_tts_tpu_torch.train.trainer import F5Trainer
    from oron_tts_tpu_torch.utils import memory

    monkeypatch.setitem(port_config.BACKBONE_DEFAULTS, "PlainT",
                        {"text_dim": None, "conv_layers": 1})
    monkeypatch.setitem(f5tts.BACKBONES, "PlainT", PlainT)
    counts = []
    auto = memory.auto_gradient_checkpointing

    def counted(config, frames, n_params, **kw):
        counts.append(n_params)
        return auto(config, frames, n_params, **kw)

    monkeypatch.setattr(memory, "auto_gradient_checkpointing", counted)
    cfg = {"sample_rate": 24000, "n_mels": 100, "learning_rate": 1e-3, "warmup_steps": 2,
           "use_tqdm": False, "log_interval": 1, "gradient_checkpointing": "auto",
           "model": {"backbone": "PlainT", "dim": 64, "depth": 2, "heads": 2, "ff_mult": 2,
                     "p_dropout": 0.1, "pe_attn_head": 1}}
    cfg["gradient_checkpointing"] = train_cli.decide_gradient_checkpointing(
        cfg, torch.device("cpu"))
    assert cfg["gradient_checkpointing"] is False

    model = f5tts.F5TTS(F5Config.from_dict(cfg), device="cpu")
    model.init_params(0)
    backbone = model.backbone
    assert type(backbone) is PlainT and backbone.text_embed.embed.weight.shape[1] == 100
    assert backbone.block0.attn.rope_heads == 1 and backbone.attn_impl == "lanes"
    assert counts == [model.num_params()]  # counted from its module, on the meta device

    sr, rng = 24000, np.random.default_rng(0)
    audio = [(0.3 * rng.standard_normal(int(sr * (1.0 + 0.2 * i)))).astype(np.float32)
             for i in range(2)]
    ds = TTSDataset(audio_arrays=audio, texts=["сайн байна уу"] * 2, sample_rate=sr)
    ds.durations = [len(a) / sr for a in audio]
    loader = DataLoader(ds, FixedBatchSampler(len(ds), 2, seed=1), TTSCollator(pad_to_multiple=64),
                        num_workers=0)
    trainer = F5Trainer(config=cfg, model=model, train_loader=loader,
                        log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / "ckpt"))
    before = [p.clone() for p in trainer.state.params]
    metrics = trainer.train_step(next(iter(loader)), torch.Generator().manual_seed(0))
    assert metrics["ok"] and np.isfinite(metrics["loss"])
    assert any(not torch.equal(a, b) for a, b in zip(before, trainer.state.params))


def test_the_dit_starts_from_the_jax_scheme():
    """``DiT.initial_params`` is flax's initialisers over the JAX package's tree with the
    AdaLN projections and ``proj_out`` zero, leaf for leaf and draw for draw."""
    m = ModelConfig(dim=64, depth=2, heads=2, text_dim=32, conv_layers=2)
    tree = f5tts.build_backbone(m, 100, False).initial_params(seed=3)
    want = flax_init(seeded_dit_params(m, 100, 3), np.random.default_rng(3),
                     zeroed=("attn_norm", "norm_out", "proj_out"))

    def leaves(t, path=()):
        for k, v in t.items():
            yield from leaves(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)]

    got, ref = list(leaves(tree)), list(leaves(want))
    assert [k for k, _ in got] == [k for k, _ in ref]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, ref))
    assert not tree["proj_out"]["kernel"].any() and not tree["block1"]["attn_norm"]["linear"][
        "kernel"].any()


@pytest.mark.parametrize("pe_attn_head,rank,impl", [
    (None, 0, "lanes"), (1, 0, "lanes"), (1, 1, "lanes"), (None, 1, "flash"),
])
def test_attention_undoes_its_own_shard(pe_attn_head, rank, impl):
    """After ``shard`` a rank holds half the heads (rotating head 0 only where it holds
    it); ``unshard`` restores every head, the rotated count and the impl."""
    attn = Attention(64, 4, 16, attn_impl=impl, pe_attn_head=pe_attn_head)
    whole = (attn.heads, attn.rope_heads, attn.impl, attn.tp)
    attn.shard(TensorParallel(rank, 2, None))
    assert attn.heads == 2 and attn.tp is not None
    assert attn.rope_heads == (None if pe_attn_head is None else 1 - rank)
    attn.unshard()
    assert (attn.heads, attn.rope_heads, attn.impl, attn.tp) == whole
