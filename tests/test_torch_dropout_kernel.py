"""PyTorch port: the attention output's dropout and row zeroing (``hash_dropout``).

On the CPU, the wrapper's pure-Python part: a CPU call takes the plain form
and counts no launch, the launch refuses other devices, and a row mask of
the wrong size is refused.

On the card (``card`` marker; ``python -m pytest tests/test_torch_dropout_kernel.py
-m card --noconftest`` there, since this file imports no JAX):

- ``dropout_fwd`` and ``dropout_bwd`` (``csrc/gelu_dropout.cu``) bit-equal to
  :func:`dropout_plain` on the card, bf16 and f32, with and without a row
  mask: an ``n`` that is not a multiple of 8 (rows crossing inside a
  vector), a ``row0`` that carries the index past 2³², a column shard, and a
  tensor large enough for the grid to stride;
- one DiT block and one UNetT block give the same gradients through the
  kernel as through the plain form, one launch each way;
- one traced training step counts ``attn_dropout.fused_calls`` 2 × depth,
  and a sampler call none.
"""

import numpy as np
import pytest
import torch

from oron_tts_tpu_torch.ops import gelu_dropout as gd
from oron_tts_tpu_torch.utils import trace


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "tests/test_torch_dropout_kernel.py -m card --noconftest)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.stop()
    yield
    trace.stop()


# ── CPU: the wrapper ────────────────────────────────────────────────────────

def test_cpu_takes_the_plain_form_and_counts_no_launch():
    x = torch.randn(4, 6, 16)
    rows = torch.arange(6)[None, :] < torch.tensor([6, 3, 1, 0])[:, None]
    before = (gd.dropout_fwd.launches, gd.dropout_bwd.launches)
    trace.start()
    y = gd.hash_dropout(x.requires_grad_(True), 5, 0.2, rows=rows)
    y.sum().backward()
    counters = trace.stop()["counters"]
    assert torch.equal(y, gd.dropout_plain(x.detach(), 5, 0.2, rows=rows))
    assert (gd.dropout_fwd.launches, gd.dropout_bwd.launches) == before
    assert "attn_dropout.fused_calls" not in counters


@pytest.mark.parametrize("entry", ["dropout_fwd", "dropout_bwd"])
def test_launch_refuses_other_devices(entry):
    with pytest.raises(ValueError, match="unsupported device"):
        gd._launch(entry, torch.ones(8), None, 1, 0.1, 0, None, 0)


def test_row_mask_must_be_bool_with_one_element_a_row():
    x = torch.ones(3, 4, 8)
    with pytest.raises(ValueError, match="rows"):
        gd.dropout_plain(x, 1, 0.1, rows=torch.ones(3, 4))
    with pytest.raises(ValueError, match="rows"):
        gd.dropout_plain(x, 1, 0.1, rows=torch.ones(3, 5, dtype=torch.bool))


# ── the card: kernel against plain ──────────────────────────────────────────

CASES = {
    "odd_n": dict(shape=(5, 7, 33)),                         # 1,155: a tail, rows inside vectors
    "wrap": dict(shape=(6, 40, 64), row0=2**32 // 64 - 120),  # the index passes 2^32
    "column": dict(shape=(48, 24), gcols=64, col0=16),        # a tensor-parallel shard
    "column_wrap": dict(shape=(30, 40), row0=2**32 // 96 - 10, gcols=96, col0=56),
    "grid_stride": dict(shape=(9, 2000, 1024)),               # more vectors than the grid
}


@pytest.mark.card
@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "row_mask"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_is_bit_equal_to_the_plain_form(card, case, dtype, masked):
    spec = dict(CASES[case])
    shape = spec.pop("shape")
    gen = torch.Generator(device=card).manual_seed(len(case))
    x = torch.randn(shape, generator=gen, device=card).to(dtype)
    dy = torch.randn(shape, generator=gen, device=card).to(dtype)
    rows = (torch.rand(shape[:-1], generator=gen, device=card) < 0.7) if masked else None
    seed, rate = 2**31 + 12345, 0.1
    fwd, bwd = gd.dropout_fwd.launches, gd.dropout_bwd.launches
    y = gd.dropout_fwd(x, seed, rate, rows=rows, **spec)
    dx = gd.dropout_bwd(dy, seed, rate, rows=rows, **spec)
    assert (gd.dropout_fwd.launches - fwd, gd.dropout_bwd.launches - bwd) == (1, 1)
    want_y = gd.dropout_plain(x, seed, rate, rows=rows, **spec)
    want_dx = gd.dropout_plain(dy, seed, rate, rows=rows, **spec)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(y.view(bits), want_y.view(bits))  # bits: a dropped element is +0
    assert torch.equal(dx, want_dx)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["dit", "unett"])
def test_block_gradients_through_the_kernel_equal_the_plain_forms(card, monkeypatch, kind):
    from oron_tts_tpu_torch.models.dit import DiTBlock
    from oron_tts_tpu_torch.models.unett import UNetTBlock

    torch.manual_seed(0)
    dim, heads, B, T = 256, 4, 3, 200
    if kind == "dit":
        block = DiTBlock(dim, heads, 64, ff_mult=4, dropout=0.1)
    else:
        block = UNetTBlock(dim, heads, 64, ff_mult=4, dropout=0.1, pe_attn_head=1, skip=True)
    block = block.to(card, torch.bfloat16)
    gen = torch.Generator(device=card).manual_seed(1)
    x, dy = (torch.randn(B, T, dim, generator=gen, device=card).to(torch.bfloat16)
             for _ in range(2))
    # the DiT block's time embedding [B, dim], or the UNetT block's long skip [B, T, dim]
    side = torch.randn((B, dim) if kind == "dit" else (B, T, dim), generator=gen,
                       device=card).to(torch.bfloat16)
    lens = torch.tensor([200, 137, 1], device=card)
    mask = torch.arange(T, device=card)[None, :] < lens[:, None]

    def grads():
        xs = x.clone().requires_grad_(True)
        out = block(xs, side, mask=mask, seeds=(11, 12), batch0=2)
        return [g.clone() for g in torch.autograd.grad(out, [xs, *block.parameters()], dy)]

    fwd, bwd = gd.dropout_fwd.launches, gd.dropout_bwd.launches
    kernel = grads()
    torch.cuda.synchronize()
    assert (gd.dropout_fwd.launches - fwd, gd.dropout_bwd.launches - bwd) == (1, 1)
    with monkeypatch.context() as mp:
        mp.setattr(gd, "dropout_fwd", lambda x, *a: gd.dropout_plain(x, *a))
        mp.setattr(gd, "dropout_bwd", lambda dy, *a: gd.dropout_plain(dy, *a))
        plain = grads()
    bad = [i for i, (a, b) in enumerate(zip(kernel, plain)) if not torch.equal(a, b)]
    assert not bad, f"gradients differ at leaves {bad} of {len(kernel)}"


def _tiny_config(backbone: str) -> dict:
    model = {"vocab_size": 65, "dim": 128, "depth": 4, "heads": 2, "ff_mult": 2,
             "p_dropout": 0.1, "backbone": backbone}
    if backbone == "DiT":
        model.update(text_dim=32, conv_layers=2)
    else:
        model.update(text_mask_padding=False, pe_attn_head=1)
    return {"sample_rate": 24000, "n_fft": 1024, "hop_length": 256, "n_mels": 100,
            "learning_rate": 1e-3, "warmup_steps": 2, "num_epochs": 1, "ema_decay": 0.999,
            "max_grad_norm": 1.0, "grad_accumulation_steps": 1, "use_tqdm": False,
            "log_interval": 1, "save_interval": 1000, "max_checkpoints": 1, "model": model}


@pytest.mark.card
@pytest.mark.parametrize("backbone", ["DiT", "UNetT"])
def test_traced_step_counts_two_launches_a_block_and_the_sampler_none(card, tmp_path,
                                                                       backbone):
    from oron_tts_tpu_torch.config import F5Config
    from oron_tts_tpu_torch.data.dataset import FixedBatchSampler, TTSCollator, TTSDataset
    from oron_tts_tpu_torch.data.loader import DataLoader
    from oron_tts_tpu_torch.models.f5tts import F5TTS
    from oron_tts_tpu_torch.train.trainer import F5Trainer

    cfg = _tiny_config(backbone)
    sr = cfg["sample_rate"]
    arrays = [(0.4 * np.sin(2 * np.pi * (200 + 20 * i) * np.arange(int(sr * (1 + 0.3 * i)))
                            / sr)).astype(np.float32) for i in range(3)]
    ds = TTSDataset(audio_arrays=arrays, texts=["сайн байна уу"] * 3, sample_rate=sr)
    loader = DataLoader(ds, FixedBatchSampler(3, 3, seed=1), TTSCollator(pad_to_multiple=64),
                        num_workers=0)
    model = F5TTS.from_config(F5Config.from_dict(cfg), device="cuda")
    trainer = F5Trainer(config=cfg, model=model, train_loader=loader,
                        log_dir=str(tmp_path / "logs"), checkpoint_dir=str(tmp_path / "ckpt"))
    batch = next(iter(loader))
    trace.start()
    trainer.train_step(batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    counters = trace.stop()["counters"]
    assert counters.get("attn_dropout.fused_calls") == 2 * cfg["model"]["depth"]

    B, T = 2, 128
    cond = torch.zeros(B, T, 100, device=card, dtype=model.dtype)
    ids = torch.randint(1, 64, (B, T), device=card, dtype=torch.int32)
    launches = (gd.dropout_fwd.launches, gd.dropout_bwd.launches)
    trace.start()
    with torch.no_grad():
        mel, _ = model.cfm.sample(cond, ids, torch.tensor([128, 100]), torch.tensor([0, 10]),
                                  steps=2)
    torch.cuda.synchronize()
    counters = trace.stop()["counters"]
    assert "attn_dropout.fused_calls" not in counters
    assert (gd.dropout_fwd.launches, gd.dropout_bwd.launches) == launches
    assert torch.isfinite(mel.float()).all()
