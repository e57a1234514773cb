"""PyTorch port, ``gradient_checkpointing: auto`` and ``utils/memory.py`` (CPU).

The config-only pieces are the JAX package's, held equal on a grid:
``dit_param_count``, ``worst_case_padded_frames`` and
``frames_for_duration``. The estimate is the port's own (its state layout,
constants fitted on the H100 by ``chip_smoke.py``'s ``memory`` phase); the
choice it makes for each shipped config at a 16, 40 and 80 GB budget and at
the H100's is pinned here, and ``cli.train`` prints the choice it takes.
"""

import itertools
import json
import signal
from pathlib import Path

import pytest
import yaml

from oron_tts_tpu.data.dataset import frames_for_duration as j_frames_for_duration
from oron_tts_tpu.utils import memory as jmem
from oron_tts_tpu_torch.cli.train import auto_remat_frames
from oron_tts_tpu_torch.config import load_config
from oron_tts_tpu_torch.data.dataset import frames_for_duration
from oron_tts_tpu_torch.models.dit import dit_param_count
from oron_tts_tpu_torch.models.f5tts import config_param_count
from oron_tts_tpu_torch.utils import memory as mem

from test_torch_serve_load import one_thread  # noqa: F401 (autouse: tiny models)

REPO = Path(__file__).resolve().parent.parent
GB = 10**9


@pytest.mark.parametrize("dim,depth,text_dim,ff_mult,conv_layers", [
    (1024, 22, 512, 4, 4), (512, 12, 256, 4, 4), (64, 2, 32, 2, 2), (768, 18, 512, 2, 3),
])
def test_param_count_equals_jax(dim, depth, text_dim, ff_mult, conv_layers):
    kw = dict(text_dim=text_dim, ff_mult=ff_mult, conv_layers=conv_layers)
    assert dit_param_count(dim, depth, **kw) == jmem.dit_param_count(dim, depth, **kw)


def test_worst_case_padded_frames_equals_jax_on_a_grid():
    # (max_samples, min_clip): with neither cap the sweep runs threshold-many rows
    caps = ((0, 94), (24, 94), (48, 94), (48, 1), (0, 300))
    for threshold, clip, rows, t_mult, (max_samples, min_clip) in itertools.product(
            (3000, 24576, 48000), (94, 1173, 2813), (1, 8, 16), (64, 256), caps):
        got = mem.worst_case_padded_frames(threshold, clip, row_multiple=rows,
                                           t_multiple=t_mult, max_samples=max_samples,
                                           min_clip_frames=min_clip)
        assert got == jmem.worst_case_padded_frames(
            threshold, clip, row_multiple=rows, t_multiple=t_mult, max_samples=max_samples,
            min_clip_frames=min_clip)
    # runpod: 17 clips of 2,816 frames (47.9k true) collate to 24 x 2,816
    assert mem.worst_case_padded_frames(48000, 2813, 8, 64, 48, 94) == 24 * 2816


def test_frames_for_duration_equals_jax():
    for seconds, rate, hop in itertools.product((0.0, 0.5, 1.0, 6.2, 15.0, 30.0),
                                                (16000, 22050, 24000), (256, 300)):
        assert frames_for_duration(seconds, rate, hop) == j_frames_for_duration(
            seconds, rate, hop)


def test_estimate_orders_and_state_layout():
    # f32 masters, EMA and second moment, a bf16 first moment and working
    # copy, f32 gradients: 20 bytes a parameter in bf16, 24 in f32
    assert mem.state_bytes_per_param() == 20
    assert mem.state_bytes_per_param(mu_bf16=False, bf16_compute=False) == 24
    n = 428_000_000
    a = mem.estimate_train_bytes(n, 24_576, 1024, 22)
    b = mem.estimate_train_bytes(n, 49_152, 1024, 22)
    r = mem.estimate_train_bytes(n, 49_152, 1024, 22, remat=True)
    f32 = mem.estimate_train_bytes(n, 24_576, 1024, 22, bf16_compute=False)
    assert b > a > r > n * 20 and f32 > a


# gradient_checkpointing: auto for every shipped config that sets it, at a
# card of 16, 40 and 80 GB and at the H100 80GB HBM3's 85,017,493,504 bytes
# (torch.cuda.mem_get_info): (worst padded frames, remat at each budget).
# runpod's 67,584 frames are estimated at 77.1 GB: no-remat on the H100,
# whose measured peak there was 75.3 GB (chip_smoke.py, memory phase)
BUDGETS = (16 * GB, 40 * GB, 80 * GB, 85_017_493_504)
AUTO = {
    "local": (22_528, (False, False, False, False)),
    "colab": (67_584, (True, False, False, False)),
    "runpod": (67_584, (True, True, True, False)),
    "bench_e2e": (45_056, (True, True, False, False)),
}


@pytest.mark.parametrize("name", sorted(AUTO))
def test_auto_choice_for_each_shipped_config(name):
    config = load_config(REPO / "configs" / f"{name}.yaml")
    assert config["gradient_checkpointing"] == "auto"
    frames, want = AUTO[name]
    assert auto_remat_frames(config) == frames
    n_params = config_param_count(config)
    got = tuple(mem.auto_gradient_checkpointing(config, frames, n_params, device_bytes=b)
                for b in BUDGETS)
    assert got == want
    # the rule itself: remat exactly when the estimate passes the budget's margin
    m = config["model"]
    need = mem.estimate_train_bytes(n_params, frames, m["dim"], m["depth"])
    for budget, remat in zip(BUDGETS, got):
        assert remat == (need > budget * mem.MEMORY_MARGIN)


def test_device_memory_needs_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: device_memory_bytes reads it")
    with pytest.raises(RuntimeError, match="CUDA"):
        mem.device_memory_bytes()
    assert mem.host_memory_bytes() > 0


def test_cli_train_prints_its_auto_choice(tmp_path, capsys):
    from oron_tts_tpu_torch.cli import train as cli_train
    from oron_tts_tpu_torch.data.wav import write_wav

    from test_torch_trainer import _synthetic_dataset

    ds = _synthetic_dataset(4)
    records = []
    for i, audio in enumerate(ds.audio_arrays):
        write_wav(tmp_path / f"clip{i}.wav", audio, 24000)
        records.append({"audio_path": str(tmp_path / f"clip{i}.wav"), "text": ds.texts[i]})
    (tmp_path / "metadata.json").write_text(json.dumps(records))
    config = yaml.safe_load((REPO / "configs" / "test.yaml").read_text())
    config["gradient_checkpointing"] = "auto"
    (tmp_path / "auto.yaml").write_text(yaml.safe_dump(config))
    prev = signal.getsignal(signal.SIGTERM)
    try:
        cli_train.main(["--config", str(tmp_path / "auto.yaml"), "--from-local", "--data-dir",
                        str(tmp_path), "--device", "cpu", "--num-epochs", "1", "--log-dir",
                        str(tmp_path / "logs"), "--checkpoint-dir", str(tmp_path / "ckpt")])
    finally:
        signal.signal(signal.SIGTERM, prev)
    # test.yaml: batches of 2 rows, 30 s clips padded to 2,816 frames; the
    # tiny model fits any host, so no rematerialisation
    assert "gradient_checkpointing=auto -> False (5632 frames)" in capsys.readouterr().out
