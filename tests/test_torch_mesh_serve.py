"""PyTorch port, serving on a CPU gloo mesh against the single-process port.

``synthesize_batch`` of eight texts under DP 2 × TP 2 (four ranks: each data
rank solves and decodes its rows, the waveforms gathered) and a one-chunk
``synthesize`` (replicated over the data ranks, TP still sharding the math)
match the single-process port at atol 2e-3; ``quantize_for_serving("int8")``
under a mesh and ``set_mesh`` on an ``int8`` model raise the w8a16 refusal,
``int8_dynamic`` is accepted. ``cli.serve --mesh 2x1`` over two ranks
answers /healthz with the mesh's shape, a /synthesize and a burst of eight
that merges, each equal to the single-process audio, and drains, stopping
its follower.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_mesh_common import (
    SERVE_TEXTS,
    load_npz,
    rank_results,
    spawn,
    tiny_serving_model,
    write_tiny_checkpoint,
)
from test_torch_serve_load import one_thread  # noqa: F401 (autouse: tiny models)

ATOL = 2e-3


def test_synthesize_batch_and_b1_under_dp2_tp2(tmp_path):
    spawn("serve", 4, tmp_path, {"dp": 2, "tp": 2})
    ranks = rank_results(tmp_path, 4)
    got = load_npz(tmp_path / "serve.npz")
    ref = tiny_serving_model(None)
    want = ref.synthesize_batch(SERVE_TEXTS, n_steps=2, seed=0)
    assert all(r["n"] == 8 and r["heads"] == 2 for r in ranks)  # 4 heads over TP 2
    for i, w in enumerate(want):
        assert got[f"w{i}"].shape == w.shape
        np.testing.assert_allclose(got[f"w{i}"], w, atol=ATOL)
    one = ref.synthesize("сайн байна уу", n_steps=2, seed=0)
    assert got["one"].shape == one.shape and np.isfinite(got["one"]).all()
    np.testing.assert_allclose(got["one"], one, atol=ATOL)
    for r in ranks:
        assert "single-device" in r["int8_refused"] and "int8_dynamic" in r["int8_refused"]
        assert "single-device" in r["set_mesh_refused"]
    # int8_dynamic is accepted under the mesh and keeps every row finite
    assert all(np.isfinite(got[f"d{i}"]).all() and got[f"d{i}"].size for i in range(4))


def test_cli_serve_mesh_2x1(tmp_path):
    ckpt, vocoder = write_tiny_checkpoint(tmp_path / "model")
    argv = ["--checkpoint", str(ckpt), "--vocoder", str(vocoder), "--device", "cpu",
            "--port", "0", "--mesh", "2x1", "--request-timeout", "60"]
    spawn("cli_serve", 2, tmp_path / "run", {"argv": argv})
    r0, r1 = rank_results(tmp_path / "run", 2)
    assert r1 == {"follower": True}
    assert r0["health"]["mesh"] == {"data": 2, "model": 1} and r0["health"]["status"] == "ok"
    assert r0["codes"] == [200] * 9, r0["errors"]
    assert r0["after"]["merged_batches"] >= 1
    from oron_tts_tpu_torch.cli.infer import load_model

    model = load_model(str(ckpt), device="cpu")
    model.load_vocoder(str(vocoder))
    got = load_npz(tmp_path / "run" / "serve_cli.npz")
    pcm = 2.5 / 32767  # the WAV's PCM16 rounding, of audio clipped to [-1, 1]
    want = model.synthesize("сайн байна уу", n_steps=2, seed=3)
    np.testing.assert_allclose(got["one"], np.clip(want, -1, 1), atol=ATOL + pcm)
    for i in range(8):
        want = model.synthesize(f"сайн байна уу {i}", n_steps=2, seed=10 + i)
        np.testing.assert_allclose(got[f"b{i}"], np.clip(want, -1, 1), atol=ATOL + pcm)


@pytest.mark.parametrize("bad", ["4x1", "1x3"])
def test_set_mesh_needs_the_world(bad):
    from oron_tts_tpu_torch.parallel.mesh import mesh_from_spec

    with pytest.raises(ValueError, match="torch.distributed.run --nproc-per-node"):
        mesh_from_spec(bad, device="cpu")
    assert not torch.distributed.is_initialized()
