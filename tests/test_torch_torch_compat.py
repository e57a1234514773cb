"""PyTorch port, the reference's torch checkpoint layout against the JAX package (CPU).

``oron_tts_tpu_torch/utils/torch_compat.py`` maps the flax tree to the
reference F5TTS's torch keys and back, as the JAX module does, and reads and
writes ``.safetensors`` itself. On seeded flax parameters of
``configs/test.yaml``: the export equals JAX's key for key and bit for bit,
the conversion back gives the same tree, and ``.pt``/``.safetensors`` files
load through ``cli.infer.load_model`` to the model an ``.npz`` gives;
``cli.export`` writes them and ``cli.train --pretrain-ckpt`` reads them.
"""

import json
import struct

import numpy as np
import pytest
import torch

from oron_tts_tpu.utils import torch_compat as jtc
from oron_tts_tpu_torch.cli.infer import load_model
from oron_tts_tpu_torch.config import ModelConfig, load_config
from oron_tts_tpu_torch.train.checkpoint import flatten_tree, write_npz
from oron_tts_tpu_torch.utils import torch_compat as tc
from oron_tts_tpu_torch.utils.weights import seeded_dit_params

from conftest import REPO_ROOT

MEL_ATOL = 1e-6  # the same f32 weights and noise: only identical arithmetic


def _config() -> dict:
    return load_config(REPO_ROOT / "configs" / "test.yaml")


def _params(seed: int) -> dict:
    m = _config()["model"]
    return seeded_dit_params(ModelConfig(
        vocab_size=m["vocab_size"], dim=m["dim"], depth=m["depth"], heads=m["heads"],
        ff_mult=m["ff_mult"], text_dim=m["text_dim"], conv_layers=m["conv_layers"]), seed=seed)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _assert_trees_equal(got, ref):
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_export_matches_jax_key_for_key_bit_for_bit():
    params = _params(2)
    got, ref = tc.export_f5tts_state_dict(params), jtc.export_f5tts_state_dict(params)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and np.array_equal(got[k], ref[k]), k
    assert all(k.startswith("cfm.backbone.") for k in got)
    assert tc.export_dit_state_dict(params).keys() == jtc.export_dit_state_dict(params).keys()


def test_convert_of_a_jax_export_gives_the_same_tree():
    params = _params(2)
    sd = jtc.export_f5tts_state_dict(params)
    m = _config()["model"]
    got = tc.convert_f5tts_state_dict(sd, depth=m["depth"], conv_layers=m["conv_layers"])
    _assert_trees_equal(got, params)
    _assert_trees_equal(got, jtc.convert_f5tts_state_dict(
        sd, depth=m["depth"], conv_layers=m["conv_layers"]))
    # DiT-level keys and torch.compile's prefixes (top level and mid-key)
    dit = {("_orig_mod." + k if i % 2 else k.replace(".attn.", "._orig_mod.attn.")): torch.from_numpy(v)
           for i, (k, v) in enumerate(jtc.export_dit_state_dict(params).items())}
    assert tc.strip_compiled_prefix(dit).keys() == jtc.strip_compiled_prefix(dit).keys()
    _assert_trees_equal(tc.convert_f5tts_state_dict(dit, m["depth"], m["conv_layers"]), params)


def test_merge_compatible_matches_jax():
    base, loaded = _params(2), _params(3)
    loaded["text_embed"]["embed"]["embedding"] = np.zeros((80, 32), np.float32)  # other vocab
    del loaded["block1"]["ff"]["in_proj"]["bias"]
    merged, skipped = tc.merge_compatible(base, loaded)
    ref_merged, ref_skipped = jtc.merge_compatible(base, loaded)
    assert skipped == ref_skipped
    assert skipped == ["block1/ff/in_proj/bias (missing)", "text_embed/embed/embedding"]
    _assert_trees_equal(merged, {k: v for k, v in ref_merged.items()})
    assert np.array_equal(merged["block0"]["attn"]["to_q"]["kernel"],
                          loaded["block0"]["attn"]["to_q"]["kernel"])
    assert np.array_equal(merged["text_embed"]["embed"]["embedding"],
                          base["text_embed"]["embed"]["embedding"])


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """test.yaml's config.json, an .npz (raw seed 2, EMA seed 3) and torch files of both."""
    d = tmp_path_factory.mktemp("compat")
    raw, ema = _params(2), _params(3)
    write_npz(d / "f5tts_step_00000001.npz", flatten_tree({"params": raw, "ema": ema}))
    (d / "config.json").write_text(json.dumps(_config()))
    to_t = lambda sd: {k: torch.from_numpy(v.copy()) for k, v in sd.items()}  # noqa: E731
    raw_sd, ema_sd = jtc.export_f5tts_state_dict(raw), jtc.export_f5tts_state_dict(ema)
    torch.save({"ema_state_dict": to_t(ema_sd), "model_state_dict": to_t(raw_sd)}, d / "both.pt")
    torch.save({"model_state_dict": to_t(raw_sd)}, d / "raw.pt")
    torch.save({"ema_state_dict": {"_orig_mod." + k: v for k, v in to_t(ema_sd).items()}},
               d / "compiled.pt")
    tc.save_safetensors(ema_sd, d / "ema.safetensors")
    return d


def _mel(model) -> np.ndarray:
    return model.synthesize_mel("сайн байна уу", n_steps=2, seed=7)


@pytest.mark.parametrize("name,use_ema,which", [
    ("both.pt", True, "ema"), ("both.pt", False, "raw"), ("raw.pt", True, "raw"),
    ("compiled.pt", True, "ema"), ("ema.safetensors", True, "ema"),
])
def test_torch_files_load_like_the_npz(ckpt_dir, name, use_ema, which):
    ref = _mel(load_model(str(ckpt_dir), use_ema=which == "ema", device="cpu"))
    got = _mel(load_model(str(ckpt_dir / name), use_ema=use_ema, device="cpu"))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= MEL_ATOL


@pytest.mark.parametrize("fmt,no_ema", [("pt", False), ("safetensors", False), ("pt", True)])
def test_export_cli_round_trips_through_load_model(ckpt_dir, tmp_path, fmt, no_ema):
    from oron_tts_tpu_torch.cli import export

    out = tmp_path / f"f5tts.{fmt}"
    export.main(["--checkpoint", str(ckpt_dir), "--output", str(out)]
                + (["--no-ema"] if no_ema else []))
    if fmt == "pt":
        key = "model_state_dict" if no_ema else "ema_state_dict"
        assert list(torch.load(out, weights_only=True)) == [key]
    (tmp_path / "config.json").write_text((ckpt_dir / "config.json").read_text())
    ref = _mel(load_model(str(ckpt_dir), use_ema=not no_ema, device="cpu"))
    got = _mel(load_model(str(out), use_ema=not no_ema, device="cpu"))
    assert np.abs(got - ref).max() <= MEL_ATOL


def _seeded_tensors(dtype):
    g = torch.Generator().manual_seed(0)
    return {"a.weight": torch.randn(3, 5, generator=g).to(dtype),
            "b": torch.randn(7, generator=g).to(dtype),
            "scalar": torch.tensor(1.5).to(dtype),
            "empty": torch.zeros(0, 4, dtype=dtype)}


def test_safetensors_f32_crosses_the_safetensors_package(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    tensors = {k: v.numpy() for k, v in _seeded_tensors(torch.float32).items()}
    tensors["ids"] = np.arange(6, dtype=np.int64).reshape(2, 3)
    tc.save_safetensors(tensors, tmp_path / "port.safetensors")
    back = st.load_file(str(tmp_path / "port.safetensors"))
    assert sorted(back) == sorted(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    st.save_file(tensors, str(tmp_path / "lib.safetensors"))
    for path in ("port.safetensors", "lib.safetensors"):
        got = tc.load_safetensors(tmp_path / path)
        for k, v in tensors.items():
            assert np.array_equal(got[k].numpy(), v), (path, k)


def test_safetensors_bf16_crosses_the_safetensors_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = _seeded_tensors(torch.bfloat16)
    tc.save_safetensors(tensors, tmp_path / "port.safetensors")
    back = st.load_file(str(tmp_path / "port.safetensors"))
    for k, v in tensors.items():
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], v), k
    st.save_file(tensors, str(tmp_path / "lib.safetensors"), metadata={"format": "pt"})
    got = tc.load_safetensors(tmp_path / "lib.safetensors")  # skips __metadata__
    for k, v in tensors.items():
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], v), k
    # numpy has no bf16: a checkpoint reads widened to f32, exactly
    widened = tc.load_torch_checkpoint(tmp_path / "lib.safetensors")
    assert widened["b"].dtype == np.float32
    assert np.array_equal(widened["b"], tensors["b"].float().numpy())


def test_bad_safetensors_headers_raise_value_error(tmp_path):
    tc.save_safetensors({"w": np.ones((4, 4), np.float32)}, tmp_path / "ok.safetensors")
    data = (tmp_path / "ok.safetensors").read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8: 8 + n])
    cases = {
        "short": data[:5],
        "truncated": data[: 8 + n // 2],
        "not_json": data[:8] + b"{" * n + data[8 + n:],
        "bad_dtype": None, "bad_offsets": None,
    }
    for name, info in (("bad_dtype", {"dtype": "Q9"}), ("bad_offsets", {"data_offsets": [0, 8]})):
        h = json.dumps({"w": header["w"] | info}).encode()
        h += b" " * (-len(h) % 8)
        cases[name] = struct.pack("<Q", len(h)) + h + data[8 + n:]
    for name, blob in cases.items():
        path = tmp_path / f"{name}.safetensors"
        path.write_bytes(blob)
        with pytest.raises(ValueError):
            tc.load_safetensors(path)


def test_pretrain_ckpt_skips_a_tensor_of_another_shape_and_prints_it(tmp_path, capsys):
    from oron_tts_tpu_torch.cli import make_tone_corpus, train

    sd = {k: torch.from_numpy(v.copy()) for k, v in jtc.export_f5tts_state_dict(_params(4)).items()}
    sd["cfm.backbone.text_embed.text_embed.weight"] = torch.zeros(80, 32)  # another vocabulary
    torch.save({"ema_state_dict": sd}, tmp_path / "pretrained.pt")
    make_tone_corpus.main(["--out", str(tmp_path / "corpus"), "--sentences", "12"])
    train.main(["--config", str(REPO_ROOT / "configs" / "test.yaml"), "--from-local",
                "--data-dir", str(tmp_path / "corpus"), "--num-epochs", "1", "--device", "cpu",
                "--pretrain-ckpt", str(tmp_path / "pretrained.pt"),
                "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs")])
    out = capsys.readouterr().out
    assert "Shape-skipped pretrained keys" in out and "text_embed/embed/embedding" in out
    assert f"Loaded pretrained weights from {tmp_path / 'pretrained.pt'}" in out
