"""PyTorch port, the calibrated ref-free duration against the JAX package (CPU).

``oron_tts_tpu_torch/data/duration_stats.py`` is the port's own copy of the
JAX module: its table fit, its estimate and its corpus entry point must give
the JAX results on the same seeded texts and durations. Then a checkpoint
directory on ``configs/test.yaml`` whose ``config.json`` carries a fitted
table loads through both packages' ``cli.infer.load_model``, and the facades'
duration cascades agree for ref-free, voice-cloned and explicit-duration
calls.
"""

import json

import numpy as np
import pytest

from oron_tts_tpu.data import duration_stats as jds
from oron_tts_tpu_torch.config import ModelConfig, load_config
from oron_tts_tpu_torch.data import duration_stats as tds
from oron_tts_tpu_torch.text.cleaner import TextCleaner
from oron_tts_tpu_torch.train.checkpoint import flatten_tree, write_npz
from oron_tts_tpu_torch.utils.weights import seeded_dit_params

from conftest import REPO_ROOT

WORDS = ("сайн", "байна", "уу", "монгол", "хэл", "өнөөдөр", "цаг", "агаар", "сайхан",
         "қазақ", "тілі", "2024", "оны", "10", "сар")


def _corpus(seed: int, n: int):
    """Seeded texts, languages and durations in seconds (~0.07 s a letter)."""
    rng = np.random.default_rng(seed)
    texts, langs, durs = [], [], []
    for _ in range(n):
        words = rng.choice(WORDS, size=int(rng.integers(2, 9)))
        text = " ".join(words)
        texts.append(text)
        langs.append("kz" if "қазақ" in words else "mn")
        durs.append(float(0.07 * len(text.replace(" ", "")) + rng.uniform(0.1, 0.6)))
    return texts, langs, durs


@pytest.mark.parametrize("ridge,min_count", [(1.0, 5), (0.1, 1), (10.0, 50)])
def test_fit_and_estimate_match_jax(ridge, min_count):
    rng = np.random.default_rng(7)
    ids = [list(rng.integers(0, 70, size=int(rng.integers(3, 30)))) for _ in range(40)]
    frames = [float(11.0 * len(s) + rng.normal(0, 5)) for s in ids]
    got = tds.fit_duration_table(ids, frames, ridge=ridge, min_count=min_count)
    ref = jds.fit_duration_table(ids, frames, ridge=ridge, min_count=min_count)
    assert got == ref
    for speed in (1.0, 0.8, 1.3):
        for seq in ids[:10] + [[], [3, 99, -1]]:
            assert tds.estimate_frames(seq, got, speed) == jds.estimate_frames(seq, ref, speed)
    assert tds.estimate_frames([1, 2], None) is None and jds.estimate_frames([1, 2], None) is None


@pytest.mark.parametrize("n", [30, 5])
def test_stats_from_texts_matches_jax(n):
    texts, langs, durs = _corpus(3, n)
    got = tds.stats_from_texts(texts, langs, durs, 24000, 256)
    ref = jds.stats_from_texts(texts, langs, durs, 24000, 256)
    assert got == ref
    assert (got is None) == (n < 8)
    if got is not None:
        assert len(got["fpc"]) == 65 and got["n"] == n


def _checkpoint(tmp_path, table):
    """A configs/test.yaml checkpoint directory whose config.json holds ``table``."""
    config = load_config(REPO_ROOT / "configs" / "test.yaml")
    config["duration_stats"] = table
    m = config["model"]
    params = seeded_dit_params(ModelConfig(
        vocab_size=m["vocab_size"], dim=m["dim"], depth=m["depth"], heads=m["heads"],
        ff_mult=m["ff_mult"], text_dim=m["text_dim"], conv_layers=m["conv_layers"]), seed=2)
    write_npz(tmp_path / "f5tts_step_00000003.npz", flatten_tree({"params": params}))
    (tmp_path / "config.json").write_text(json.dumps(config))
    return tmp_path


def test_a_calibrated_table_loads_and_sets_the_same_lengths(tmp_path):
    from oron_tts_tpu.cli.infer import load_model as jax_load_model
    from oron_tts_tpu_torch.cli.infer import load_model

    texts, langs, durs = _corpus(11, 40)
    table = tds.stats_from_texts(texts, langs, durs, 24000, 256)
    assert table is not None
    path = _checkpoint(tmp_path, table)
    port = load_model(str(path), device="cpu")
    ref = jax_load_model(str(path), precision="float32")
    assert port.duration_stats == ref.duration_stats == table

    cleaner = TextCleaner()
    ref_text = "өнөөдөр цаг агаар сайхан байна"
    ref_ids = cleaner.text_to_sequence(ref_text, lang="mn")
    checked = 0
    for text, lang in zip(texts[:8] + ["уу", "монгол хэл 2024 оны 10 сар"], langs[:8] + ["mn"] * 2):
        ids = cleaner.text_to_sequence(text, lang=lang)
        for speed in (1.0, 0.7):
            for args in ((None, 0, []),            # ref-free: the calibrated rung
                         (None, 431, ref_ids),     # voice-cloned: the reference's ratio
                         (2.5, 0, [])):            # an explicit duration
                got = port._target_len(text, ids, args[0], args[1], args[2], speed)
                assert got == ref._target_len(text, ids, args[0], args[1], args[2], speed)
                checked += 1
        # the table, not chars·13, sets the ref-free length
        free = port._target_len(text, ids, None, 0, [], 1.0)
        assert free == tds.estimate_frames(ids, table, 1.0)
    assert checked == 60
    # without a table both fall back to chars·13
    port.set_duration_stats(None)
    ref.set_duration_stats(None)
    ids = cleaner.text_to_sequence(texts[0], lang=langs[0])
    assert (port._target_len(texts[0], ids, None, 0, [], 1.0)
            == ref._target_len(texts[0], ids, None, 0, [], 1.0)
            == max(50, int(len(texts[0].replace(" ", "")) * 13)))
