"""PyTorch port, the w8a16 kernel's launch plan (``ops/quantized_matmul.py``).

``qmm_plan`` picks the bf16 kernel's tile (x rows a block) from the shape
alone, so it is held here on the CPU: at every serving shape of the Base and
Small configs the grid fills the H100's 132 SMs or holds every tile in its
one wave, no other tile gives fewer waves of blocks times their length, the
blocks cover every row and column, and a K the kernel cannot take is
refused before any launch.
"""

from pathlib import Path

import pytest

from oron_tts_tpu_torch.config import F5Config, ModelConfig
from oron_tts_tpu_torch.ops import quantized_matmul as tq

SMS = 132
REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"base": F5Config().model,
           "small": F5Config.from_file(REPO / "configs" / "local.yaml").model}
# M = 2 CFG rows x the frame bucket, for one request (832: the 60-letter
# sentence; 1,600: a voice-cloned request) and for a merged solve of eight
# rows of 832; 6,144 is the middle shape chip_smoke.py times
SERVING_M = (2 * 832, 2 * 1600, 6144, 8 * 2 * 832)


def _projections(model: ModelConfig) -> list[tuple[int, int]]:
    """(K, N) of a DiT block's six int8 projections: q, k, v, out, ff1, ff2."""
    d, ff = model.dim, model.dim * model.ff_mult
    inner = model.heads * model.dim_head
    return [(d, inner)] * 3 + [(inner, d), (d, ff), (ff, d)]


def _waves(m, n, bm):
    return -(-(-(-m // bm) * -(-n // tq.QMM_BN)) // SMS)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("m", SERVING_M)
def test_plan_fills_the_card_at_every_serving_shape(config, m):
    for k, n in _projections(CONFIGS[config]):
        plan = tq.qmm_plan(m, k, n)
        tiles = -(-m // plan.bm) * -(-n // tq.QMM_BN)
        assert plan.bm in tq.QMM_TILES and plan.blocks == tiles
        # a full wave, or every tile in the one wave a shape this size can take
        assert plan.blocks >= SMS or _waves(m, n, plan.bm) == 1, (config, m, k, n, plan)
        cost = _waves(m, n, plan.bm) * (plan.bm + tq.QMM_BLOCK_COST)
        assert all(cost <= _waves(m, n, bm) * (bm + tq.QMM_BLOCK_COST) for bm in tq.QMM_TILES)


@pytest.mark.parametrize("m, k, n, plan", [
    # a handful of rows, and a short request (two CFG rows of a 64-frame
    # bucket): the narrowest tile, in one partial wave
    (13, 1024, 1024, (64, 8)),
    (128, 1024, 1024, (64, 16)),
    (200, 4096, 136, (64, 8)),
    # one request's projections: 104 tiles of 128 x 128 in one wave
    (1664, 1024, 1024, (128, 104)),
    (1664, 1024, 4096, (256, 224)),
    # a merged solve of eight: 192- and 256-row tiles
    (13312, 1024, 1024, (192, 560)),
    (13312, 1024, 4096, (256, 1664)),
])
def test_plan_picks_the_tile_by_shape(m, k, n, plan):
    assert tq.qmm_plan(m, k, n) == tq.QmmPlan(*plan)


@pytest.mark.parametrize("n", [40, 136, 1024, 4096])
def test_plan_blocks_cover_every_row_and_column(n):
    for m in (*range(1, 300), 1000, 1664, 3200, 6144, 13312, 20000):
        plan = tq.qmm_plan(m, 1024, n)
        rows, cols = -(-m // plan.bm), -(-n // tq.QMM_BN)
        assert plan.blocks == rows * cols, (m, n, plan)
        assert (rows - 1) * plan.bm < m <= rows * plan.bm  # no block is all padding


@pytest.mark.parametrize("k", [8, 24, 100, 1030])
def test_plan_refuses_k_not_a_multiple_of_16(k):
    with pytest.raises(ValueError, match="multiple of 16"):
        tq.qmm_plan(1664, k, 1024)
