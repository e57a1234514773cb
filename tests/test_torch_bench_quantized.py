"""``cli.bench_quantized``: both tiers under ``--smoke`` on the CPU, and the kernel tier's
three products against the JAX package's on the same operands."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oron_tts_tpu.ops.quantized_matmul as jq
from oron_tts_tpu_torch.cli import bench_quantized
from test_torch_serve_load import one_thread  # noqa: F401 (autouse: tiny models)


def test_smoke_runs_both_tiers():
    out = bench_quantized.main(["--smoke", "--e2e"])
    assert out["device"] == "cpu" and len(out["kernel"]) == 6
    for row in out["kernel"]:
        assert all(row[f"{v}_us"] > 0 for v in ("bf16", "w8a16", "w8a8"))
        assert row["w8a16_tile"] in (64, 128, 192, 256)
        assert row["w8a16_excess"] <= row["w8a16_tol"]
    assert [r["mode"] for r in out["e2e"]] == ["bf16", "int8", "int8_dynamic"]
    for row in out["e2e"]:
        assert row["audio_s"] > 0 and math.isfinite(row["rtf"]) and row["rtf"] > 0


# (40, 64, 128) takes torch._int_mm in w8a8; bf16 x as the tier uses
@pytest.mark.parametrize("variant", ["bf16", "w8a16", "w8a8"])
def test_kernel_tier_products_match_jax(variant):
    x, w = bench_quantized.operands(40, 64, 128, "cpu", torch.Generator().manual_seed(3))
    out = bench_quantized.variants(x, w)[variant]().float().numpy()
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    w_kn = jnp.asarray(w.numpy().T)
    q_ref, s_ref = jq.quantize_weight(w_kn)
    if variant == "w8a8":
        ref = np.asarray(jq.w8a8_matmul(jx, q_ref, s_ref).astype(jnp.float32))
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * float(np.abs(ref).max()))
        return
    if variant == "w8a16":
        ref = jq.quantized_matmul_ref(jx, q_ref, s_ref)
    else:  # the JAX script's baseline: lax.dot with f32 accumulation, one cast
        ref = jax.lax.dot(jx, w_kn.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    ref = np.asarray(ref.astype(jnp.float32))
    # both accumulate in f32 and round once: a value next to a rounding boundary
    # may land one bf16 step apart (test_torch_quantized.py's bound)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(out - ref) <= ulp).all()


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_quantized.main([])
