"""PyTorch port, the mesh's pieces that run in one process, against the JAX package.

- the rule table on the port's names, leaf for leaf against
  ``oron_tts_tpu.parallel.mesh.param_specs`` (flax kernels are ``[in, out]``,
  torch weights ``[out, in]``: the sharded axis flips), the int8 tree too,
  and ZeRO-1's ``opt_specs`` against JAX's at ``make_mesh(4, 2)``'s sizes;
- ``make_mesh`` refusing a world it does not cover (naming ``torchrun``),
  and a world of one;
- ``host_shard_wraparound`` and ``GlobalBatchSchedule``: plans and slices
  equal to JAX's over seeds, epochs, frame and fixed modes, 1 to 4 hosts;
  the collator's scheduled pad targets and all-padding batch; the loader
  forwarding the schedule's kwargs;
- the GELU+dropout and ``hash_dropout`` plain versions by global index: a
  column, a row and a 2 × 2 shard equal the slice of the whole tensor's
  mask, the row shard equals the JAX package's ``_keep_mask`` at that row,
  and offset 0 keeps the flat index's bits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oron_tts_tpu.data import dataset as jds
from oron_tts_tpu.parallel import mesh as jmesh
from oron_tts_tpu_torch.data import dataset as tds
from oron_tts_tpu_torch.parallel import mesh as tmesh


def _jax_dit_params(quant: bool = False):
    from oron_tts_tpu.models.dit import DiT, quantize_dit_params

    model = DiT(dim=64, depth=1, heads=4, dim_head=16, mel_dim=8, text_dim=16,
                conv_layers=1, dropout=0.0)
    x = jnp.zeros((1, 16, 8))
    params = model.init(jax.random.PRNGKey(0), x, x, jnp.zeros((1, 16), jnp.int32),
                        jnp.zeros((1,)))["params"]
    return quantize_dit_params(params) if quant else params


def _port_names(quant: bool = False) -> dict[str, tuple[int, ...]]:
    from oron_tts_tpu_torch.models.dit import DiT, quantize_dit_params

    dit = DiT(dim=64, depth=1, heads=4, dim_head=16, mel_dim=8, text_dim=16, conv_layers=1,
              dropout=0.0)
    if quant:
        quantize_dit_params(dit, "int8_dynamic")
    return {k: tuple(v.shape) for k, v in dit.state_dict().items()}


def _jax_leaf(flat: dict, name: str):
    """The JAX path of a port name (kernel/embedding/scale → weight, kernel_q → weight_q)."""
    base = name.replace(".", "/")
    if base.endswith("/weight_q"):
        return base[: -len("weight_q")] + "kernel_q"
    if base.endswith("/weight"):
        for leaf in ("kernel", "embedding", "scale"):
            key = base[: -len("weight")] + leaf
            if key in flat:
                return key
    return base


def _flat_with_paths(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        out["/".join(k.key for k in path)] = leaf
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_param_specs_are_the_jax_rules_on_torch_names(quant):
    params = _jax_dit_params(quant)
    jspecs = _flat_with_paths(jmesh.param_specs(params))
    jshapes = {k: v.shape for k, v in _flat_with_paths(params).items()}
    names = _port_names(quant)
    specs = tmesh.param_specs(names)
    assert len(specs) == len(jspecs)
    sharded = 0
    for name, spec in specs.items():
        key = _jax_leaf(jspecs, name)
        want = tuple(jspecs[key])
        if len(names[name]) == 2 and key.endswith(("kernel", "kernel_q")):  # dense [out, in]
            want = tuple(reversed(want + (None,) * (2 - len(want))))
        assert tuple(spec) + (None,) * (len(want) - len(spec)) == want or (
            not want and not spec), (name, spec, want)
        sharded += "model" in spec
    # q/k/v and in_proj: weight and bias (and scale); to_out and out_proj: the weight
    assert sharded == (14 if quant else 10)
    w = "weight_q" if quant else "weight"
    assert specs[f"block0.attn.to_q.{w}"] == ("model", None)
    assert specs[f"block0.attn.to_out.{w}"] == (None, "model")
    assert specs["proj_out.weight"] == ()


def test_opt_specs_are_jax_zero1_at_4x2():
    import optax

    params = _jax_dit_params()
    state = optax.adamw(1e-3).init(params)
    jspecs = _flat_with_paths(jmesh.opt_specs(state, params, 4)[0].mu)
    jshapes = {k: v.shape for k, v in _flat_with_paths(params).items()}
    names = _port_names()
    # the moments of a TP-2 rank: model-sharded axes halved
    local = {}
    for name, shape in names.items():
        spec = tmesh.spec_for_name(name)
        local[name] = tuple(s // 2 if i < len(spec) and spec[i] == "model" else s
                            for i, s in enumerate(shape))
    specs = tmesh.opt_specs(local, 4)
    for name, spec in specs.items():
        key = _jax_leaf(jspecs, name)
        want = tuple(jspecs[key])
        want = want + (None,) * (len(jshapes[key]) - len(want))
        if len(names[name]) == 2 and key.endswith(("kernel", "kernel_q")):
            want = tuple(reversed(want))
        got = tuple(spec) + (None,) * (len(names[name]) - len(spec))
        assert got == want, (name, got, want)
    assert specs["block0.attn.to_q.weight"] == ("model", "data")


def test_make_mesh_refuses_a_world_it_does_not_cover(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for spec in ("4x2", "2", "1x2"):
        with pytest.raises(ValueError, match=r"does not cover 1 process: .*"
                                             r"torch\.distributed\.run --nproc-per-node"):
            tmesh.mesh_from_spec(spec, device="cpu")
    with pytest.raises(ValueError, match="DPxTP"):
        tmesh.mesh_from_spec("ax2", device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="mesh 2x2 does not cover 8 processes"):
        tmesh.make_mesh(2, 2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_world_of_one_mesh(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    mesh = tmesh.mesh_from_spec("1x1", device="cpu")
    try:
        assert mesh.shape == {"data": 1, "model": 1} and mesh.is_main
        assert mesh.data_group is None and mesh.model_group is None
        t = torch.arange(4.0)
        assert torch.equal(tmesh.all_reduce_sum(t.clone(), mesh.world_group), t)
        tree = {"a/b": np.arange(6, dtype=np.float32).reshape(2, 3), "c": np.int32(3)}
        tree = {k: np.asarray(v) for k, v in tree.items()}
        got = tmesh.broadcast_tree(tree)
        assert all(np.array_equal(got[k], tree[k]) for k in tree)
        assert tmesh.broadcast_tree({"found": True, "step": 5}) == {"found": True, "step": 5}
    finally:
        torch.distributed.destroy_process_group()


def test_host_shard_wraparound_matches_jax():
    idx = list(range(10))
    for hosts in range(1, 5):
        for h in range(hosts):
            assert tmesh.host_shard_wraparound(idx, hosts, h) == jmesh.host_shard_wraparound(
                idx, hosts, h)


@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["frame", "fixed", "fixed_ordered"])
def test_global_batch_schedule_equals_jax(hosts, mode):
    rng = np.random.default_rng(hosts)
    frames = [int(f) for f in rng.integers(80, 700, size=23)]
    if mode == "frame":
        kw = dict(frames_threshold=1500, max_samples=6)
    else:
        kw = dict(batch_size=3, shuffle=mode == "fixed")
    for seed in (0, 5):
        for h in range(hosts):
            ours = tds.GlobalBatchSchedule(frames, num_hosts=hosts, host_id=h,
                                           pad_to_multiple=64, seed=seed, **kw)
            ref = jds.GlobalBatchSchedule(frames, num_hosts=hosts, host_id=h,
                                          pad_to_multiple=64, seed=seed, **kw)
            for epoch in (0, 1, 2):
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
                assert len(ours) == len(ref)
                assert list(ours) == list(ref)
    with pytest.raises(ValueError):
        tds.GlobalBatchSchedule(frames, num_hosts=2, host_id=0)
    with pytest.raises(ValueError):
        tds.GlobalBatchSchedule(frames, num_hosts=2, host_id=2, batch_size=2)


def test_collator_scheduled_pad_targets_equal_jax():
    item = {"mel": np.ones((4, 100), np.float32), "text_ids": np.arange(100, dtype=np.int32),
            "mask": np.ones(100, bool)}
    ours = tds.TTSCollator(pad_to_multiple=64, n_mels=4)
    ref = jds.TTSCollator(pad_to_multiple=64, n_mels=4)
    for items, kw in (([item], {"pad_t_to": 192, "pad_rows_to": 3}),
                      ([item], {"pad_t_to": 96, "pad_rows_to": 1}),   # cropped
                      ([], {"pad_t_to": 64, "pad_rows_to": 2}),      # all failed
                      ([item, item], {})):
        got, want = ours(items, **kw), ref(items, **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    out = ours([], pad_t_to=64, pad_rows_to=2)
    assert out["mel"].shape == (2, 4, 64) and not out["mel_lengths"].any()
    with pytest.raises(ValueError, match="pad_t_to"):
        ours([])


def test_loader_forwards_the_schedule_and_emits_padding_for_a_failed_batch():
    from oron_tts_tpu_torch.data.loader import DataLoader

    class Broken:
        def __getitem__(self, i):
            raise OSError("unreadable")

    entries = [([0, 1], {"pad_t_to": 128, "pad_rows_to": 2}), [2]]
    for workers in (0, 2):
        loader = DataLoader(Broken(), entries, tds.TTSCollator(n_mels=4), num_workers=workers)
        batches = list(loader)
        # the scheduled step still arrives, as pure padding; the unscheduled one is skipped
        assert len(batches) == 1 and batches[0]["mel"].shape == (2, 4, 128)


SHARDS = {  # (rows, cols) slices of a [4 × 6 rows, 64] tensor
    "column": (slice(None), slice(32, 64)),
    "row": (slice(12, 24), slice(None)),
    "2x2": (slice(12, 24), slice(0, 32)),
}


@pytest.mark.parametrize("shard", list(SHARDS))
def test_dropout_masks_by_global_index(shard):
    from oron_tts_tpu_torch.ops import gelu_dropout as gd

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 6, 64)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((4, 6, 64)).astype(np.float32))
    rows, cols = SHARDS[shard]
    flat_x, flat_dy = x.reshape(24, 64), dy.reshape(24, 64)
    part, part_dy = flat_x[rows, cols].contiguous(), flat_dy[rows, cols].contiguous()
    place = dict(row0=rows.start or 0, gcols=64, col0=cols.start or 0)
    seed, rate = 1234567, 0.3
    cases = (
        (gd.gelu_dropout_plain(part, seed, rate, **place),
         gd.gelu_dropout_plain(flat_x, seed, rate)),
        (gd.gelu_dropout_bwd_plain(part, part_dy, seed, rate, **place),
         gd.gelu_dropout_bwd_plain(flat_x, flat_dy, seed, rate)),
        (gd.hash_dropout(part, seed, rate, **place), gd.hash_dropout(flat_x, seed, rate)),
        (gd.gelu_dropout(part, seed, rate, **place), gd.gelu_dropout(flat_x, seed, rate)),
    )
    for got, whole in cases:
        assert torch.equal(got, whole[rows, cols])
    if shard == "row":  # the JAX package's own mask at that row offset
        from oron_tts_tpu.ops.gelu_dropout import _keep_mask

        thr = gd._threshold(rate)
        want = np.asarray(_keep_mask(jnp.int32(seed), jnp.int32(12), (12, 64), 64, thr))
        keep = gd.keep_mask_plain(12 * 64, seed, thr, "cpu", 64, row0=12).reshape(12, 64)
        np.testing.assert_array_equal(keep.numpy(), want)


def test_offset_zero_keeps_the_flat_index():
    from oron_tts_tpu_torch.ops import gelu_dropout as gd

    seed, thr = 99, gd._threshold(0.1)
    idx = np.arange(5 * 48, dtype=np.uint64)
    z = (idx * np.uint64(2654435761) + np.uint64(seed)) & np.uint64(0xFFFFFFFF)
    for shift, mul in ((16, 0x85EBCA6B), (13, 0xC2B2AE35)):
        z = ((z ^ (z >> np.uint64(shift))) * np.uint64(mul)) & np.uint64(0xFFFFFFFF)
    want = (z ^ (z >> np.uint64(16))) >= thr
    for cols in (None, 48, 5 * 48):
        got = gd.keep_mask_plain(5 * 48, seed, thr, "cpu", cols)
        np.testing.assert_array_equal(got.numpy(), want)
