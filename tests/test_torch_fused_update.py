"""PyTorch port: the trainer's fused AdamW + EMA + working-set copy (``ops/fused_update.py``).

On the CPU, the wrapper's pure-Python part:

- the leaf table: addresses, sizes, chunks, flags, and Base's 363 leaves;
- a strided master's (run, stride) descriptor, walked as the kernel walks it;
- the alignment fallbacks to the scalar path, and what the table refuses;
- the split form's order (AdamW launch, ``after_update``, EMA launch) and its
  counters, with the launch itself stubbed out;
- a CPU ``guarded_update`` takes the plain version and counts no fused launch.

On the card (``card`` marker; ``python -m pytest tests/test_torch_fused_update.py
-m card --noconftest`` there, since this file imports no JAX), the kernel
against the plain version through ``guarded_update`` on Base's leaves: five
steps clipped and unclipped, a skipped step, bf16 and f32 first moments, the
exact-b1 step after a resume, and ZeRO-1 views with the separate EMA launch;
masters, moments, EMA and working parameters bit-equal after every step, and
one launch a step (two in the split form).
"""

import math

import numpy as np
import pytest
import torch

from oron_tts_tpu_torch.ops import fused_update
from oron_tts_tpu_torch.ops.fused_update import (
    ADAM,
    EMA,
    LEAF_FIELDS,
    M_BF16,
    VEC,
    W_BF16,
    leaf_table,
    master_layout,
)
from oron_tts_tpu_torch.parallel import mesh as pmesh
from oron_tts_tpu_torch.train.trainer import TrainState, guarded_update, make_lr_schedule
from oron_tts_tpu_torch.utils import trace

COL = {f: i for i, f in enumerate(LEAF_FIELDS)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "tests/test_torch_fused_update.py -m card --noconftest)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.stop()
    yield
    trace.stop()


def base_leaves(depth: int = 22) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of the Base DiT's parameters, built on the meta device."""
    from oron_tts_tpu_torch.models.dit import DiT

    with torch.device("meta"):
        net = DiT(depth=depth)
    return [(n, tuple(p.shape)) for n, p in net.named_parameters()]


def _walk(base: torch.Tensor, view: torch.Tensor, row: np.ndarray) -> torch.Tensor:
    """The view's elements read as the kernel reads a master: ``(i // run) · stride +
    i % run`` elements after the view's address."""
    flat = base.reshape(-1)
    first = (int(row[COL["p"]]) - base.data_ptr()) // base.element_size()
    i = torch.arange(int(row[COL["n"]]))
    run, stride = int(row[COL["run"]]), int(row[COL["stride"]])
    return flat[first + (i // run) * stride + i % run]


# ── CPU: the leaf table ─────────────────────────────────────────────────────

def test_leaf_table_addresses_sizes_and_chunks():
    sizes = (1, 7, 8, 9, 0, 33)
    p = [torch.zeros(n) for n in sizes]
    g, v, e = ([torch.zeros(n) for n in sizes] for _ in range(3))
    m = [torch.zeros(n, dtype=torch.bfloat16) for n in sizes]
    w = [torch.zeros(n, dtype=torch.float32 if k % 2 else torch.bfloat16)
         for k, n in enumerate(sizes)]
    table, n_chunks = leaf_table(p, g, m, v, e, w, chunk=8)
    assert table.shape == (len(sizes), len(LEAF_FIELDS)) and table.dtype == np.int64
    assert list(table[:, COL["n"]]) == list(sizes)
    assert list(table[:, COL["run"]]) == list(sizes) == list(table[:, COL["stride"]])
    # ceil(n / 8) chunks a leaf, numbered in order; an empty leaf holds none
    assert list(table[:, COL["chunk0"]]) == [0, 1, 2, 3, 5, 5] and n_chunks == 10
    for f, ts in (("p", p), ("g", g), ("m", m), ("v", v), ("e", e), ("w", w)):
        assert list(table[:, COL[f]]) == [t.data_ptr() for t in ts]
    flags = table[:, COL["flags"]]
    assert all(f & M_BF16 for f in flags)
    assert [bool(f & W_BF16) for f in flags] == [k % 2 == 0 for k in range(len(sizes))]


def test_leaf_table_halves_leave_the_other_addresses_out():
    p = [torch.zeros(6, 8)]
    adam, _ = leaf_table(p, [torch.zeros(6, 8)], [torch.zeros(6, 8, dtype=torch.bfloat16)],
                         [torch.zeros(6, 8)], None, None)
    assert adam[0, COL["e"]] == adam[0, COL["w"]] == 0 and adam[0, COL["g"]] != 0
    ema, _ = leaf_table(p, None, None, None, [torch.zeros(6, 8)],
                        [torch.zeros(6, 8, dtype=torch.bfloat16)])
    assert ema[0, COL["g"]] == ema[0, COL["m"]] == ema[0, COL["v"]] == 0
    assert ema[0, COL["flags"]] & W_BF16 and not ema[0, COL["flags"]] & M_BF16


def test_base_leaves_in_one_table():
    leaves = base_leaves()
    assert len(leaves) == 363
    with torch.device("meta"):
        p = [torch.empty(s) for _, s in leaves]
        m = [torch.empty(s, dtype=torch.bfloat16) for _, s in leaves]
        w = [torch.empty(s, dtype=torch.bfloat16) for _, s in leaves]
    table, n_chunks = leaf_table(p, p, m, p, p, w)
    n = table[:, COL["n"]]
    assert int(n.sum()) == 428_146_788
    assert n_chunks == sum(-(-int(k) // fused_update.CHUNK) for k in n)
    assert (table[:, COL["flags"]] == VEC | M_BF16 | W_BF16).all()


@pytest.mark.parametrize("shape,axis", [
    ((8, 6), 1), ((8, 6), 0), ((4, 6, 8), 1), ((4, 6, 8), 2), ((3, 4, 5, 6), 2),
    ((16,), 0), ((6, 1, 8), 2), ((1, 12, 4), 1),
])
def test_strided_master_descriptor_walks_the_view(shape, axis):
    base = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    size = shape[axis] // 2
    view = base.narrow(axis, size, size)  # the second of two data ranks
    block = [torch.zeros(view.shape)]
    table, _ = leaf_table([view], block, [torch.zeros(view.shape)], block, None, None)
    assert torch.equal(_walk(base, view, table[0]), view.reshape(-1))
    run, stride = master_layout(view)
    assert (int(table[0, COL["run"]]), int(table[0, COL["stride"]])) == (run, stride)


def test_master_layout_refuses_other_layouts():
    with pytest.raises(ValueError, match="runs of one stride"):
        master_layout(torch.zeros(6, 8).t())
    with pytest.raises(ValueError, match="overlapping"):
        master_layout(torch.zeros(4, 1).expand(4, 3))
    assert master_layout(torch.zeros(8, 6)[::2]) == (6, 12)


def test_alignment_fallbacks():
    storage = torch.zeros(4096)
    bstorage = torch.zeros(4096, dtype=torch.bfloat16)

    def flags(p_off=0, m_off=0, w_off=0, master=None) -> int:
        p = storage[p_off:p_off + 64].view(8, 8) if master is None else master
        shape = p.shape
        n = p.numel()
        m = bstorage[1024 + m_off:1024 + m_off + n].view(shape)
        w = bstorage[2048 + w_off:2048 + w_off + n].view(shape)
        z = [torch.zeros(shape)]
        table, _ = leaf_table([p], z, [m], z, z, [w])
        return int(table[0, COL["flags"]])

    assert flags() & VEC
    assert not flags(p_off=1) & VEC          # an f32 address off 16 bytes
    assert flags(m_off=4) & VEC              # a bf16 address on 8 bytes
    assert not flags(m_off=2) & VEC          # ... and off them
    assert not flags(w_off=6) & VEC
    wide = storage[:96].view(8, 12)
    assert flags(master=wide.narrow(1, 4, 4)) & VEC       # run 4, stride 12
    assert not flags(master=wide.narrow(1, 3, 3)) & VEC   # run 3
    assert not flags(master=storage[:80].view(8, 10).narrow(1, 0, 8)) & VEC  # stride 10


def test_leaf_table_refuses_what_the_kernel_cannot_take():
    p = [torch.zeros(6, 8)]
    with pytest.raises(ValueError, match="shape"):
        leaf_table(p, [torch.zeros(8, 6)], [torch.zeros(6, 8)], [torch.zeros(6, 8)], None, None)
    with pytest.raises(ValueError, match="contiguous"):
        leaf_table(p, [torch.zeros(6, 8)], [torch.zeros(8, 6).t()], [torch.zeros(6, 8)],
                   None, None)
    with pytest.raises(ValueError, match="masters"):
        leaf_table(p, [torch.zeros(6, 8)] * 2, None, None, None, None)


# ── CPU: the launches, stubbed ──────────────────────────────────────────────

def _tiny_state():
    gen = torch.Generator().manual_seed(0)
    shapes = [(8, 12), (12,), (4, 8, 4)]
    masters = [torch.randn(s, generator=gen) for s in shapes]
    state = TrainState([f"leaf{i}" for i in range(len(shapes))], masters)
    work = [p.to(torch.bfloat16) for p in masters]
    grads = [torch.randn(s, generator=gen) for s in shapes]
    return state, work, grads


def _step(clip_norm=None) -> fused_update.Step:
    return fused_update.Step(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                             bc1=0.1, bc2=0.001, decay=0.5, one_minus_decay=0.5,
                             max_grad_norm=1.0, clip_norm=clip_norm)


def test_split_form_launches_around_after_update(monkeypatch):
    events = []
    monkeypatch.setattr(fused_update, "_launch",
                        lambda table, n_chunks, step, flags, device: events.append(
                            (flags, table[:, COL["g"]].any(), table[:, COL["e"]].any())))
    state, work, grads = _tiny_state()
    cpu = torch.device("cpu")
    fused_update._fused(state.params, grads, state.mu, state.nu, state.ema, work, _step(),
                        None, None, cpu)
    assert events == [(ADAM | EMA, True, True)]
    events.clear()
    views = [p.narrow(0, 0, p.shape[0] // 2) for p in state.params]
    blocks = [g.narrow(0, 0, g.shape[0] // 2).contiguous() for g in grads]
    mu = [m.narrow(0, 0, m.shape[0] // 2).contiguous() for m in state.mu]
    nu = [v.narrow(0, 0, v.shape[0] // 2).contiguous() for v in state.nu]
    fused_update._fused(state.params, blocks, mu, nu, state.ema, work, _step(1.5), views,
                        lambda: events.append("gathered"), cpu)
    assert events == [(ADAM, True, False), "gathered", (EMA, False, True)]
    with pytest.raises(ValueError, match="pass work"):
        fused_update._fused(state.params, grads, state.mu, state.nu, state.ema, None, _step(),
                            None, None, cpu)
    with pytest.raises(ValueError, match="float32"):
        fused_update._fused(state.params, [g.double() for g in grads], state.mu, state.nu,
                            state.ema, work, _step(), None, None, cpu)


def test_cpu_guarded_update_takes_the_plain_version():
    state, work, grads = _tiny_state()
    launches = fused_update.adamw_ema.launches
    before = [p.clone() for p in state.params]
    trace.start()
    norm, ok = guarded_update(state, grads, make_lr_schedule(1e-2, 2, 10), 0.999, work=work)
    recorded = trace.stop()
    assert ok and fused_update.adamw_ema.launches == launches
    assert not any(k.startswith("update.fused_") for k in recorded["counters"])
    # the working set received the new masters
    assert all(not torch.equal(p, b) for p, b in zip(state.params, before))
    assert all(torch.equal(w, p.to(torch.bfloat16)) for w, p in zip(work, state.params))


# ── the card: kernel against plain ──────────────────────────────────────────

def _card_state(leaves, dev, mu_dtype, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = [s for _, s in leaves]
    masters = [0.05 * torch.randn(s, generator=gen, device=dev) for s in shapes]
    state = TrainState([n for n, _ in leaves], masters, mu_dtype)
    for m, v, e in zip(state.mu, state.nu, state.ema):
        m.copy_(1e-3 * torch.randn(m.shape, generator=gen, device=dev))
        v.copy_(1e-6 * torch.rand(v.shape, generator=gen, device=dev))
        e.add_(1e-3 * torch.randn(e.shape, generator=gen, device=dev))
    state.count = state.step = state.ema_updates = 40
    return state


def _copy_state(state):
    twin = TrainState(state.names, [p.clone() for p in state.params], state.mu[0].dtype)
    for dst, src in ((twin.mu, state.mu), (twin.nu, state.nu), (twin.ema, state.ema)):
        for d, s in zip(dst, src):
            d.copy_(s)
    twin.count, twin.step, twin.ema_updates = state.count, state.step, state.ema_updates
    twin.resumed = state.resumed
    return twin


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return int((a.view(ints).int() - b.view(ints).int()).abs().max()) if a.numel() else 0


def _assert_bit_equal(got, want, what: str, step: int) -> None:
    bad = [(n, _ulps(a, b)) for n, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
    assert not bad, (f"step {step}: {what} differs in {len(bad)} leaves (leaf, max ulps): "
                     f"{bad[:8]}")


@pytest.mark.card
@pytest.mark.parametrize("mu_dtype,depth,zero,resumed", [
    (torch.bfloat16, 22, False, False),   # Base's 363 leaves
    (torch.float32, 2, False, False),
    (torch.bfloat16, 2, False, True),     # the exact-b1 step after a resume
    (torch.bfloat16, 4, True, False),     # ZeRO-1 views, the split form
])
def test_kernel_is_bit_equal_to_the_plain_update(card, monkeypatch, mu_dtype, depth, zero,
                                                 resumed):
    leaves = base_leaves(depth)
    sides = {"kernel": _card_state(leaves, card, mu_dtype, seed=depth)}
    sides["kernel"].resumed = resumed
    sides["plain"] = _copy_state(sides["kernel"])
    work = {k: [p.to(torch.bfloat16) for p in st.params] for k, st in sides.items()}
    schedule = make_lr_schedule(1e-4, 20, 1000)
    axes = [None] * len(leaves)
    if zero:  # this rank is the second of two data ranks
        specs = pmesh.opt_specs(dict(leaves), 2)
        axes = [pmesh.axis_of(specs[n], "data") for n, _ in leaves]
        assert sum(a not in (None, 0) for a in axes) > 0  # some blocks are strided

    def block(t, a):
        return t if a is None else t.narrow(a, t.shape[a] // 2, t.shape[a] // 2)

    for st in sides.values():
        st.mu = [block(m, a).contiguous() for m, a in zip(st.mu, axes)]
        st.nu = [block(v, a).contiguous() for v, a in zip(st.nu, axes)]

    def update(side: str, grads):
        st = sides[side]
        views = [block(p, a) for p, a in zip(st.params, axes)] if zero else None

        def gather():  # stands in for the all-gather: the other rank's blocks change
            for p, a in zip(st.params, axes):
                if a is not None:
                    p.narrow(a, 0, p.shape[a] // 2).mul_(1.0 + 1e-3)

        args = dict(params=views, after_update=gather if zero else None, work=work[side])
        if side == "kernel":
            return guarded_update(st, [g.clone() for g in grads], schedule, 0.9999, **args)
        with monkeypatch.context() as mp:
            mp.setattr(fused_update, "adamw_ema", fused_update.adamw_ema_plain)
            return guarded_update(st, [g.clone() for g in grads], schedule, 0.9999, **args)

    gen = torch.Generator(device=card).manual_seed(depth + 100)
    for k, scale in enumerate((3.0, 0.2, 5.0, 0.05, 1.5)):  # clipped and unclipped
        grads = [torch.randn(block(torch.empty(s, device="meta"), a).shape, generator=gen,
                             device=card) for (_, s), a in zip(leaves, axes)]
        norm = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))))
        grads = [g * (scale / norm) for g in grads]
        launches = fused_update.adamw_ema.launches
        n_k, ok_k = update("kernel", grads)
        torch.cuda.synchronize()
        assert fused_update.adamw_ema.launches - launches == (2 if zero else 1)
        n_p, ok_p = update("plain", grads)
        assert ok_k and ok_p and n_k == n_p
        assert (n_k >= 1.0) == (scale >= 1.0)
        kern, plain = sides["kernel"], sides["plain"]
        for what in ("params", "mu", "nu", "ema"):
            _assert_bit_equal(getattr(kern, what), getattr(plain, what), what, k)
        _assert_bit_equal(work["kernel"], work["plain"], "work", k)
        assert kern.count == plain.count and not kern.resumed

    # a skipped step: a non-finite gradient launches nothing and changes nothing
    frozen = [t.clone() for t in sides["kernel"].params + sides["kernel"].ema + work["kernel"]]
    grads[0][0] = float("nan")
    launches = fused_update.adamw_ema.launches
    norm, ok = update("kernel", grads)
    assert not ok and not math.isfinite(norm)
    assert fused_update.adamw_ema.launches == launches
    after = sides["kernel"].params + sides["kernel"].ema + work["kernel"]
    assert all(torch.equal(a, b) for a, b in zip(after, frozen))
