"""The ``("data", "model")`` mesh on ``torch.distributed``: DP, Megatron TP and ZeRO-1.

Counterpart of the JAX package's ``parallel/mesh.py``. There, one process
drives every chip and XLA inserts the collectives; here each rank is one
process driving one card, and every collective is an explicit call that all
the ranks of its group issue in the same order. Those calls live in this
file alone (:func:`all_reduce_sum`, :func:`all_gather_rows`,
:func:`broadcast_tree`, :func:`reduce_scatter_flat`), so the order of a
step's collectives can be read in one place.

Ranks form a ``DP × TP`` grid in row-major order, as the JAX package
reshapes its devices: rank ``r`` sits at data coordinate ``r // TP`` and
model coordinate ``r % TP``. The model peers of a rank (same data
coordinate) share its rows and hold the other shards of the attention and
FFN projections; its data peers (same model coordinate) hold the same
shards and other rows.

The rule table (:data:`PARAM_RULES`) is the JAX package's on the port's
dotted names. ``nn.Linear`` keeps its weight as ``[out, in]`` where flax
keeps its kernel as ``[in, out]``, so the sharded axis flips: a
column-parallel weight (``to_q``/``to_k``/``to_v``, ``ff.in_proj``) splits
its axis 0, a row-parallel one (``to_out``, ``ff.out_proj``) its axis 1. The
port's blocks are unrolled (``block{i}``), so the JAX ``scan_blocks`` shift
has no counterpart.

Left out, with the reason: ``replicated`` and ``param_shardings`` /
``opt_shardings`` (a torch rank holds whole tensors unless it slices them,
so "replicated" is the default and needs no object; :func:`shard_tensor`
and :func:`gather_tensor` take the specs directly); ``shard_batch`` and
``batch_sharding`` (a rank keeps its own rows, so there is no global array
to assemble: :func:`batch_rows` says which rows of a global batch are this
rank's); ``shard_dataset_indices`` (``GlobalBatchSchedule`` splits every
run's rows over the data ranks, so no path needs a per-rank index split).
"""

from __future__ import annotations

import os
import re
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

Spec = tuple  # one entry per tensor axis: "model", "data" or None

# (name regex, spec in the torch layout) — the first match wins
PARAM_RULES: list[tuple[str, Spec]] = [
    # attention QKV: the heads (output features, axis 0 of [out, in]) over "model"
    (r"attn\.to_[qkv]\.(weight|weight_q)$", ("model", None)),
    (r"attn\.to_[qkv]\.(bias|scale)$", ("model",)),
    # attention output projection: the contracting axis → a sum over "model"
    (r"attn\.to_out\.(weight|weight_q)$", (None, "model")),
    # FFN: column-parallel in, row-parallel out (the Megatron layout)
    (r"ff\.in_proj\.(weight|weight_q)$", ("model", None)),
    (r"ff\.in_proj\.(bias|scale)$", ("model",)),
    (r"ff\.out_proj\.(weight|weight_q)$", (None, "model")),
]
# int8 serving (``QDense``): ``weight_q`` mirrors the weight, and the
# per-output-channel ``scale`` follows the output axis — sharded for the
# column-parallel layers, replicated for the row-parallel ones (their output
# axis is whole), as in the JAX rules.

INIT_TIMEOUT_S = 600


def torchrun_command(n: int, spec: str) -> str:
    return (f"python -m torch.distributed.run --nproc-per-node {n} "
            f"-m oron_tts_tpu_torch.cli.<train|infer|serve> ... --mesh {spec}")


def mesh_from_spec(spec: str, device: str | torch.device | None = None) -> "Mesh":
    """Parse the CLI ``--mesh`` string ``DPxTP`` (e.g. ``2x4``); bare ``N`` is ``Nx1``.

    The one place the mesh syntax lives: ``cli/{train,infer,serve}.py`` all
    parse through here.
    """
    dp, _, tp = spec.partition("x")
    try:
        n_data, n_model = int(dp), int(tp or 1)
    except ValueError:
        raise ValueError(f"--mesh must be DPxTP (e.g. 2x4), got {spec!r}") from None
    return make_mesh(n_data, n_model, device=device)


def _env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_from_env(device: torch.device, timeout_s: float = INIT_TIMEOUT_S) -> None:
    """The default process group from the ``torchrun`` environment.

    NCCL on the card, gloo on the CPU. ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT`` come from ``torchrun``; without them a
    world of one starts on an in-process store.
    """
    backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = timedelta(seconds=timeout_s)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, timeout=timeout,
                                **({"device_id": device} if device.type == "cuda" else {}))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)


def local_device(device: str | torch.device | None) -> torch.device:
    """``cuda:LOCAL_RANK`` unless the caller asks for the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


class Mesh:
    """This rank's place in a ``DP × TP`` grid and its two groups of peers.

    ``shape`` is ``{"data": DP, "model": TP}``; ``data_rank`` and
    ``model_rank`` are the coordinates; ``data_group`` holds the ranks of
    this model coordinate (the gradient all-reduce runs there) and
    ``model_group`` those of this data coordinate (the TP sums run there).
    Groups of one rank are ``None`` and their collectives are not issued.
    """

    def __init__(self, n_data: int, n_model: int, device: torch.device) -> None:
        self.shape = {"data": n_data, "model": n_model}
        self.n_data, self.n_model = n_data, n_model
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.data_rank, self.model_rank = divmod(self.rank, n_model)
        self.device = device
        # every rank creates every group, in the same order (new_group is a
        # collective over the default group)
        self.data_group = self.model_group = None
        for m in range(n_model):
            ranks = [d * n_model + m for d in range(n_data)]
            group = dist.new_group(ranks) if n_data > 1 else None
            if m == self.model_rank:
                self.data_group = group
        for d in range(n_data):
            ranks = [d * n_model + m for m in range(n_model)]
            group = dist.new_group(ranks) if n_model > 1 else None
            if d == self.data_rank:
                self.model_group = group
        self.world_group = dist.group.WORLD

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, model={self.n_model}, rank={self.rank}, "
                f"device={self.device})")


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """The mesh over the default process group (initialised here if it is not yet).

    Raises, naming the ``torchrun`` command, when ``DP·TP`` is not the
    world's size: a mesh never falls back to fewer processes.
    """
    dev = local_device(device)
    world = dist.get_world_size() if dist.is_initialized() else _env_world()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(
            f"mesh {n_data}x{n_model} does not cover {world} process"
            f"{'es' if world != 1 else ''}: run one process per rank, "
            f"{torchrun_command(n_data * n_model, f'{n_data}x{n_model}')}")
    if not dist.is_initialized():
        init_from_env(dev)
    return Mesh(n_data, n_model, dev)


# ── the rule table ───────────────────────────────────────────────────────


def spec_for_name(name: str) -> Spec:
    for pattern, spec in PARAM_RULES:
        if re.search(pattern, name):
            return spec
    return ()


def param_specs(names: Any) -> dict[str, Spec]:
    """Spec of every name (a DiT ``named_parameters`` or state-dict key)."""
    return {n: spec_for_name(n) for n in names}


def _flax_axis_order(name: str, ndim: int) -> list[int]:
    """Axes in the flax layout's order: a dense ``[out, in]`` weight is ``[in, out]`` there."""
    dense = ndim == 2 and re.search(r"\.(weight|weight_q)$", name) and not name.endswith(
        "embed.weight")
    return [1, 0] if dense else list(range(ndim))


def opt_specs(shapes: dict[str, tuple[int, ...]], n_data: int) -> dict[str, Spec]:
    """ZeRO-1: each moment's param spec plus ``"data"`` on the first free axis
    that ``n_data`` divides (scalars and axes it divides nowhere stay replicated).

    "First" in the flax layout's order, so a moment splits along the axis
    the JAX package splits. ``shapes`` are the moments' shapes on this rank;
    an axis sharded over ``model`` is not free, and a free axis is whole, so
    local and global sizes agree where the rule looks.
    """
    out = {}
    for name, shape in shapes.items():
        spec = spec_for_name(name)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if n_data > 1 and shape:
            for i in _flax_axis_order(name, len(shape)):
                if parts[i] is None and shape[i] % n_data == 0 and shape[i] >= n_data:
                    parts[i] = "data"
                    break
        out[name] = tuple(parts) if "data" in parts else spec
    return out


def axis_of(spec: Spec, axis_name: str) -> int | None:
    return spec.index(axis_name) if axis_name in spec else None


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh, axis_name: str = "model") -> torch.Tensor:
    """This rank's slice of a whole tensor under ``spec`` (a copy; whole if unsharded)."""
    a = axis_of(spec, axis_name)
    if a is None:
        return t
    n = mesh.n_model if axis_name == "model" else mesh.n_data
    r = mesh.model_rank if axis_name == "model" else mesh.data_rank
    if t.shape[a] % n:
        raise ValueError(f"axis {a} of size {t.shape[a]} does not split over {n} ranks")
    size = t.shape[a] // n
    return t.narrow(a, r * size, size).contiguous()


def gather_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh, axis_name: str = "model") -> torch.Tensor:
    """The whole tensor from every peer's slice (a collective over that axis's group)."""
    a = axis_of(spec, axis_name)
    group = mesh.model_group if axis_name == "model" else mesh.data_group
    if a is None or group is None:
        return t
    return all_gather_rows(t.movedim(a, 0).contiguous(), group).movedim(0, a).contiguous()


def batch_rows(mesh: Mesh | None, global_rows: int) -> slice:
    """The rows of a global batch this rank holds: its data coordinate's block."""
    if mesh is None or mesh.n_data == 1:
        return slice(0, global_rows)
    if global_rows % mesh.n_data:
        raise ValueError(f"{global_rows} rows do not split over {mesh.n_data} data ranks")
    per = global_rows // mesh.n_data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def host_shard_wraparound(indices: list[int], num_hosts: int, host_id: int) -> list[int]:
    """Per-host index shard padded by wrap-around to EQUAL counts.

    Uneven shards would give ranks different batch counts and deadlock the
    step's collectives, so the tail is padded by repeating indices from the
    front (DistributedSampler's drop_last=False). Every index appears on
    exactly one host, the wrap-around duplicates aside.
    """
    if num_hosts <= 1:
        return list(indices)
    padded = list(indices)
    if len(padded) % num_hosts:
        padded = padded + padded[: num_hosts - len(padded) % num_hosts]
    return padded[host_id::num_hosts]


# ── the collectives ──────────────────────────────────────────────────────


def all_reduce_sum(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (``None``: a group of one, nothing issued)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group: Any) -> torch.Tensor:
    """Concatenate every peer's ``t`` along axis 0, in group-rank order."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


def reduce_scatter_flat(flat: torch.Tensor, group: Any) -> torch.Tensor:
    """Sum a flat ``[n · k]`` buffer over ``group`` and keep this rank's ``k``."""
    if group is None:
        return flat
    n = dist.get_world_size(group)
    if flat.numel() % n:
        raise ValueError(f"a buffer of {flat.numel()} does not split over {n} ranks")
    out = torch.empty(flat.numel() // n, dtype=flat.dtype, device=flat.device)
    dist.reduce_scatter(out, list(flat.contiguous().chunk(n)), op=dist.ReduceOp.SUM, group=group)
    return out


def broadcast_tree(tree: Any, src: int = 0, group: Any = None,
                   device: torch.device | str = "cpu") -> Any:
    """Rank ``src``'s tree on every rank.

    A tree is a dict of path → numpy array (``checkpoint.flatten_tree``'s
    form), or any small picklable value. Arrays travel one by one as tensors
    on ``device``, matched by path: the structure (paths, shapes, dtypes) is
    sent first, so what other ranks pass in is ignored.
    """
    if isinstance(tree, dict) and tree and all(isinstance(v, np.ndarray) for v in tree.values()):
        layout = [{k: (v.shape, v.dtype.str) for k, v in tree.items()}]
    else:
        layout = [None]
    is_src = dist.get_rank() == src
    box = [tree if is_src else None, layout[0] if is_src else None]
    dist.broadcast_object_list(box, src=src, group=group, device=torch.device(device))
    value, layout = box
    if layout is None:
        return value
    out = {}
    for key, (shape, dtype_str) in layout.items():
        dtype = np.dtype(dtype_str)
        if is_src:
            arr = np.ascontiguousarray(tree[key])
        else:
            arr = np.empty(shape, dtype)
        if dtype.kind == "V" or dtype == np.dtype("bool") or arr.size == 0:
            raw = torch.from_numpy(arr.view(np.uint8).reshape(-1).copy()).to(device)
            dist.broadcast(raw, src=src, group=group)
            out[key] = raw.cpu().numpy().view(dtype).reshape(shape)
        else:
            t = torch.from_numpy(arr.copy()).to(device)
            dist.broadcast(t, src=src, group=group)
            out[key] = t.cpu().numpy().reshape(shape)
    return out
