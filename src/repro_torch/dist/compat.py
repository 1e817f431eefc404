"""Meshes, the body of a ``shard_map`` and its named-axis collectives, and
the collective helpers the sharded-stream merge rides on, in PyTorch.

The port's counterpart of ``repro.dist.compat``:

  * ``make_mesh`` builds a ``torch.distributed.device_mesh.DeviceMesh`` over
    the ranks of the current ``torch.distributed`` group (joining one first
    if there is none: ``init_process_group``), where the reference builds a
    ``jax.sharding.Mesh`` over devices;
  * ``PartitionSpec`` is the port's spec type (one entry per tensor
    dimension: None, a mesh axis name or a tuple of names), and
    ``placements_of`` turns it into DTensor placements, one per mesh
    dimension: ``Shard(d)`` on every mesh dimension named at tensor
    dimension d, ``Replicate()`` on the others.  A tuple of names shards
    in mesh order, which is JAX's major-to-minor layout;
  * ``shard_map(f, mesh=, in_specs=, out_specs=)`` runs ``f`` on this
    rank's local shards.  Inside ``f`` the named-axis collectives
    (``axis_size``, ``axis_index``, ``psum``, ``pmax``, ``all_gather``,
    ``all_to_all``)
    resolve a mesh axis name to its process group (``mesh.get_group``) and
    run ``dist.all_reduce`` / ``dist.all_gather`` /
    ``dist.all_to_all_single`` there: the
    counterparts of the ``lax`` collectives of the reference's bodies;
  * ``cost_analysis_dict`` reads XLA's compiled cost; it has no
    counterpart here yet and comes with the port's dry-run tooling.

The sharded-stream merge's helpers come last.  The reference merges host
arrays across processes through jax.distributed; here the processes form
a ``torch.distributed`` group (``launch.mesh.init_stream_cluster``, gloo),
which carries host tensors on the card's machine too, so no NCCL group is
needed.  With no group initialized every one of them is the
single-process identity, so the sharded scanner needs no mode switch.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AxisNames = Union[str, Tuple[str, ...], None]


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of this process's torch.distributed group, or
    (0, 1) when no group is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# ---------------------------------------------------------------------------
# Process groups and meshes
# ---------------------------------------------------------------------------

def default_backend(device) -> str:
    """gloo for CPU tensors; NCCL for CUDA ones with gloo beside it for the
    host tensors (barriers, the sharded scan's merges)."""
    return "gloo" if torch.device(device).type == "cpu" else "cpu:gloo,cuda:nccl"


def init_process_group(device=None, backend: Optional[str] = None) -> Tuple[int, int]:
    """Join a ``torch.distributed`` group unless one exists; returns (rank,
    world size).

    Under ``torchrun`` (or its environment: ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) the processes meet at the master's
    address; started alone, the process forms a group of one in memory.
    On the card each rank takes ``cuda:LOCAL_RANK`` when the host has that
    many cards (two ranks may share one card under gloo)."""
    import torch.distributed as dist

    from repro_torch.core.packing import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = backend or default_backend(dev)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return dist.get_rank(), dist.get_world_size()


def make_mesh(shape: Sequence[int], axis_names, *, devices=None, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the ranks
    ``devices`` (default: the group's first prod(shape) ranks), on the
    device type of ``resolve_device(device)`` (the card unless the caller
    asks for the CPU).  Joins a group first if there is none.  Raises
    ValueError when the group has fewer ranks than the shape needs, as the
    reference does with too few devices."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.packing import resolve_device

    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        # the group's size, read before joining one, so a mesh too large
        # raises without starting a group
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", 1)))
        devices = range(world)
    ranks = list(devices)
    if len(ranks) < n:
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(ranks)}")
    init_process_group(dev)
    grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(shape)
    return DeviceMesh(dev.type, grid, mesh_dim_names=tuple(axis_names))


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a mesh, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ---------------------------------------------------------------------------
# Specs and placements
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of names (sharded over their product, in mesh order).  An
    empty spec replicates every dimension.  Compares equal to the
    reference's ``jax.sharding.PartitionSpec`` entry for entry as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names (none for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_of(mesh, spec: PartitionSpec) -> tuple:
    """The DTensor placements of ``spec``: one per mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = []
        for a in entry_axes(entry):
            if a not in names:
                raise ValueError(f"{spec}: no mesh axis {a!r} in {tuple(names)}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {a!r} named twice")
            out[i] = Shard(d)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of dimension {d} are not in mesh order")
    return tuple(out)


def local_slices(shape, mesh, placements) -> tuple:
    """The slices of a tensor of ``shape`` that this rank holds under
    ``placements`` (torch.chunk's split, nested in mesh order, as DTensor
    splits)."""
    from torch.distributed.tensor import Shard

    lo, hi = [0] * len(shape), list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, k = pl.dim, mesh.size(i)
            n = hi[d] - lo[d]
            chunk = -(-n // k)
            start = lo[d] + min(n, mesh.get_local_rank(i) * chunk)
            lo[d], hi[d] = start, min(lo[d] + n, start + chunk)
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def _dtensor_spec(mesh, placements: tuple, shape: tuple, dtype):
    """The DTensor spec of (placements, shape, dtype) on ``mesh``, cached on
    the mesh object itself.  A ``DeviceMesh`` compares equal to another of
    the same ranks, layout and names whatever its process groups, so a
    cache keyed on equality would hand a mesh built after a new group a
    spec holding an older mesh, whose groups may have been destroyed."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

    cache = mesh.__dict__.setdefault("_repro_dtensor_specs", {})
    key = (placements, shape, dtype)
    spec = cache.get(key)
    if spec is None:
        stride = torch.empty(shape, device="meta").stride()
        spec = DTensorSpec(mesh, placements,
                           tensor_meta=TensorMeta(torch.Size(shape), stride, dtype))
        cache[key] = spec
    return spec


def from_local(local: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` whose shard here is ``local`` (no
    communication, no autograd edge).  The tensor spec of each
    (placements, shape, dtype) is built once a mesh:
    ``DTensor.from_local`` builds one a call and costs ~0.15-0.9 ms, which
    a train step pays for every leaf of its state."""
    from torch.distributed.tensor import DTensor

    spec = _dtensor_spec(mesh, tuple(placements), tuple(shape), local.dtype)
    return DTensor(local.detach(), spec, requires_grad=False)


def distribute(t: torch.Tensor, mesh, spec: PartitionSpec):
    """Place ``t``, which every rank holds whole, by ``spec``: each rank
    keeps its own slice (no communication)."""
    placements = placements_of(mesh, spec)
    sl = local_slices(t.shape, mesh, placements)
    whole = all(s.stop - s.start == n for s, n in zip(sl, t.shape))
    local = t if whole else t[sl].clone()
    return from_local(local, mesh, placements, tuple(t.shape))


# ---------------------------------------------------------------------------
# shard_map and the named-axis collectives of its body
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()  # this thread's stack of meshes in use


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the one named-axis collectives resolve names on (in
    this thread)."""
    stack = _ACTIVE.__dict__.setdefault("meshes", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _current(mesh):
    if mesh is not None:
        return mesh
    stack = getattr(_ACTIVE, "meshes", None)
    if not stack:
        raise RuntimeError("a named-axis collective runs inside shard_map (or use_mesh)")
    return stack[-1]


def axis_size(axis_name: AxisNames, *, mesh=None) -> int:
    """The size of a mesh axis (the product over a tuple of axes)."""
    m = _current(mesh)
    return math.prod(m.size(m.mesh_dim_names.index(a)) for a in entry_axes(axis_name))


def axis_index(axis_name: AxisNames, *, mesh=None) -> int:
    """This rank's coordinate along an axis (row-major over a tuple)."""
    m = _current(mesh)
    idx = 0
    for a in entry_axes(axis_name):
        idx = idx * m.size(m.mesh_dim_names.index(a)) + m.get_local_rank(a)
    return idx


def _reduce(x: torch.Tensor, axis_name: AxisNames, op, mesh) -> torch.Tensor:
    import torch.distributed as dist

    m = _current(mesh)
    out = x.detach().clone().reshape(-1)
    for a in entry_axes(axis_name):
        dist.all_reduce(out, op=op, group=m.get_group(a))
    return out.reshape(x.shape)


def psum(x: torch.Tensor, axis_name: AxisNames, *, mesh=None) -> torch.Tensor:
    """Sum over a mesh axis (``lax.psum``): ``dist.all_reduce`` on its group."""
    import torch.distributed as dist

    return _reduce(x, axis_name, dist.ReduceOp.SUM, mesh)


def pmax(x: torch.Tensor, axis_name: AxisNames, *, mesh=None) -> torch.Tensor:
    """Max over a mesh axis (``lax.pmax``)."""
    import torch.distributed as dist

    return _reduce(x, axis_name, dist.ReduceOp.MAX, mesh)


def all_gather(x: torch.Tensor, axis_name: str, *, mesh=None) -> torch.Tensor:
    """``lax.all_gather`` (untiled) over one mesh axis: the ranks' ``x``
    stacked on a new leading axis, in coordinate order."""
    import torch.distributed as dist

    m = _current(mesh)
    parts = [torch.empty_like(x) for _ in range(axis_size(axis_name, mesh=m))]
    dist.all_gather(parts, x.contiguous(), group=m.get_group(axis_name))
    return torch.stack(parts)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int, concat_axis: int, *,
               mesh=None) -> torch.Tensor:
    """``lax.all_to_all`` (untiled) over one mesh axis of k ranks, on
    ``dist.all_to_all_single``: ``x.shape[split_axis]`` is k, piece j goes
    to the rank at coordinate j, and the pieces received stack on a new
    axis at ``concat_axis`` (the split axis gone)."""
    import torch.distributed as dist

    m = _current(mesh)
    k = axis_size(axis_name, mesh=m)
    xs = x.movedim(split_axis, 0).contiguous()
    if xs.shape[0] != k:
        raise ValueError(f"all_to_all splits an axis of {xs.shape[0]} over {k} ranks")
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=m.get_group(axis_name))
    return out.movedim(0, concat_axis)


def _map_prefix(fn, specs, tree):
    """fn(spec, leaf) over ``tree``, ``specs`` a prefix of it (one spec may
    stand for a whole subtree, as in shard_map's in_specs)."""
    if isinstance(specs, PartitionSpec):
        if isinstance(tree, torch.Tensor):
            return fn(specs, tree)
        return _map_prefix(fn, _spread(specs, tree), tree)
    if isinstance(tree, dict):
        return {k: _map_prefix(fn, specs[k], v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_prefix(fn, s, v) for s, v in zip(specs, tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return tree


def _spread(spec, tree):
    if isinstance(tree, dict):
        return {k: spec for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(*[spec] * len(tree)) if hasattr(tree, "_fields") else [spec] * len(tree)
    return spec


def shard_map(f, *, mesh, in_specs, out_specs, check_vma: bool = True):
    """``f`` run on this rank's local shards (``jax.shard_map``).

    An input is a DTensor (redistributed to its spec, then its local shard)
    or a plain tensor that stands for the whole array (each rank takes its
    slice, as ``distribute``).  ``f``'s outputs are this rank's shards of
    DTensors placed by ``out_specs``.  ``check_vma`` is accepted for the
    reference's signature; nothing checks replication here."""
    del check_vma
    from torch.distributed.tensor import DTensor

    def local(spec, x):
        placements = placements_of(mesh, spec)
        if isinstance(x, DTensor):
            return x.redistribute(mesh, placements).to_local()
        return x[local_slices(x.shape, mesh, placements)]

    def place(spec, y):
        placements = placements_of(mesh, spec)
        shape = list(y.shape)
        for i, pl in enumerate(placements):
            if pl.is_shard():
                shape[pl.dim] *= mesh.size(i)
        return from_local(y, mesh, placements, tuple(shape))

    def run(*args):
        locals_ = [_map_prefix(local, s, a) for s, a in zip(in_specs, args)]
        with use_mesh(mesh):
            out = f(*locals_)
        return _map_prefix(place, out_specs, out)

    return run


# ---------------------------------------------------------------------------
# The sharded-stream merge
# ---------------------------------------------------------------------------

def sum_across_devices(parts: Sequence[torch.Tensor]) -> np.ndarray:
    """Merge of per-shard accumulators (same shape and dtype each) into one
    host array.

    Parts sharing one device fold with on-device adds; the per-device sums
    are then copied to the first device and added there, so the host reads
    one array.  This is the count-merge collective of the two-level seam
    rule (DESIGN.md §10)."""
    if not parts:
        raise ValueError("sum_across_devices needs at least one part")
    per_dev: dict = {}
    for p in parts:
        acc = per_dev.get(p.device)
        per_dev[p.device] = p if acc is None else acc + p
    vals = list(per_dev.values())
    total = vals[0]
    for v in vals[1:]:
        total = total + v.to(total.device)
    return total.cpu().numpy()


def process_allsum(x: np.ndarray) -> np.ndarray:
    """Sum an integer host array across the group's processes, in int64 (as
    the reference's gathered sum is); identity for a single process."""
    _, world = rank_and_world()
    if world == 1:
        return np.asarray(x)
    import torch.distributed as dist

    t = torch.from_numpy(np.array(x, dtype=np.int64))
    dist.all_reduce(t)
    return t.numpy()


def process_allgather_ragged(x: np.ndarray) -> List[np.ndarray]:
    """All-gather a ragged 1-D int64 array across processes; returns one
    array per process, in rank order (just [x] single-process).

    gloo carries int64, so global stream positions travel whole: the
    lengths are gathered first, every array is padded to the longest and
    gathered once."""
    x = np.asarray(x, np.int64)
    _, world = rank_and_world()
    if world == 1:
        return [x]
    import torch.distributed as dist

    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(lens, torch.tensor([len(x)], dtype=torch.int64))
    cap = max(max(int(n) for n in lens), 1)
    buf = torch.zeros(cap, dtype=torch.int64)
    buf[: len(x)] = torch.from_numpy(x)
    got = [torch.empty(cap, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(got, buf)
    return [g[: int(n)].numpy() for g, n in zip(got, lens)]
