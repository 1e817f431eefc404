"""Checkpointing in the reference's on-disk format: atomic, async, keep-K.

The port's copy of ``repro.train.checkpoint``.  Layout:
``<dir>/step_<N:08d>/`` with one ``.npy`` per leaf and ``manifest.json``
(``step``; each leaf's ``name``, ``file``, ``shape`` and ``dtype``).
Writes go to ``.tmp_step_<N>_<pid>`` first and are ``os.rename``d into
place, so a crash mid-save never corrupts the latest checkpoint.

Leaf names are the reference's pytree paths joined by ``__``: dict keys in
sorted order, tuple positions, NamedTuple fields, so ``(params,
opt_state)`` gives ``0__embed``, ``0__layers__wq``, ``1__step``,
``1__m__layers__wq``.  The port's per-layer list under the key
``layers`` is one stacked dict on disk, every leaf stacked on axis 0 as
the reference's scanned layers are: ``save`` stacks and ``restore``
splits.  Every other list is a list in the reference too, its index a
path element: ``tower__0__w``, ``blocks__0__wq``, ``tables__7``
(``models.common.is_stacked_layers``).  bfloat16 leaves are written
as their 16 raw bits under the header ml_dtypes' bfloat16 gives
(``'<V2'``), with manifest dtype
``"bfloat16"``, and read back the same way: the two packages restore each
other's checkpoints, and neither this module nor its callers need
ml_dtypes.

``restore`` puts the tensors on ``device`` (default: the card), or, given
``shardings`` (a matching tree of ``dist.sharding.NamedSharding``s, as the
reference's tree of shardings), returns DTensors on their meshes whose
local shards are the saved arrays' slices: each rank maps the ``.npy``
files (``mmap_mode="r"``) and reads only its own slices, so a checkpoint
restores onto any mesh whatever the layout it was written from (elastic
restore).  ``save`` of a tree holding DTensors gathers each whole tensor
(a collective: every rank of the mesh calls ``save``); rank 0 writes, and
the other ranks wait for it at a barrier (a sync save) or return at once
(an async save: the caller waits for rank 0's writer, then all meet at a
barrier).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.packing import resolve_device
from repro_torch.models.common import is_stacked_layers

_SEP = "__"
_BF16 = "bfloat16"


def _flatten(tree, path=()):
    """(path, leaf) in the reference's flatten order; a stacked layer list
    yields each of its leaves as the list of per-layer tensors."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), path + (f,))
    elif is_stacked_layers(path, tree):
        per_layer = [dict(_flatten(x)) for x in tree]
        for sub in per_layer[0]:
            yield path + sub, [layer[sub] for layer in per_layer]
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _flatten(x, path + (str(i),))
    else:
        raise TypeError(f"checkpoint leaf {_SEP.join(path)!r} is a {type(tree).__name__}")


def _name(path) -> str:
    return _SEP.join(path) or "leaf"


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (gathered); any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _to_host(leaf) -> np.ndarray:
    """A leaf (or a stacked layer list) as a host array; bfloat16 as its
    raw bits (uint16)."""
    if isinstance(leaf, list):
        # stacked where the layers live: one device-to-host copy a leaf
        t = torch.stack([x.detach() for x in leaf]).cpu()
    else:  # a copy even on the CPU: the caller may change the tensor later
        t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _write_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _is_sharded(tree) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(x, DTensor) for _, leaf in _flatten(tree)
               for x in (leaf if isinstance(leaf, list) else [leaf]))


def save(tree, directory, step: int, *, keep: int = 3, async_: bool = False):
    """Save a tree of tensors; returns the writer thread when ``async_``
    (None on the ranks that do not write)."""
    import torch.distributed as dist

    directory = Path(directory)
    sharded = _is_sharded(tree)
    writer = not sharded or dist.get_rank() == 0
    # copy to the host BEFORE handing to the writer thread: the caller may
    # go on and replace the tensors
    host_items = []
    for path, leaf in _flatten(tree):
        dtype = (leaf[0] if isinstance(leaf, list) else leaf).dtype
        whole = [_whole(x) for x in leaf] if isinstance(leaf, list) else _whole(leaf)
        if writer:
            arr = _to_host(whole)
            host_items.append((_name(path), arr,
                               _BF16 if dtype == torch.bfloat16 else str(arr.dtype)))
    if not writer:
        if not async_:
            dist.barrier()
        return None
    directory.mkdir(parents=True, exist_ok=True)

    def _write():
        tmp = directory / f".tmp_step_{step}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for name, arr, dtype in host_items:
            fname = f"{name}.npy"
            _write_npy(tmp / fname, arr, dtype)
            manifest["leaves"].append(
                {"name": name, "file": fname, "shape": list(arr.shape), "dtype": dtype}
            )
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = directory / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        _gc(directory, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if sharded:
        dist.barrier()
    return None


def _gc(directory: Path, keep: int):
    steps = sorted(directory.glob("step_*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(directory.glob("step_*"))
    if not steps:
        return None
    return int(re.search(r"step_(\d+)", steps[-1].name).group(1))


def _as_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == _BF16:
        # '<V2' (ml_dtypes' header) or uint16: the 16 raw bits either way
        bits = torch.from_numpy(arr.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    if str(arr.dtype) != dtype:
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(arr).to(device)


def _load(d: Path, meta: dict, device) -> torch.Tensor:
    return _as_tensor(np.load(d / meta["file"]), meta["dtype"], device)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _restore_sharded(d: Path, by_name: dict, tree_like, shardings):
    """DTensors placed by ``shardings``, each rank reading its slices."""
    from repro_torch.dist.compat import from_local, local_slices

    maps = {}

    def load(path, shape, sh, layer):
        name = _name(path)
        meta = by_name[name]
        if name not in maps:
            maps[name] = np.load(d / meta["file"], mmap_mode="r")
        arr = maps[name] if layer is None else maps[name][layer]
        if tuple(arr.shape) != tuple(shape):
            full = tuple(maps[name].shape)
            raise ValueError(f"shape mismatch for {name}: {full} vs {tuple(shape)}")
        placements = sh.placements
        # a copy of this rank's slices only, out of the mapped file
        own = np.array(arr[local_slices(shape, sh.mesh, placements)])
        local = _as_tensor(own, meta["dtype"], _mesh_device(sh.mesh))
        return from_local(local, sh.mesh, placements, tuple(shape))

    return _rebuild_sharded(tree_like, shardings, (), None, load)


def _rebuild_sharded(like, sh, path, layer, load):
    if isinstance(like, torch.Tensor):
        return load(path, like.shape, sh, layer)
    if isinstance(like, Mapping):
        return {k: _rebuild_sharded(v, sh[k], path + (str(k),), layer, load)
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild_sharded(getattr(like, f), getattr(sh, f), path + (f,), layer,
                                             load) for f in like._fields))
    if is_stacked_layers(path, like):
        return [_rebuild_sharded(x, s, path, i, load) for i, (x, s) in enumerate(zip(like, sh))]
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild_sharded(x, s, path + (str(i),), layer, load)
                          for i, (x, s) in enumerate(zip(like, sh)))
    raise TypeError(f"checkpoint leaf {_name(path)!r} is a {type(like).__name__}")


def restore(tree_like, directory, step: Optional[int] = None, *, device=None, shardings=None):
    """Restore into the structure of ``tree_like`` (a tree of tensors; meta
    tensors will do, only shapes are read) on ``device`` (default: the
    card), or as DTensors placed by ``shardings`` (a matching tree of
    ``NamedSharding``s; ``device`` is then the meshes').  Returns (tree,
    step)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_name = {m["name"]: m for m in manifest["leaves"]}
    if shardings is not None:
        return _restore_sharded(d, by_name, tree_like, shardings), manifest["step"]
    dev = resolve_device(device)

    def load(path, shape):
        name = _name(path)
        t = _load(d, by_name[name], dev)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {name}: {tuple(t.shape)} vs {tuple(shape)}")
        return t

    return _rebuild(tree_like, (), load), manifest["step"]


def _rebuild(like, path, load):
    if isinstance(like, torch.Tensor):
        return load(path, like.shape)
    if isinstance(like, Mapping):
        return {k: _rebuild(v, path + (str(k),), load) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), path + (f,), load) for f in like._fields))
    if is_stacked_layers(path, like):
        n = len(like)
        stacked = _rebuild(like[0], path, lambda p, shape: load(p, (n, *shape)))
        return [_index(stacked, i) for i in range(n)]
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, path + (str(i),), load) for i, x in enumerate(like))
    raise TypeError(f"checkpoint leaf {_name(path)!r} is a {type(like).__name__}")


def _index(tree, i: int):
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}
