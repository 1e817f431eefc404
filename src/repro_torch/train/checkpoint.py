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

``restore`` puts the tensors on ``device`` (default: the card); the
reference's ``shardings`` (a mesh placement) waits for the multi-device
layer.
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


def save(tree, directory, step: int, *, keep: int = 3, async_: bool = False):
    """Save a tree of tensors; returns the writer thread when ``async_``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    # copy to the host BEFORE handing to the writer thread: the caller may
    # go on and replace the tensors
    host_items = []
    for path, leaf in _flatten(tree):
        dtype = (leaf[0] if isinstance(leaf, list) else leaf).dtype
        arr = _to_host(leaf)
        host_items.append((_name(path), arr, _BF16 if dtype == torch.bfloat16 else str(arr.dtype)))

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


def _load(d: Path, meta: dict, device) -> torch.Tensor:
    arr = np.load(d / meta["file"])
    if meta["dtype"] == _BF16:
        # '<V2' (ml_dtypes' header) or uint16: the 16 raw bits either way
        bits = torch.from_numpy(arr.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    if str(arr.dtype) != meta["dtype"]:
        arr = arr.view(np.dtype(meta["dtype"]))
    return torch.from_numpy(arr).to(device)


def restore(tree_like, directory, step: Optional[int] = None, *, device=None):
    """Restore into the structure of ``tree_like`` (a tree of tensors; meta
    tensors will do, only shapes are read) on ``device`` (default: the
    card).  Returns (tree, step)."""
    dev = resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_name = {m["name"]: m for m in manifest["leaves"]}

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
