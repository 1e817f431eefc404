"""Distributed packed string matching: the paper's scan over a list of
devices, in PyTorch.

The PyTorch twin of ``repro.core.distributed``.  The text is cut into one
equal shard per listed device (a device may be listed several times, so one
card can hold all the shards; a grid of devices is read in row-major
order); each shard runs the EPSM scan on its device; the m - 1 bytes of
halo an occurrence crossing the shard's end needs are the first bytes of the
text after it, which may span several next shards.  On one device the
shard and its halo are one slice of the text; on another they are copied
there with ``.to``.  Counts are summed on the first device.

The reference takes each shard's halo from the NEXT shard only
(``_next_rank_halo``), so it misses an occurrence that spans three shards,
once m - 1 exceeds a shard's length (ROADMAP §3, reference fault 4); this
module returns the whole-text answer for every shard length.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.core import epsm
from repro_torch.core.packing import as_u8, as_u8_np, resolve_device


def _flat_devices(devices) -> List[torch.device]:
    """The devices in row-major order; None means every local card (and
    raises without one)."""
    if devices is None:
        resolve_device(None)
        return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    out: List[torch.device] = []

    def walk(d):
        if isinstance(d, (list, tuple)):
            for x in d:
                walk(x)
        else:
            out.append(torch.device(d))

    walk(devices)
    if not out:
        raise ValueError("a distributed scan needs at least one device")
    return out


def _shard_masks(devs: List[torch.device], text, pattern, algo: str) -> List[torch.Tensor]:
    """Each shard's match-start mask on its device: the EPSM scan of the
    shard plus its halo, cut to the shard's length."""
    # a tensor stays where it is; host bytes are staged on the host once
    t = as_u8(text, None if isinstance(text, torch.Tensor) else "cpu").reshape(-1)
    p = as_u8_np(pattern).reshape(-1)
    m, n, k = len(p), t.shape[0], len(devs)
    if m == 0:
        raise ValueError("empty pattern")
    if n % k:
        raise ValueError(f"a text of {n} bytes does not split into {k} equal shards")
    ln = n // k
    pats = {}
    masks = []
    for i, dev in enumerate(devs):
        lo = i * ln
        ext = t[lo : min(n, lo + ln + m - 1)].to(dev)
        if dev not in pats:
            pats[dev] = as_u8(p, dev)
        if ln == 0:
            masks.append(torch.zeros(0, dtype=torch.bool, device=dev))
            continue
        # ext ends at the text's end for the last shards, so no start there
        # runs past it: the reference's tail cut is implicit
        masks.append(epsm.find(ext, pats[dev], algo=algo, stream=False)[:ln])
    return masks


def make_distributed_find(devices=None, *, algo: str = "auto"):
    """A (text, pattern) -> bool mask function over one shard a device.

    The text (a tensor on any device, or host bytes) must split into
    ``len(devices)`` equal shards, as the reference's ``shard_map`` requires;
    the mask is assembled on the first device."""
    devs = _flat_devices(devices)

    def find(text, pattern) -> torch.Tensor:
        masks = _shard_masks(devs, text, pattern, algo)
        return torch.cat([mk.to(devs[0]) for mk in masks])

    return find


def make_distributed_count(devices=None, *, algo: str = "auto"):
    """A (text, pattern) -> 0-d int32 count function over one shard a
    device: each shard's count summed on its device, then on the first."""
    devs = _flat_devices(devices)

    def count(text, pattern) -> torch.Tensor:
        parts = [mk.sum(dtype=torch.int32) for mk in _shard_masks(devs, text, pattern, algo)]
        total = parts[0]
        for part in parts[1:]:
            total = total + part.to(total.device)
        return total

    return count
