"""The collective helpers the sharded-stream merge rides on, in PyTorch.

The port's counterpart of the collectives of ``repro.dist.compat``.  The
reference merges host arrays across processes through jax.distributed; here
the processes form a ``torch.distributed`` group (``launch.mesh.
init_stream_cluster``, gloo), which carries host tensors on the card's
machine too, so no NCCL group is needed.  With no group initialized every
helper is the single-process identity, so the sharded scanner needs no mode
switch.  ``shard_map``, ``axis_size``, ``cost_analysis_dict`` and
``make_mesh`` shim jax APIs and have no counterpart here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of this process's torch.distributed group, or
    (0, 1) when no group is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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
