"""DLRM-style all-to-all embedding exchange for row-sharded tables, in
PyTorch.

The port's copy of ``repro.dist.embedding_exchange``.  The table is
row-sharded over one mesh axis; every rank holds the ids of its slice of the
batch (replicated over the table axis).  Lookup runs in three hops:

  1. bucket my ids by owning shard (fixed ``capacity`` slots per shard, so
     shapes are static) and ``all_to_all_single`` the id buckets along the
     table axis;
  2. every shard answers the requests that landed on it with a local gather;
  3. ``all_to_all_single`` the vectors back and scatter them to the original
     id order.

All-to-all volume is nnz * dim / k per hop versus nnz * dim all-reduced by
the simpler psum strategy (models/embedding.py) — the classic DLRM win.

Skew safety: with a fixed per-shard capacity a hot shard can overflow (zipf
ids, or adversarially all ids on one shard).  The whole lookup then takes
the exact psum path, so the result is exact for every id distribution;
capacity only controls how often the cheap path runs.

Two differences from the reference, none in a result:

  * the reference branches with ``lax.cond`` on a flag each shard computes
    alone, consistent only because the ids are replicated over the table
    axis.  Here each rank is its own process, and ranks of one group that
    took different branches would wait on each other's collectives for
    ever, so the flag is reduced with MAX over the table axis first;
  * on overflow the ranks of the table group first check that they hold
    the same ids (one MAX all-reduce of the ids and their negations: 2n
    ids beside the psum's n * d values).  Replicated ids, as shard_map's
    specs give them, take the reference's (n, d) psum.  Ids that differ
    gather the group's ids and psum a (k, n, d) tensor, k times the
    reference's volume, so that every rank's own ids are answered.

``PATH_COUNTS`` counts the lookups each path answered on this rank
(``psum_gathered``: the psum path with differing ids), as the kernels
count their launches.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from repro_torch.dist.compat import (
    P,
    all_gather,
    all_to_all,
    axis_index,
    axis_size,
    pmax,
    psum,
    shard_map,
)

AxisNames = Union[str, Tuple[str, ...]]

PATH_COUNTS = {"alltoall": 0, "psum": 0, "psum_gathered": 0}


def reset_path_counts() -> None:
    for k in PATH_COUNTS:
        PATH_COUNTS[k] = 0


def make_alltoall_lookup(
    mesh,
    table_axis: str = "model",
    batch_axes: Sequence[str] = ("data",),
    capacity_factor: float = 2.0,
):
    """Build `lookup(table, ids) -> vectors` with table row-sharded over
    ``table_axis`` and ids/outputs sharded over ``batch_axes``."""
    batch_axes = tuple(batch_axes)
    batch_spec = batch_axes[0] if len(batch_axes) == 1 else batch_axes

    def local_lookup(table_shard, ids):
        k = axis_size(table_axis)
        me = axis_index(table_axis)
        rows = table_shard.shape[0]  # rows per shard (V // k)
        n = ids.shape[0]
        cap = max(1, int(-(-n * capacity_factor // k)))

        owner = torch.clamp(ids // rows, 0, k - 1)
        onehot = owner[:, None] == torch.arange(k, device=ids.device)[None, :]  # (n, k)
        counts = onehot.sum(dim=0)  # ids per owning shard
        overflow = (counts > cap).any().to(torch.int32)
        # every rank of the table group takes the same branch
        if int(pmax(overflow, table_axis)):
            if _replicated(ids, table_axis):
                PATH_COUNTS["psum"] += 1
                return _psum_path(table_shard, ids, owner, table_axis, me, rows)
            PATH_COUNTS["psum_gathered"] += 1
            return _gathered_psum_path(table_shard, ids, table_axis, k, me, rows)
        PATH_COUNTS["alltoall"] += 1
        # slot of each id inside its owner's bucket
        pos = torch.cumsum(onehot.to(torch.int64), dim=0) - 1  # (n, k)
        pib = torch.gather(pos, 1, owner[:, None].long())[:, 0]
        slot = owner.long() * cap + pib  # (n,) in [0, k*cap)
        send = torch.zeros((k * cap,), dtype=ids.dtype, device=ids.device)
        send[slot] = ids
        # hop 1: ship id buckets to their owners
        recv = all_to_all(send.reshape(k, cap), table_axis, 0, 0)
        # hop 2: answer requests with a local gather
        local = torch.clamp(recv - me * rows, 0, rows - 1)
        vals = table_shard[local.long()]  # (k, cap, d)
        # hop 3: ship vectors back and restore the original id order
        back = all_to_all(vals, table_axis, 0, 0)
        return back.reshape(k * cap, -1)[slot]

    return shard_map(
        local_lookup,
        mesh=mesh,
        in_specs=(P(table_axis, None), P(batch_spec)),
        out_specs=P(batch_spec, None),
        check_vma=False,
    )


def _replicated(ids, table_axis: str) -> bool:
    """Whether every rank of the table group holds these same ids: the
    elementwise MAX of the ids equals minus that of their negations (the
    same answer on every rank of the group)."""
    n = ids.shape[0]
    both = pmax(torch.cat([ids, -ids]), table_axis)
    return bool(torch.equal(both[:n], -both[n:]))


def _psum_path(table_shard, ids, owner, table_axis: str, me: int, rows: int):
    """The reference's psum path: each rank answers the ids it owns (zeros
    elsewhere); the sum over the group holds every answer exactly once."""
    mine = owner == me
    local = torch.where(mine, ids - me * rows, 0)
    v = table_shard[local.long()] * mine[:, None].to(table_shard.dtype)  # (n, d)
    return psum(v, table_axis)


def _gathered_psum_path(table_shard, ids, table_axis: str, k: int, me: int, rows: int):
    """The psum path for a table group whose ranks hold different ids:
    each rank answers the ids of the whole group it owns, and takes its own
    row of the (k, n, d) sum."""
    group_ids = all_gather(ids, table_axis)  # (k, n)
    owner = torch.clamp(group_ids // rows, 0, k - 1)
    mine = owner == me
    local = torch.where(mine, group_ids - me * rows, 0)
    v = table_shard[local.long()] * mine[..., None].to(table_shard.dtype)  # (k, n, d)
    return psum(v, table_axis)[me]
