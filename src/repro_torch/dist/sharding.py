"""Sharding strategy tables and byte-range partitioning, in the PyTorch port.

The port's copy of ``repro.dist.sharding``.  The spec tables are pure
functions from (config, mesh, strategy) to trees of ``PartitionSpec``s
(``dist.compat``) for params, optimizer state, activations and input
batches of all three model families; they equal the reference's entry for
entry.  ``tree_to_shardings`` turns a spec tree into ``NamedSharding``s
(a mesh and DTensor placements, one per mesh dimension),
``distribute_tree`` places a tree of tensors by a spec tree, and
``make_constrain`` builds the ``constrain(x, name)`` callback the models
thread through.

Conventions, as in the reference:

  * the "model" mesh axis carries tensor parallelism; every other axis is
    data parallelism (:func:`dp_axes` flattens them);
  * a dim is only sharded when the axis size divides it, otherwise the spec
    degrades to replicated on that dim, so the same strategy table works on
    the 16x16 production mesh and a one-rank mesh;
  * LM strategies: ``"tp_sp"`` (Megatron-style tensor parallel + sequence
    parallel residuals), ``"zero_dp"`` (params/optimizer sharded over the
    dp axes); GNN strategies: ``"nodes_sharded"`` / ``"nodes_replicated"``.

Stacked layers: the reference stacks the list under ``layers`` on a
leading axis and its tables skip that axis (``base = 1``).  The port keeps
a list of per-layer dicts (``models.common.is_stacked_layers``), so the
tables here see each per-layer leaf with the reference's stacked shape
(the layer count prepended) and the port's spec is the reference's
without its leading None: one rule, applied by :func:`_map_specs`.

A mesh here is a ``DeviceMesh`` (``dist.compat.make_mesh``); the tables
read only its axis names and sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.dist.compat import (
    AxisNames,
    P,
    PartitionSpec,
    distribute,
    mesh_axes,
    placements_of,
)
from repro_torch.models.common import is_stacked_layers
from repro_torch.train.optimizer import AdamWState


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------

def all_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh_axes(mesh))


def axis_size(mesh, axes: AxisNames) -> int:
    """Product of the named mesh axis sizes (1 for absent/None axes)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_axes(mesh)
    size = 1
    for a in axes:
        if a in shape:
            size *= shape[a]
    return size


def dp_axes(mesh) -> AxisNames:
    """The data-parallel axes: every mesh axis except "model"."""
    dp = tuple(a for a in all_axes(mesh) if a != "model")
    if not dp:
        return None
    return dp[0] if len(dp) == 1 else dp


def _axis_if(mesh, axes: AxisNames, dim: int) -> AxisNames:
    """`axes` if its total size divides `dim`, else None (replicate)."""
    if axes is None:
        return None
    return axes if dim % axis_size(mesh, axes) == 0 else None


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, and its DTensor placements (one per mesh dim)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_of(self.mesh, self.spec)


def _spec_map(fn, tree, *rest):
    """fn over the PartitionSpec leaves of a nest of dicts / lists /
    NamedTuples (and the matching leaves of ``rest``)."""
    if isinstance(tree, PartitionSpec):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_spec_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    raise TypeError(f"not a spec tree leaf: {type(tree).__name__}")


def tree_to_shardings(mesh, spec_tree):
    return _spec_map(lambda s: NamedSharding(mesh, s), spec_tree)


def distribute_tree(tree, mesh, specs):
    """Place a tree of tensors, which every rank holds whole, by a matching
    spec tree: DTensors whose local shards are this rank's slices."""
    return _spec_map(lambda s, t: distribute(t, mesh, s), specs, tree)


def _map_specs(fn, tree, path=(), stacked=0):
    """fn(path, shape) -> spec over a tree of tensors, with the reference's
    paths and shapes: dict keys are path entries, a list's index is an int
    entry, and the stacked layer list adds no entry but prepends the layer
    count to its leaves' shapes; their specs drop that leading entry."""
    if isinstance(tree, torch.Tensor):
        shape = ((stacked,) if stacked else ()) + tuple(tree.shape)
        spec = fn(path, shape)
        if stacked and len(spec):
            if spec[0] is not None:
                raise ValueError(f"{path}: the stacked layer axis is sharded in {spec}")
            spec = P(*spec[1:])
        return spec
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, path + (k,), stacked) for k, v in tree.items()}
    if is_stacked_layers(path, tree):
        return [_map_specs(fn, x, path, len(tree)) for x in tree]
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, x, path + (i,), stacked) for i, x in enumerate(tree))
    raise TypeError(f"not a tensor tree leaf: {type(tree).__name__}")


# ---------------------------------------------------------------------------
# Byte-range partitioning (sharded streaming scans, DESIGN.md §10)
# ---------------------------------------------------------------------------

def range_partition(
    total: int, n_shards: int, *, align: int = 1
) -> Tuple[Tuple[int, int], ...]:
    """n_shards contiguous (start, stop) byte ranges covering [0, total).

    Interior boundaries are rounded DOWN to `align` (the stream seam rule
    needs every shard start on a beta block boundary so chunk-local aligned
    block fingerprints coincide with the global ones); the last shard absorbs
    the un-aligned remainder.  Degenerate shards (start == stop) are legal —
    they own no end positions and scan nothing."""
    total, n_shards, align = int(total), int(n_shards), int(align)
    if total < 0 or n_shards < 1 or align < 1:
        raise ValueError("range_partition needs total >= 0, n_shards/align >= 1")
    bounds = [
        min(total, (total * i) // n_shards // align * align)
        for i in range(n_shards + 1)
    ]
    bounds[0], bounds[-1] = 0, total
    return tuple((bounds[i], bounds[i + 1]) for i in range(n_shards))


def merge_ranges(ranges) -> Tuple[Tuple[int, int], ...]:
    """Sorted union of (start, stop) byte ranges: overlapping and adjacent
    ranges coalesce, empty ranges drop.  The canonical form PartialScanResult
    reports covered/missing coverage in (DESIGN.md §12)."""
    out: list = []
    for s, e in sorted((int(s), int(e)) for s, e in ranges):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return tuple(out)


def complement_ranges(ranges, total: int) -> Tuple[Tuple[int, int], ...]:
    """[0, total) minus the given ranges (merged first)."""
    out, pos = [], 0
    for s, e in merge_ranges(ranges):
        if s > pos:
            out.append((pos, s))
        pos = max(pos, e)
    if pos < int(total):
        out.append((pos, int(total)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class StreamShardSpec:
    """Range-partition plan for one logical stream scanned by many hosts.

    Shard i scans ``ranges[i]`` with ``overlap`` bytes of carried prefix
    (the bytes immediately before its start) injected into its first window;
    end-position attribution makes it own exactly the occurrences whose last
    byte falls inside its range."""

    total_bytes: int
    ranges: Tuple[Tuple[int, int], ...]
    overlap: int  # carried prefix bytes at each interior boundary
    align: int    # boundary alignment (the EPSMc beta block)

    @property
    def n_shards(self) -> int:
        return len(self.ranges)

    def prefix_range(self, i: int) -> Tuple[int, int]:
        """Byte range of shard i's injected overlap prefix (empty for i=0 or
        a shard starting at 0)."""
        s = self.ranges[i][0]
        return (max(0, s - self.overlap), s)


def make_stream_shard_spec(
    total: int, n_shards: int, *, overlap: int, align: int
) -> StreamShardSpec:
    if overlap < 0 or overlap % align:
        raise ValueError("overlap must be a non-negative multiple of align")
    return StreamShardSpec(
        total_bytes=int(total),
        ranges=range_partition(total, n_shards, align=align),
        overlap=int(overlap),
        align=int(align),
    )


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------

def make_constrain(mesh, table: dict):
    """Build the `constrain(x, name)` callback models thread through.

    Unknown names and rank-mismatched specs pass through untouched, so one
    table can serve several step functions (train/prefill/decode share
    names).  A DTensor is redistributed to the table's placement; a plain
    tensor (a rank's local shard) passes through.
    """
    from torch.distributed.tensor import DTensor

    def constrain(x, name):
        spec = table.get(name)
        if spec is None or len(spec) != getattr(x, "ndim", -1) or not isinstance(x, DTensor):
            return x
        return x.redistribute(mesh, placements_of(mesh, spec))

    return constrain


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _path_has(path, name: str) -> bool:
    return name in path


def lm_param_specs(cfg, mesh, strategy: str = "tp_sp"):
    """PartitionSpec tree matching transformer.param_shapes(cfg).

    tp_sp: column-shard the QKV/up projections and row-shard the out/down
    projections over "model" (Megatron); embeddings vocab-sharded.
    zero_dp: shard the largest divisible non-stack dim over the dp axes.
    """
    from repro_torch.models import transformer as tf_mod

    shapes = tf_mod.param_shapes(cfg)
    dp = dp_axes(mesh)

    col = {"wq", "wk", "wv", "w1", "w3"}       # output-feature sharded
    row = {"wo", "w2"}                          # input-feature sharded

    def tp_spec(path, shape):
        name = _leaf_name(path)
        stacked = _path_has(path, "layers")     # leading n_layers scan dim
        base = 1 if stacked else 0
        spec = [None] * len(shape)
        if name in col and len(shape) - base == 2:
            spec[-1] = _axis_if(mesh, "model", shape[-1])
        elif name in row and len(shape) - base == 2:
            spec[-2] = _axis_if(mesh, "model", shape[-2])
        elif name == "embed":
            spec[0] = _axis_if(mesh, "model", shape[0])
        elif name == "unembed":
            spec[-1] = _axis_if(mesh, "model", shape[-1])
        elif _path_has(path, "moe") and len(shape) - base >= 2:
            # expert-stacked weights: shard the expert dim over "model"
            spec[base] = _axis_if(mesh, "model", shape[base])
        return P(*spec)

    def zero_spec(path, shape):
        stacked = _path_has(path, "layers")
        base = 1 if stacked else 0
        spec = [None] * len(shape)
        # largest divisible dim (excluding the scan-stack dim) goes to dp
        cands = sorted(range(base, len(shape)), key=lambda i: -shape[i])
        for i in cands:
            if _axis_if(mesh, dp, shape[i]) is not None:
                spec[i] = dp
                break
        return P(*spec)

    fn = zero_spec if strategy == "zero_dp" else tp_spec
    return _map_specs(fn, shapes)


def lm_activation_table(cfg, mesh, kind: str, B: int, strategy: str = "tp_sp"):
    """name -> PartitionSpec for the constrain() names used by models/transformer."""
    del kind
    dp = dp_axes(mesh)
    bdp = _axis_if(mesh, dp, B)
    mdl_heads = _axis_if(mesh, "model", cfg.n_heads)
    mdl_kv = _axis_if(mesh, "model", cfg.n_kv_heads)
    mdl_ff = _axis_if(mesh, "model", cfg.d_ff)
    mdl_vocab = _axis_if(mesh, "model", cfg.vocab)
    if strategy == "zero_dp":
        # params live on dp; activations stay batch-sharded only
        mdl_heads = mdl_kv = mdl_ff = mdl_vocab = None
    return {
        "residual": P(bdp, None, None),                  # (B, S, d)
        "qkv": P(bdp, None, mdl_heads, None),            # (B, S, H, hd)
        "kv_attn": P(bdp, None, mdl_kv, None),           # (B, S, KV, hd)
        "ffn_hidden": P(bdp, None, mdl_ff),              # (B, S, f)
        "moe_in": P(bdp, None, None),                    # (B, S, d)
        "logits": P(bdp, None, mdl_vocab),               # (B, chunk, V)
        "kv_cache": P(bdp, None, mdl_kv, None),          # (B, S, KV, hd)
        "kv_cache_l": P(bdp, None, mdl_kv, None),        # (B, Smax, KV, hd)
        "kv_cache_scale": P(bdp, None, mdl_kv),          # (B, Smax, KV)
    }


def lm_batch_specs(kind: str, mesh, B: int, strategy: str = "tp_sp"):
    del strategy
    dp = dp_axes(mesh)
    bdp = _axis_if(mesh, dp, B)
    if kind == "lm_train":
        return {"tokens": P(bdp, None), "targets": P(bdp, None)}
    if kind == "lm_prefill":
        return {"tokens": P(bdp, None)}
    if kind == "lm_decode":
        # kcache/vcache are (L, B, Smax, KV, hd)
        return {
            "token": P(bdp, None),
            "kcache": P(None, bdp, None, None, None),
        }
    raise ValueError(f"unknown LM kind {kind!r}")


def opt_state_specs(param_specs) -> AdamWState:
    """AdamW state shards exactly like its params (fp32 moments, ZeRO-1)."""
    return AdamWState(step=P(), m=param_specs, v=param_specs)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def gnn_param_specs(param_sds):
    """GatedGCN params are tiny (d_hidden ~ 70): replicate everything."""
    return _map_specs(lambda path, shape: P(), param_sds)


def gnn_activation_table(mesh, strategy: str = "nodes_sharded"):
    if strategy == "nodes_replicated":
        return {}
    ax = all_axes(mesh)
    axes = ax[0] if len(ax) == 1 else ax
    return {"nodes": P(axes, None), "edges": P(axes, None)}


def gnn_batch_specs(mesh, batch_sds):
    ax = all_axes(mesh)
    axes = ax[0] if len(ax) == 1 else ax

    def spec(path, shape):
        name = _leaf_name(path)
        if name == "edges":  # (2, E) edge index
            return P(None, _axis_if(mesh, axes, shape[1]))
        if name in ("graph_targets",):
            return P()
        first = _axis_if(mesh, axes, shape[0]) if shape else None
        return P(first, *([None] * (len(shape) - 1))) if shape else P()

    return _map_specs(spec, batch_sds)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def recsys_param_specs(cfg, mesh, param_sds):
    """Row-shard the big embedding tables over "model"; replicate the dense
    towers (they are MBs at most)."""
    del cfg

    def spec(path, shape):
        if (
            _path_has(path, "tables")
            or _leaf_name(path) in ("item_table", "cate_table")
        ) and len(shape) == 2 and shape[0] >= 1024:
            return P(_axis_if(mesh, "model", shape[0]), None)
        return P(*([None] * len(shape)))

    return _map_specs(spec, param_sds)


def recsys_batch_specs(mesh, batch_sds):
    dp = dp_axes(mesh)

    def spec(path, shape):
        if not shape:
            return P()
        return P(_axis_if(mesh, dp, shape[0]), *([None] * (len(shape) - 1)))

    return _map_specs(spec, batch_sds)
