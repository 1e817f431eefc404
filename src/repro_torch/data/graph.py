"""Graph data substrate: synthetic graph generators (power-law degree) and a
CSR neighbor sampler for the minibatch_lg shape (GraphSAGE fanout
sampling).

The port's copy of ``repro.data.graph``: host numpy, unchanged, so the same
seed gives equal arrays in both packages.  Batches go to the device through
``train.loop.batch_to``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,)
    feats: np.ndarray  # (N, d)
    labels: np.ndarray  # (N,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)


def synthetic_graph(
    n_nodes: int, avg_degree: int, d_feat: int, n_classes: int, seed: int = 0
) -> CSRGraph:
    """Power-law-ish degree distribution via preferential attachment lite."""
    rng = np.random.RandomState(seed)
    degs = np.minimum(
        rng.zipf(1.7, size=n_nodes) + avg_degree // 2, n_nodes - 1
    ).astype(np.int64)
    scale = (avg_degree * n_nodes) / max(degs.sum(), 1)
    degs = np.maximum((degs * scale).astype(np.int64), 1)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(degs)
    indices = rng.randint(0, n_nodes, size=int(indptr[-1])).astype(np.int32)
    feats = rng.randn(n_nodes, d_feat).astype(np.float32)
    labels = rng.randint(0, n_classes, size=n_nodes).astype(np.int32)
    return CSRGraph(indptr, indices, feats, labels)


def edge_list(graph: CSRGraph) -> np.ndarray:
    """(2, E) [src, dst] from CSR (dst = row owner; messages flow src->dst)."""
    dst = np.repeat(np.arange(graph.n_nodes, dtype=np.int32),
                    np.diff(graph.indptr).astype(np.int64))
    return np.stack([graph.indices.astype(np.int32), dst])


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanout: Tuple[int, ...],
    seed: int = 0,
) -> dict:
    """GraphSAGE-style layered uniform neighbor sampling.

    Returns a PADDED subgraph (fixed shapes for jit): nodes are
    [seeds | hop1 | hop2 ...], each hop padded to seeds * prod(fanout so far);
    edges point sampled-neighbor -> parent.  Padding uses node 0 with a mask.
    """
    rng = np.random.RandomState(seed)
    frontier = seeds.astype(np.int64)
    all_nodes = [frontier]
    srcs, dsts = [], []
    offset = 0  # index of the frontier inside the node table
    next_offset = len(frontier)
    for f in fanout:
        pad_n = len(frontier) * f
        nbrs = np.zeros(pad_n, dtype=np.int64)
        mask = np.zeros(pad_n, dtype=bool)
        for i, node in enumerate(frontier):
            lo, hi = graph.indptr[node], graph.indptr[node + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            picks = graph.indices[lo + rng.choice(deg, size=take, replace=deg < f)]
            nbrs[i * f : i * f + take] = picks[:take]
            mask[i * f : i * f + take] = True
        # edges: sampled neighbor (child, new slot) -> parent (frontier slot)
        child_slots = next_offset + np.arange(pad_n)
        parent_slots = offset + np.repeat(np.arange(len(frontier)), f)
        keep = mask
        srcs.append(child_slots[keep])
        dsts.append(parent_slots[keep])
        all_nodes.append(nbrs)
        offset = next_offset
        next_offset += pad_n
        frontier = nbrs

    node_ids = np.concatenate(all_nodes)
    src = np.concatenate(srcs).astype(np.int32) if srcs else np.zeros(0, np.int32)
    dst = np.concatenate(dsts).astype(np.int32) if dsts else np.zeros(0, np.int32)
    max_edges = sum(len(seeds) * int(np.prod(fanout[: i + 1])) for i in range(len(fanout)))
    e = len(src)
    src_p = np.zeros(max_edges, np.int32)
    dst_p = np.zeros(max_edges, np.int32)
    edge_mask = np.zeros(max_edges, np.float32)
    src_p[:e], dst_p[:e], edge_mask[:e] = src, dst, 1.0
    label_mask = np.zeros(len(node_ids), np.float32)
    label_mask[: len(seeds)] = 1.0  # loss only on seed nodes
    return {
        "nodes": graph.feats[node_ids],
        "edges": np.stack([src_p, dst_p]),
        "edge_mask": edge_mask,
        "labels": graph.labels[node_ids],
        "label_mask": label_mask,
        "node_ids": node_ids,
    }


def batched_molecules(
    n_graphs: int, nodes_per: int, edges_per: int, d_feat: int, d_edge: int, seed: int = 0
) -> dict:
    """Block-diagonal batch of small molecule-like graphs + scalar targets."""
    rng = np.random.RandomState(seed)
    N, E = n_graphs * nodes_per, n_graphs * edges_per
    src = rng.randint(0, nodes_per, size=E).astype(np.int32)
    dst = rng.randint(0, nodes_per, size=E).astype(np.int32)
    block = np.repeat(np.arange(n_graphs, dtype=np.int32), edges_per) * nodes_per
    return {
        "nodes": rng.randn(N, d_feat).astype(np.float32),
        "edges": np.stack([src + block, dst + block]),
        "edge_feats": rng.randn(E, d_edge).astype(np.float32),
        "graph_ids": np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per),
        "graph_targets": rng.randn(n_graphs).astype(np.float32),
    }
