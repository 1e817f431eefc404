"""Assigned input-shape cells, one table per architecture family (the
port's copy of ``repro.configs.shapes``; the GNN and recsys tables are
copied as data).

Every (arch x shape) pair is a dry-run cell; `kind` selects which step
function is lowered (train_step vs serve_step variants), per the assignment:
decode_*/long_* lower serve_step (one token + KV cache), not train_step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    shape_id: str
    kind: str  # lm_train | lm_prefill | lm_decode |
    #            gnn_full | gnn_sampled | gnn_batched |
    #            rs_train | rs_serve | rs_retrieval
    meta: dict


LM_SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "lm_train", {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeCell("prefill_32k", "lm_prefill", {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeCell("decode_32k", "lm_decode", {"seq": 32768, "batch": 128}),
    # long-context decode: one token against a 512k-entry KV cache.  All five
    # assigned LM archs are full-attention; decode is LINEAR in seq (the
    # quadratic concern applies to prefill only — noted in DESIGN.md).
    "long_500k": ShapeCell("long_500k", "lm_decode", {"seq": 524288, "batch": 1}),
}

GNN_SHAPES: Dict[str, ShapeCell] = {
    # cora full-batch
    "full_graph_sm": ShapeCell(
        "full_graph_sm",
        "gnn_full",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7},
    ),
    # reddit, sampled 2-hop subgraph: 1024 seeds, fanout 15 then 10
    "minibatch_lg": ShapeCell(
        "minibatch_lg",
        "gnn_sampled",
        {
            "base_nodes": 232_965,
            "base_edges": 114_615_892,
            "batch_nodes": 1024,
            "fanout": (15, 10),
            "sub_nodes": 1024 * (1 + 15 + 150),  # 169,984
            "sub_edges": 1024 * 15 + 1024 * 15 * 10,  # 168,960
            "d_feat": 602,
            "n_classes": 41,
        },
    ),
    # ogbn-products full-batch
    "ogb_products": ShapeCell(
        "ogb_products",
        "gnn_full",
        {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100, "n_classes": 47},
    ),
    # ZINC-like batched molecules, graph-level regression
    "molecule": ShapeCell(
        "molecule",
        "gnn_batched",
        {
            "n_graphs": 128,
            "nodes_per_graph": 30,
            "edges_per_graph": 64,
            "d_feat": 28,
            "d_edge_feat": 4,
        },
    ),
}

RECSYS_SHAPES: Dict[str, ShapeCell] = {
    "train_batch": ShapeCell("train_batch", "rs_train", {"batch": 65536}),
    "serve_p99": ShapeCell("serve_p99", "rs_serve", {"batch": 512}),
    "serve_bulk": ShapeCell("serve_bulk", "rs_serve", {"batch": 262144}),
    "retrieval_cand": ShapeCell(
        "retrieval_cand", "rs_retrieval", {"batch": 1, "n_candidates": 1_000_000}
    ),
}


def pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult
