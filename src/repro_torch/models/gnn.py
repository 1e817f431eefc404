"""GatedGCN (Bresson & Laurent; benchmarking-gnns arXiv:2003.00982 config),
in PyTorch.

The port's copy of ``repro.models.gnn``.  Message passing on one flat edge
list: edge-index gathers (``index_select``) and segment sums
(``index_add`` over ``num_segments = n_nodes``), as the reference's
``jnp.take`` + ``jax.ops.segment_sum``.  Works for full graphs, sampled
minibatch subgraphs and block-diagonal batched molecules.

Layer (edge-gated aggregation):
    e'_ij = e_ij + ReLU(LN(A e_ij + B h_i + C h_j))
    eta_ij = sigma(e'_ij) / (sum_{j'->i} sigma(e'_ij') + eps)
    h'_i  = h_i + ReLU(LN(U h_i + sum_{j->i} eta_ij * (V h_j)))

``params["layers"]`` is a list of per-layer dicts (the reference stacks
them on axis 0 with ``jax.vmap`` and scans); with ``cfg.remat`` each layer
runs under ``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` of the scanned body.  The padding edges of a sampled
subgraph (node 0 to node 0, ``edge_mask`` 0) are live here as there: the
reference's backbone never reads ``edge_mask``.  ``constrain`` is the
reference's sharding hook, called at "nodes" and "edges"
(``dist.sharding.gnn_activation_table``); it defaults to the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.packing import resolve_device
from repro_torch.models.common import (
    dtype_of,
    layernorm,
    mlp_apply,
    mlp_init,
    scaled_init,
    softmax_cross_entropy,
    tree_map,
)


def _identity(x, name):
    return x


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 16
    d_hidden: int = 70
    d_feat: int = 1433
    d_edge_feat: int = 0  # 0 => learned constant edge init
    n_classes: int = 7
    readout: str = "node"  # "node" | "graph"
    graph_target_dim: int = 1  # for graph-level regression
    dtype: str = "float32"
    param_dtype: str = "float32"
    norm_eps: float = 1e-5
    remat: bool = True

    def param_count(self) -> int:
        d = self.d_hidden
        per_layer = 5 * d * d + 5 * d + 4 * d  # A,B,C,U,V + biases + 2 LN
        head = d * self.n_classes if self.readout == "node" else (
            d * d + d * self.graph_target_dim
        )
        return self.d_feat * d + max(self.d_edge_feat, 1) * d + self.n_layers * per_layer + head


def _layer_init(gen: torch.Generator, cfg: GNNConfig):
    d = cfg.d_hidden
    pdt = dtype_of(cfg.param_dtype)
    mats = {name: scaled_init(d)(gen, (d, d), pdt) for name in ["A", "B", "C", "U", "V"]}
    zeros = lambda: torch.zeros((d,), dtype=pdt, device=gen.device)
    ones = lambda: torch.ones((d,), dtype=pdt, device=gen.device)
    mats.update({"bA": zeros(), "bU": zeros(), "ln_h": ones(), "ln_h_b": zeros(),
                 "ln_e": ones(), "ln_e_b": zeros()})
    return mats


def init_params(gen: torch.Generator, cfg: GNNConfig, *, device=None):
    """Random parameters drawn from ``gen`` (on its device), placed on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.d_hidden
    de = max(cfg.d_edge_feat, 1)
    p = {
        "node_in": scaled_init(cfg.d_feat)(gen, (cfg.d_feat, d), pdt),
        "edge_in": scaled_init(de)(gen, (de, d), pdt),
        "layers": [_layer_init(gen, cfg) for _ in range(cfg.n_layers)],
    }
    if cfg.readout == "node":
        p["head"] = scaled_init(d)(gen, (d, cfg.n_classes), pdt)
    else:
        p["head_mlp"] = mlp_init(gen, [d, d, cfg.graph_target_dim], pdt)
    return tree_map(lambda t: t.to(dev), p)


def param_shapes(cfg: GNNConfig):
    """The parameters' shapes and dtypes, as meta tensors (nothing is
    allocated or drawn)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_params(torch.Generator(), cfg, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros((n, *x.shape[1:])).index_add(0, ids, x)


def _gated_layer(h, e, lp, src, dst, n_nodes: int, eps: float):
    """One GatedGCN layer on a flat edge list."""
    h_src = h.index_select(0, src)  # (E, d) gather
    h_dst = h.index_select(0, dst)
    e_new = e + F.relu(
        layernorm(e @ lp["A"] + lp["bA"] + h_dst @ lp["B"] + h_src @ lp["C"],
                  lp["ln_e"], lp["ln_e_b"], eps)
    )
    gate = torch.sigmoid(e_new)  # (E, d)
    msg = gate * (h_src @ lp["V"])  # (E, d)
    agg = _segment_sum(msg, dst, n_nodes)
    denom = _segment_sum(gate, dst, n_nodes)
    agg = agg / (denom + 1e-6)
    h_new = h + F.relu(layernorm(h @ lp["U"] + lp["bU"] + agg, lp["ln_h"], lp["ln_h_b"], eps))
    # keep the activation dtype stable under mixed precision (params may be
    # fp32 while states run bf16)
    return h_new.to(h.dtype), e_new.to(e.dtype)


def backbone(params, cfg: GNNConfig, graph, constrain=_identity):
    """graph = {"nodes": (N, d_feat), "edges": (2, E) int,
                "edge_feats": optional (E, d_edge)} -> node states (N, d)."""
    dt = dtype_of(cfg.dtype)
    nodes = graph["nodes"].to(dt)
    src, dst = graph["edges"][0], graph["edges"][1]
    n_nodes = nodes.shape[0]
    h = nodes @ params["node_in"]
    if cfg.d_edge_feat > 0:
        e = graph["edge_feats"].to(dt) @ params["edge_in"]
    else:
        e = params["edge_in"][0].expand(src.shape[0], cfg.d_hidden).to(dt)
    h = constrain(h, "nodes")
    e = constrain(e, "edges")
    for lp in params["layers"]:
        if cfg.remat:
            # a layer draws nothing at random: no RNG state to replay
            h, e = checkpoint(_gated_layer, h, e, lp, src, dst, n_nodes, cfg.norm_eps,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            h, e = _gated_layer(h, e, lp, src, dst, n_nodes, cfg.norm_eps)
        h, e = constrain(h, "nodes"), constrain(e, "edges")
    return h


def node_logits(params, cfg: GNNConfig, graph, constrain=_identity):
    h = backbone(params, cfg, graph, constrain)
    return h @ params["head"]


def graph_prediction(params, cfg: GNNConfig, graph, n_graphs: int, constrain=_identity):
    """graph additionally holds graph_ids (N,); n_graphs is the number of
    graphs (the reference needs it static for segment_sum)."""
    h = backbone(params, cfg, graph, constrain)
    gid = graph["graph_ids"]
    pooled = _segment_sum(h, gid, n_graphs)
    counts = _segment_sum(h.new_ones((h.shape[0], 1)), gid, n_graphs)
    pooled = pooled / torch.clamp(counts, min=1.0)
    return mlp_apply(params["head_mlp"], pooled)


def train_loss(params, cfg: GNNConfig, batch, n_graphs: int = 0, constrain=_identity):
    """Node classification (masked CE) or graph regression (MSE)."""
    if cfg.readout == "node":
        logits = node_logits(params, cfg, batch, constrain)
        mask = batch.get("label_mask")
        ce = softmax_cross_entropy(logits, batch["labels"])
        if mask is not None:
            return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return ce.mean()
    pred = graph_prediction(params, cfg, batch, n_graphs, constrain)
    tgt = batch["graph_targets"].float()
    return torch.mean(torch.square(pred.float().squeeze(-1) - tgt))
