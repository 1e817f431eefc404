"""gatedgcn [arXiv:2003.00982; paper] — benchmarking-gnns config.

n_layers=16 d_hidden=70 aggregator=gated.  d_feat / n_classes / readout are
dataset (shape) properties, so the config is shape-dependent.
"""

from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.models.gnn import GNNConfig

ARCH_ID = "gatedgcn"
FAMILY = "gnn"
SHAPES = GNN_SHAPES


def make_config(shape_id="full_graph_sm") -> GNNConfig:
    meta = GNN_SHAPES[shape_id].meta
    if shape_id == "molecule":
        return GNNConfig(
            name=ARCH_ID,
            n_layers=16,
            d_hidden=70,
            d_feat=meta["d_feat"],
            d_edge_feat=meta["d_edge_feat"],
            readout="graph",
            graph_target_dim=1,
        )
    return GNNConfig(
        name=ARCH_ID,
        n_layers=16,
        d_hidden=70,
        d_feat=meta["d_feat"],
        n_classes=meta["n_classes"],
        readout="node",
    )
