"""Architecture registry of the port: the 10 assigned archs (five LM, one
GNN, four recsys), reduced smoke variants, and helpers shared by the
launchers, tests and chip_smoke.py.

The port's copy of ``repro.configs.registry``, in the reference's order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (
    bst,
    dcn_v2,
    dien,
    din,
    gatedgcn,
    grok_1_314b,
    minitron_4b,
    phi3_5_moe_42b_a6_6b,
    smollm_135m,
    yi_9b,
)
from repro_torch.configs.shapes import ShapeCell

_MODULES = [
    phi3_5_moe_42b_a6_6b,
    grok_1_314b,
    yi_9b,
    minitron_4b,
    smollm_135m,
    gatedgcn,
    dien,
    bst,
    dcn_v2,
    din,
]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys
    module: object

    def make_config(self, shape_id=None):
        return self.module.make_config(shape_id)

    @property
    def shapes(self) -> Dict[str, ShapeCell]:
        return self.module.SHAPES


ARCHS: Dict[str, ArchSpec] = {
    m.ARCH_ID: ArchSpec(m.ARCH_ID, m.FAMILY, m) for m in _MODULES
}

ARCH_IDS = list(ARCHS)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return ARCHS[arch_id]


def all_cells():
    """Every assigned (arch, shape) pair — the 40 dry-run cells."""
    return [
        (arch_id, shape_id)
        for arch_id, spec in ARCHS.items()
        for shape_id in spec.shapes
    ]


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests (same family/topology, tiny dims)
# ---------------------------------------------------------------------------

def reduced_config(arch_id: str):
    spec = get_arch(arch_id)
    if spec.family == "lm":
        full = spec.make_config()
        return dataclasses.replace(
            full,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            d_ff=128,
            vocab=512,
            moe_experts=4 if full.is_moe else 0,
            dtype="float32",
            param_dtype="float32",
            q_chunk=32,
            kv_chunk=32,
            ce_chunk=32,
            moe_group=64,
        )
    if spec.family == "gnn":
        full = spec.make_config("full_graph_sm")
        return dataclasses.replace(
            full, n_layers=2, d_hidden=16, d_feat=12, n_classes=5
        )
    # recsys
    full = spec.make_config()
    kw = dict(
        embed_dim=8,
        item_vocab=1000,
        cate_vocab=100,
        mlp=(32, 16),
    )
    if full.kind == "dien":
        kw["gru_dim"] = 16
    if full.kind == "bst":
        kw["n_heads"] = 4
    if full.kind == "dcn":
        kw["sparse_vocabs"] = tuple([100] * full.n_sparse)
        kw["n_cross_layers"] = 2
    if full.kind == "din":
        kw["attn_mlp"] = (16, 8)
    if full.seq_len:
        kw["seq_len"] = 10
    return dataclasses.replace(full, **kw)
