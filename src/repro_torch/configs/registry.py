"""Architecture registry of the port: the five LM archs and their reduced
smoke variants.

The port's copy of the LM half of ``repro.configs.registry``.  The GNN and
recsys archs need ``models/gnn.py`` and ``models/recsys.py``, which are not
ported yet, so they are not registered here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (
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
]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm (gnn | recsys in the reference)
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
    """Every registered (arch, shape) pair."""
    return [
        (arch_id, shape_id)
        for arch_id, spec in ARCHS.items()
        for shape_id in spec.shapes
    ]


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests (same family/topology, tiny dims)
# ---------------------------------------------------------------------------

def reduced_config(arch_id: str):
    full = get_arch(arch_id).make_config()
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
