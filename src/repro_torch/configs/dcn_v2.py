"""dcn-v2 [arXiv:2008.13535; paper] — deep & cross v2, full-rank cross.

n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3 mlp=1024-1024-512.
"""

from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecSysConfig, dcn_default_vocabs

ARCH_ID = "dcn-v2"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def make_config(shape_id=None) -> RecSysConfig:
    del shape_id
    return RecSysConfig(
        name=ARCH_ID,
        kind="dcn",
        embed_dim=16,
        n_dense=13,
        n_sparse=26,
        n_cross_layers=3,
        mlp=(1024, 1024, 512),
        sparse_vocabs=dcn_default_vocabs(26),
    )
