"""bst [arXiv:1905.06874; paper] — Behavior Sequence Transformer (Alibaba).

embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256.
"""

from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecSysConfig

ARCH_ID = "bst"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def make_config(shape_id=None) -> RecSysConfig:
    del shape_id
    return RecSysConfig(
        name=ARCH_ID,
        kind="bst",
        embed_dim=32,
        seq_len=20,
        n_blocks=1,
        n_heads=8,
        mlp=(1024, 512, 256),
        item_vocab=1_000_000,
        cate_vocab=10_000,
    )
