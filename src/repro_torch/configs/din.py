"""din [arXiv:1706.06978; paper] — Deep Interest Network, target attention.

embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80.
"""

from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecSysConfig

ARCH_ID = "din"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def make_config(shape_id=None) -> RecSysConfig:
    del shape_id
    return RecSysConfig(
        name=ARCH_ID,
        kind="din",
        embed_dim=18,
        seq_len=100,
        attn_mlp=(80, 40),
        mlp=(200, 80),
        item_vocab=1_000_000,
        cate_vocab=10_000,
    )
