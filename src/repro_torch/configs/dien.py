"""dien [arXiv:1809.03672; unverified] — interest evolution (GRU + AUGRU).

embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80 interaction=augru.
"""

from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.models.recsys import RecSysConfig

ARCH_ID = "dien"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def make_config(shape_id=None) -> RecSysConfig:
    del shape_id
    return RecSysConfig(
        name=ARCH_ID,
        kind="dien",
        embed_dim=18,
        seq_len=100,
        gru_dim=108,
        mlp=(200, 80),
        item_vocab=1_000_000,
        cate_vocab=10_000,
    )
