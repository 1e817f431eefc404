"""minitron-4b [arXiv:2407.14679; hf] — pruned nemotron, dense GQA.

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "minitron-4b"
FAMILY = "lm"
SHAPES = LM_SHAPES


def make_config(shape_id=None) -> LMConfig:
    del shape_id
    return LMConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=9216,
        vocab=256000,
    )
