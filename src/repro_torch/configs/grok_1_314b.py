"""grok-1-314b [hf:xai-org/grok-1; unverified]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts top-2.
"""

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "grok-1-314b"
FAMILY = "lm"
SHAPES = LM_SHAPES


def make_config(shape_id=None) -> LMConfig:
    del shape_id
    return LMConfig(
        name=ARCH_ID,
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab=131072,
        moe_experts=8,
        moe_top_k=2,
    )
