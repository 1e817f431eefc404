"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.
"""

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"
FAMILY = "lm"
SHAPES = LM_SHAPES


def make_config(shape_id=None) -> LMConfig:
    del shape_id
    return LMConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab=32064,
        moe_experts=16,
        moe_top_k=2,
    )
