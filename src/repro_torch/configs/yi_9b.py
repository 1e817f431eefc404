"""yi-9b [arXiv:2403.04652; hf] — llama-arch GQA dense.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "yi-9b"
FAMILY = "lm"
SHAPES = LM_SHAPES


def make_config(shape_id=None) -> LMConfig:
    del shape_id
    return LMConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab=64000,
    )
