"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf] — llama-arch small, tied.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""

from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "smollm-135m"
FAMILY = "lm"
SHAPES = LM_SHAPES


def make_config(shape_id=None) -> LMConfig:
    del shape_id
    return LMConfig(
        name=ARCH_ID,
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab=49152,
        tie_embeddings=True,
    )
