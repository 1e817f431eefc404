from repro_torch.configs.registry import ARCHS, ARCH_IDS, all_cells, get_arch, reduced_config
from repro_torch.configs.shapes import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, ShapeCell, pad_to
