from repro_torch.kernels.megascan.ops import MegaSpec, build_mega_spec, megascan_count_window
from repro_torch.kernels.megascan.ref import megascan_count_window_ref
