from repro_torch.kernels.acscan.ops import acscan_counts, acscan_states
from repro_torch.kernels.acscan.ref import acscan_counts_ref, acscan_states_ref
