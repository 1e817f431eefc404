from repro_torch.kernels.acscan.ops import acscan_states
from repro_torch.kernels.acscan.ref import acscan_states_ref
