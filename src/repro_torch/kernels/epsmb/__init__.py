from repro_torch.kernels.epsmb.ops import epsmb
from repro_torch.kernels.epsmb.ref import epsmb_ref
