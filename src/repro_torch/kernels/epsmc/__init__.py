from repro_torch.kernels.epsmc.ops import epsmc
from repro_torch.kernels.epsmc.ref import epsmc_filter_ref, epsmc_ref
