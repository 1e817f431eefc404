from repro_torch.kernels.epsma.ops import epsma
from repro_torch.kernels.epsma.ref import epsma_ref
