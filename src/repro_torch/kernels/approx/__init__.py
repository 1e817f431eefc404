from repro_torch.kernels.approx.ops import approx_batched, approx_multipattern
from repro_torch.kernels.approx.ref import approx_batched_ref, kmismatch_ref
