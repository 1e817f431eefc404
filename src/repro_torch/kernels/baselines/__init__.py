from repro_torch.kernels.baselines.ops import bndm, hash3, kmp_dfa, shift_or
from repro_torch.kernels.baselines.ref import bndm_ref, hash3_ref, kmp_dfa_ref, shift_or_ref
