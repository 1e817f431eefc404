from repro_torch.kernels.multipattern.ops import multipattern, multipattern_batched
from repro_torch.kernels.multipattern.ref import multipattern_batched_ref, multipattern_ref
