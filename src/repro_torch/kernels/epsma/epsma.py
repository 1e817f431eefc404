"""Launch wrapper of the EPSMa CUDA kernel (``csrc/epsma.cu``).

Replaces the TPU kernel ``repro/kernels/epsma/epsma.py:_epsma_kernel``.  The
kernel is bound by bytes: n text bytes in, n mask bytes out (2n / 3.35 TB/s on
an H100 SXM); its design is described in the CUDA source.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR


def epsma_cuda(text: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Match-start mask (bool, length n) of pattern in text, 1 <= m <= n."""
    _build.check_u8("epsma", text, pattern)
    n, m = text.shape[0], pattern.shape[0]
    if not 1 <= m <= n:
        raise ValueError(f"epsma kernel requires 1 <= m <= n (m={m}, n={n})")
    out = torch.empty(n, dtype=torch.bool, device=text.device)
    fn = _build.function("epsma", "epsma_launch", [PTR, I64, PTR, I64, PTR])
    with torch.cuda.device(text.device):
        rc = fn(text.data_ptr(), n, pattern.data_ptr(), m, out.data_ptr(),
                _build.stream_of(text))
    _build.raise_on_error("epsma", rc)
    _build.count_launch(epsma_cuda)
    return out


epsma_cuda.launches = 0
