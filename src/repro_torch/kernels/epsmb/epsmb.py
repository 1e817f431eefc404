"""Launch wrapper of the EPSMb CUDA kernel (``csrc/epsmb.cu``).

Replaces the TPU kernel ``repro/kernels/epsmb/epsmb.py:_epsmb_kernel``.  The
kernel is bound by bytes: n text bytes in, n mask bytes out (2n / 3.35 TB/s on
an H100 SXM); its design is described in the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR


def epsmb_cuda(text: torch.Tensor, pattern: torch.Tensor, *,
               fuse_verify: bool = True) -> torch.Tensor:
    """Match-start mask of pattern in text (4 <= m <= n); with
    ``fuse_verify=False`` the 4-byte anchor mask, as ``epsmb_ref`` gives it."""
    _build.check_u8("epsmb", text, pattern)
    n, m = text.shape[0], pattern.shape[0]
    if not 4 <= m <= n:
        raise ValueError(f"epsmb kernel requires 4 <= m <= n (m={m}, n={n})")
    out = torch.empty(n, dtype=torch.bool, device=text.device)
    fn = _build.function("epsmb", "epsmb_launch", [PTR, I64, PTR, I64, ctypes.c_int, PTR])
    with torch.cuda.device(text.device):
        rc = fn(text.data_ptr(), n, pattern.data_ptr(), m, int(fuse_verify),
                out.data_ptr(), _build.stream_of(text))
    _build.raise_on_error("epsmb", rc)
    _build.count_launch(epsmb_cuda)
    return out


epsmb_cuda.launches = 0
