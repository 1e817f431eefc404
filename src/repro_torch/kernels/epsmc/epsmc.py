"""Launch wrapper of the EPSMc CUDA kernels (``csrc/epsmc.cu``).

Replaces the TPU kernel ``repro/kernels/epsmc/epsmc.py:_epsmc_kernel`` and
the apron combine of its wrapper.  The scan is bound by bytes: n text bytes
in, n mask bytes out (2n / 3.35 TB/s on an H100 SXM); its design is described
in the CUDA source.  One launch here is the 256-byte table build plus the
scan, queued on the current stream.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.epsm import EPSMC_BETA, _epsmc_stride
from repro_torch.core.packing import fingerprint_weights
from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR

TABLE_BYTES = 256  # the 2^11-bit fingerprint table L
_WEIGHTS = fingerprint_weights(EPSMC_BETA).tolist()


def epsmc_cuda(text: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Match-start mask (bool, length n) of pattern in text, 16 <= m <= n."""
    _build.check_u8("epsmc", text, pattern)
    n, m = text.shape[0], pattern.shape[0]
    if not 2 * EPSMC_BETA <= m <= n:
        raise ValueError(f"epsmc kernel requires 16 <= m <= n (m={m}, n={n})")
    out = torch.empty(n, dtype=torch.bool, device=text.device)
    table = torch.empty(TABLE_BYTES, dtype=torch.uint8, device=text.device)
    weights = (ctypes.c_int32 * EPSMC_BETA)(*_WEIGHTS)
    fn = _build.function(
        "epsmc", "epsmc_launch",
        [PTR, I64, PTR, I64, I64, ctypes.POINTER(ctypes.c_int32), PTR, PTR],
    )
    with torch.cuda.device(text.device):
        rc = fn(text.data_ptr(), n, pattern.data_ptr(), m, _epsmc_stride(m, EPSMC_BETA),
                weights, table.data_ptr(), out.data_ptr(), _build.stream_of(text))
    _build.raise_on_error("epsmc", rc)
    _build.count_launch(epsmc_cuda)
    return out


epsmc_cuda.launches = 0
