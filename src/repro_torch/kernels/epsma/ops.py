"""Public EPSMa op: the CUDA kernel on the card, its plain version on the CPU."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epsma.epsma import epsma_cuda
from repro_torch.kernels.epsma.ref import epsma_ref


def epsma(text: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Match-start mask of a 1-D uint8 pattern in a 1-D uint8 text.

    Any m >= 1; the device is the tensors' own.
    """
    _build.check_pair("epsma", text, pattern)
    if pattern.shape[0] == 0:
        raise ValueError("empty pattern")
    if text.shape[0] < pattern.shape[0]:
        return torch.zeros(text.shape[0], dtype=torch.bool, device=text.device)
    return _build.on_device(text, epsma_cuda, epsma_ref)(text, pattern)
