"""Public EPSMc op: the CUDA kernel on the card, its plain version on the CPU."""

from __future__ import annotations

import torch

from repro_torch.core.epsm import EPSMC_BETA
from repro_torch.kernels import _build
from repro_torch.kernels.epsmc.epsmc import epsmc_cuda
from repro_torch.kernels.epsmc.ref import epsmc_filter_ref


def epsmc(text: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Match-start mask of a 1-D uint8 pattern (m >= 16) in a 1-D uint8 text."""
    _build.check_pair("epsmc", text, pattern)
    n, m = text.shape[0], pattern.shape[0]
    if m < 2 * EPSMC_BETA:
        raise ValueError(f"epsmc kernel requires m >= {2 * EPSMC_BETA} (use epsmb)")
    if n < m:
        return torch.zeros(n, dtype=torch.bool, device=text.device)
    return _build.on_device(text, epsmc_cuda, epsmc_filter_ref)(text, pattern)
