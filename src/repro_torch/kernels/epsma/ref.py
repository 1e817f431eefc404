"""Plain PyTorch version of the EPSMa kernel: dense shifted-AND over the text."""

from __future__ import annotations

import torch

from repro_torch.core.packing import shift_left, valid_start_mask


def epsma_ref(text: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    n, m = text.shape[0], pattern.shape[0]
    if n < m:
        return torch.zeros(n, dtype=torch.bool, device=text.device)
    acc = torch.ones(n, dtype=torch.bool, device=text.device)
    for j in range(m):
        acc &= shift_left(text, j) == pattern[j]
    return acc & valid_start_mask(n, m, text.device)
