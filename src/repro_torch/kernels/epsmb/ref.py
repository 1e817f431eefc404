"""Plain PyTorch version of the EPSMb kernel."""

from __future__ import annotations

import torch

from repro_torch.core.packing import PACK, pack_u32, pack_word_u32, shift_left, valid_start_mask


def epsmb_ref(text: torch.Tensor, pattern: torch.Tensor, *,
              fuse_verify: bool = True) -> torch.Tensor:
    """Match-start mask (fuse_verify=True) or 4-gram anchor mask (False)."""
    n, m = text.shape[0], pattern.shape[0]
    if n < m:
        return torch.zeros(n, dtype=torch.bool, device=text.device)
    acc = pack_u32(text) == pack_word_u32(pattern[:PACK])
    if fuse_verify:
        for j in range(PACK, m):
            acc &= shift_left(text, j) == pattern[j]
        return acc & valid_start_mask(n, m, text.device)
    return acc & valid_start_mask(n, PACK, text.device)
