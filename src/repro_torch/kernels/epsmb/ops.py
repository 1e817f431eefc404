"""Public EPSMb op: the CUDA kernel on the card, its plain version on the CPU."""

from __future__ import annotations

import torch

from repro_torch.core.packing import PACK, shift_left, valid_start_mask
from repro_torch.kernels import _build
from repro_torch.kernels.epsmb.epsmb import epsmb_cuda
from repro_torch.kernels.epsmb.ref import epsmb_ref


def epsmb(text: torch.Tensor, pattern: torch.Tensor, *,
          fuse_verify: bool = True) -> torch.Tensor:
    """Match-start mask of a 1-D uint8 pattern (m >= 4) in a 1-D uint8 text.

    With ``fuse_verify=False`` the kernel emits 4-gram anchor candidates only
    and the remaining m - 4 bytes are verified here, as in the reference.
    """
    _build.check_pair("epsmb", text, pattern)
    n, m = text.shape[0], pattern.shape[0]
    if m < PACK:
        raise ValueError("epsmb requires m >= 4 (use epsma)")
    if n < m:
        return torch.zeros(n, dtype=torch.bool, device=text.device)
    mask = _build.on_device(text, epsmb_cuda, epsmb_ref)(text, pattern, fuse_verify=fuse_verify)
    if not fuse_verify:
        for j in range(PACK, m):
            mask &= shift_left(text, j) == pattern[j]
        mask &= valid_start_mask(n, m, text.device)
    return mask
