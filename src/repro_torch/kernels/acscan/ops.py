"""Public Aho-Corasick transition-scan op: the CUDA kernel on the card, its
plain version on the CPU."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.acscan.acscan import acscan_cuda
from repro_torch.kernels.acscan.ref import acscan_states_ref


def acscan_states(text: torch.Tensor, classes: torch.Tensor, delta: torch.Tensor,
                  n_classes: int, max_m: int, *, seg: Optional[int] = None) -> torch.Tensor:
    """int32 (B, n) automaton states of a (B, n) uint8 text; the device is
    the text's own.  Any ``seg`` gives the same states."""
    if text.ndim != 2 or text.dtype != torch.uint8:
        raise ValueError("acscan: text must be a (B, n) uint8 tensor")
    fn = _build.on_device(text, acscan_cuda, acscan_states_ref)
    return fn(text.contiguous(), classes, delta, n_classes, max_m, seg=seg)


__all__ = ["acscan_cuda", "acscan_states", "acscan_states_ref"]
