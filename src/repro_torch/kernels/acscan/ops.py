"""Public Aho-Corasick transition-scan ops, one for each mode of the kernel:
the CUDA kernel on the card, its plain version on the CPU."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.acscan.acscan import acscan_counts_cuda, acscan_cuda
from repro_torch.kernels.acscan.ref import acscan_counts_ref, acscan_states_ref


def _text(text: torch.Tensor) -> torch.Tensor:
    if text.ndim != 2 or text.dtype != torch.uint8:
        raise ValueError("acscan: text must be a (B, n) uint8 tensor")
    return text.contiguous()


def acscan_states(text: torch.Tensor, classes: torch.Tensor, table: torch.Tensor,
                  n_classes: int, max_m: int, *, seg: Optional[int] = None) -> torch.Tensor:
    """int32 (B, n) automaton states of a (B, n) uint8 text; the device is
    the text's own.  Any ``seg`` gives the same states."""
    fn = _build.on_device(text, acscan_cuda, acscan_states_ref)
    return fn(_text(text), classes, table, n_classes, max_m, seg=seg)


def acscan_counts(text: torch.Tensor, classes: torch.Tensor, table: torch.Tensor,
                  n_classes: int, n_term: int, max_m: int, lengths, *,
                  end_min: Optional[int] = None, seg: Optional[int] = None) -> torch.Tensor:
    """int32 (B, n_term) terminal-state histogram of a (B, n) uint8 text
    over a private table (``core.automaton.kernel_tables``); the device is
    the text's own.  Any ``seg`` gives the same counts."""
    fn = _build.on_device(text, acscan_counts_cuda, acscan_counts_ref)
    return fn(_text(text), classes, table, n_classes, n_term, max_m, lengths, end_min=end_min,
              seg=seg)


__all__ = ["acscan_counts", "acscan_counts_cuda", "acscan_counts_ref", "acscan_cuda",
           "acscan_states", "acscan_states_ref"]
