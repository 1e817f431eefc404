"""Plain PyTorch version of the multi-pattern kernel: every pattern byte
compared at every start, the same function as the reference's vmap of the
single-pattern EPSMb oracle."""

from __future__ import annotations

import torch

from repro_torch.core.packing import shift_left


def multipattern_batched_ref(texts: torch.Tensor, patterns: torch.Tensor,
                             lengths: torch.Tensor = None) -> torch.Tensor:
    """bool (B, P, n): start i of text b matches pattern p, with i <= n - m
    and, when lengths are given, i <= lengths[b] - m."""
    ts = texts[None, :] if texts.ndim == 1 else texts
    B, n = ts.shape
    m = patterns.shape[1]
    pos = torch.arange(n, device=ts.device)
    valid = (pos <= n - m)[None, :].expand(B, n)
    if lengths is not None:
        valid = valid & (pos[None, :] <= lengths.to(ts.device)[:, None] - m)
    acc = valid[:, None, :].expand(B, patterns.shape[0], n).clone()
    for j in range(m):
        acc &= shift_left(ts, j)[:, None, :] == patterns[None, :, j, None]
    return acc


def multipattern_ref(text: torch.Tensor, patterns: torch.Tensor) -> torch.Tensor:
    """bool (P, n) for a single 1-D text."""
    return multipattern_batched_ref(text[None, :], patterns)[0]
