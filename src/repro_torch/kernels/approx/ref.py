"""Plain PyTorch k-mismatch oracles: shifted byte compares, no packed
machinery — the plain version of the approx kernel, and an
implementation-independent reference for the engine."""

from __future__ import annotations

import torch

from repro_torch.core.packing import shift_left


def approx_batched_ref(texts: torch.Tensor, patterns: torch.Tensor, k: int,
                       lengths: torch.Tensor = None) -> torch.Tensor:
    """bool (B, P, n): the window at start i of text b differs from pattern p
    in at most k bytes, with i <= n - m and, when lengths are given,
    i <= lengths[b] - m."""
    ts = texts[None, :] if texts.ndim == 1 else texts
    B, n = ts.shape
    P, m = patterns.shape
    mm = torch.zeros((B, P, n), dtype=torch.int32, device=ts.device)
    for j in range(m):
        mm += (shift_left(ts, j)[:, None, :] != patterns[None, :, j, None]).to(torch.int32)
    if lengths is None:
        lengths = torch.full((B,), n, dtype=torch.int32, device=ts.device)
    pos = torch.arange(n, device=ts.device)[None, :]
    valid = pos <= (lengths.to(ts.device)[:, None] - m)
    return (mm <= k) & valid[:, None, :]


def kmismatch_ref(text: torch.Tensor, pattern: torch.Tensor, k: int) -> torch.Tensor:
    """bool[n]: Hamming distance of the window at i to pattern <= k."""
    return approx_batched_ref(text[None, :], pattern[None, :], k)[0, 0]
