"""Plain PyTorch versions of the EPSMc kernel.

``epsmc_ref`` is the dense shifted-AND definition of exact matching;
``epsmc_filter_ref`` is the plain fingerprint filter the kernel computes
(strided 8-byte block hashes, the 2^11 table, verification of the starts
each candidate block covers).
"""

from __future__ import annotations

import torch

from repro_torch.core.epsm import EPSMC_BETA, EPSMC_KBITS, _epsmc_stride
from repro_torch.core.packing import (
    fingerprint_weights,
    hash_blocks,
    shift_left,
    valid_start_mask,
)


def epsmc_ref(text: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Dense shifted-AND ground truth (definition of exact matching)."""
    n, m = text.shape[0], pattern.shape[0]
    if n < m:
        return torch.zeros(n, dtype=torch.bool, device=text.device)
    acc = torch.ones(n, dtype=torch.bool, device=text.device)
    for j in range(m):
        acc &= shift_left(text, j) == pattern[j]
    return acc & valid_start_mask(n, m, text.device)


def epsmc_filter_ref(text: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """The strided fingerprint filter + verification, in plain PyTorch."""
    n, m = text.shape[0], pattern.shape[0]
    beta = EPSMC_BETA
    dev = text.device
    if m < 2 * beta or n < m:
        raise ValueError("epsmc_filter_ref requires 16 <= m <= n")
    weights = fingerprint_weights(beta, device=dev)
    # the paper's table L of the m - beta + 1 pattern-substring fingerprints
    lut = torch.zeros(1 << EPSMC_KBITS, dtype=torch.bool, device=dev)
    lut[hash_blocks(pattern.unfold(0, beta, 1), weights, EPSMC_KBITS).long()] = True
    # inspected aligned blocks, one per stride
    stride = _epsmc_stride(m, beta)
    nblk = (n - beta) // stride + 1
    blocks = text.contiguous().as_strided((nblk, beta), (stride, 1))
    cand_blk = lut[hash_blocks(blocks, weights, EPSMC_KBITS).long()]
    # a candidate block at b covers the starts [b - (m - beta), b]
    bstart = torch.nonzero(cand_blk).flatten() * stride
    cover = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    cover.index_add_(0, (bstart - (m - beta)).clamp_(min=0), torch.ones_like(bstart, dtype=torch.int32))
    cover.index_add_(0, bstart + 1, torch.full_like(bstart, -1, dtype=torch.int32))
    cand = (cover.cumsum(0, dtype=torch.int32)[:n] > 0) & valid_start_mask(n, m, dev)
    # verify the candidate starts byte by byte, dropping misses as they show
    idx = torch.nonzero(cand).flatten()
    for j in range(m):
        if idx.numel() == 0:
            break
        idx = idx[text[idx + j] == pattern[j]]
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[idx] = True
    return mask
