"""Plain PyTorch k-mismatch oracles: shifted byte compares, no packed
machinery — the plain version of the approx kernel, and an
implementation-independent reference for the engine."""

from __future__ import annotations

import torch

from repro_torch.core.packing import FP_MULT, WORD_SALTS, shift_left


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


def approx_piece_candidates_ref(texts: torch.Tensor, patterns: torch.Tensor,
                                k: int) -> torch.Tensor:
    """The approx kernel's pigeonhole filter in plain PyTorch: bool (B, P,
    n), pattern p is a candidate at start i of text b when one of its k + 1
    pieces' tables flags it there (``approx.piece_tables_np``; bytes past n
    read as 0).  Needs every piece to hold a packed word (m >= 4 (k + 1)).
    Every start within k mismatches is flagged."""
    from repro_torch.core.engine import _word_offsets
    from repro_torch.kernels.approx.approx import PIECE_BITS, piece_tables_np, pieces

    ts = (texts[None, :] if texts.ndim == 1 else texts).to(torch.int64)
    P, m = patterns.shape
    tables = torch.from_numpy(piece_tables_np(patterns.cpu().numpy(), k).astype("int64"))
    tables = tables.to(ts.device)
    p = torch.arange(P, device=ts.device)
    cand = torch.zeros((ts.shape[0], P, ts.shape[1]), dtype=torch.bool, device=ts.device)
    for j, (off, ln) in enumerate(pieces(m, k)):
        v = torch.zeros_like(ts)
        for i, o in enumerate(_word_offsets(ln)[: len(WORD_SALTS)]):
            word = sum(shift_left(ts, off + o + b) << (8 * b) for b in range(4))
            v = (v + word * int(WORD_SALTS[i])) & 0xFFFFFFFF
        rows = ((v * int(FP_MULT)) & 0xFFFFFFFF) >> (32 - PIECE_BITS)  # (B, n)
        words = tables[j][rows]  # (B, n, W)
        cand |= ((words[:, :, p // 32] >> (p % 32)) & 1).transpose(1, 2).bool()
    return cand
