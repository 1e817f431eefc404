"""repro_torch.approx — packed k-mismatch approximate matching.

The port's copy of ``repro.approx`` (DESIGN.md §8).  A position i matches
pattern p under budget k iff the m-byte window at i differs from p in at most
k bytes.  Engine-integrated: the canonical entry points are
``engine.compile_patterns(..., k=...)`` plus ``engine.match_many /
count_many(..., k=...)``; this module adds the building blocks (packed
counting filter, relaxed fingerprint LUT) and single-pattern conveniences
mirroring ``epsm.find`` / ``epsm.count``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.approx.counting import (  # noqa: F401
    APPROX_CAND_BLOCK,
    count_group_approx,
    match_group_approx,
    mismatch_counts,
)
from repro_torch.approx.relaxed import relaxed_window_lut  # noqa: F401
from repro_torch.core import engine
from repro_torch.core.packing import as_u8, as_u8_np


def _index_and_plans(text, pattern, k: int, device):
    idx = engine.build_index(as_u8(text, device))
    plans = engine.compile_patterns_cached([as_u8_np(pattern)], k=int(k), device=idx.device)
    return idx, plans


def find_kmismatch(text, pattern, k: int, *, device=None) -> torch.Tensor:
    """bool[n] k-mismatch match-start mask for one (text, pattern) pair."""
    idx, plans = _index_and_plans(text, pattern, k, device)
    return engine.match_many(idx, plans, k=int(k))[0, 0]


def count_kmismatch(text, pattern, k: int, *, device=None) -> torch.Tensor:
    """0-d int32 number of k-mismatch occurrences."""
    idx, plans = _index_and_plans(text, pattern, k, device)
    return engine.count_many(idx, plans, k=int(k))[0, 0]


def kmismatch_naive(text, pattern, k: int) -> np.ndarray:
    """Vectorized-numpy oracle: bool[n] mask, the test/bench reference."""
    t, p = as_u8_np(text), as_u8_np(pattern)
    n, m = t.shape[0], p.shape[0]
    if n < m:
        return np.zeros(n, bool)
    mm = np.zeros(n - m + 1, np.int32)
    for j in range(m):
        mm += t[j : j + n - m + 1] != p[j]
    out = np.zeros(n, bool)
    out[: n - m + 1] = mm <= k
    return out
