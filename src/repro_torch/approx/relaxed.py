"""Host-side relaxed fingerprint LUT for k-mismatch candidate gating.

The port's copy of ``repro.approx.relaxed`` (DESIGN.md §8), host numpy only.

The exact engine gates EPSMb verification with a 2^kbits LUT of the window
fingerprints the P patterns can present (core/engine.py).  A text window that
matches a pattern under <= k byte substitutions presents a *different*
fingerprint, so the exact LUT would reject true fuzzy occurrences.  The fix
is precomputing, on host, the set of all fingerprints *reachable* from each
pattern under <= k substitutions in the anchor window, and registering every
one of them.

Why that expansion is cheap and bounded: the window fingerprint is

    fp(v) = ((v * MULT) mod 2^32) >> (32 - kbits),
    v     = sum_i word_i * salt_i  (mod 2^32),

and v is LINEAR in the window bytes — byte j contributes
``byte * coef_j mod 2^32`` where coef_j folds the per-word salt and the
byte's lane shift over every packed word covering position j (bytes under
the overlapping final word are covered twice; coef_j sums both).  So
substituting byte j from b to b' moves v by exactly ``(b' - b) * coef_j``,
and the <= k-reachable v-set is

    { v0 + sum over a <= k chosen positions of a nonzero delta } ,

of size bounded by C(w, k) * 255^k for window width w — enumerable by pure
numpy broadcasting, no text involved.  For k=1 that is w*255 entries; for
k=2 the set approaches table saturation, the gate stops paying, and None is
returned so the engine runs its dense counting path instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.engine import _FP_MULT, _WORD_SALTS, _word_offsets
from repro_torch.core.packing import PACK

# Expansion is skipped (-> dense path, still exact w.r.t. the k-mismatch
# semantics) when the enumerated set could fill more than this fraction of
# the table: a saturated gate admits every block and only adds overhead.
DENSITY_MAX = 1 / 8
# Hard cap on enumerated v-values per plan (all patterns together): keeps
# plan compilation bounded even for large P * C(w,2) * 255^2 requests.
EXPAND_CAP = 8_000_000


def byte_coefs(m: int) -> Optional[np.ndarray]:
    """uint32 (m,) per-byte linear coefficients of the window fingerprint,
    or None when m needs more packed words than there are salts."""
    offsets = _word_offsets(m)
    if m < PACK or len(offsets) > len(_WORD_SALTS):
        return None
    coef = np.zeros(m, np.uint64)
    for i, o in enumerate(offsets):
        for b in range(PACK):
            coef[o + b] += (np.uint64(_WORD_SALTS[i]) << np.uint64(8 * b))
    return (coef & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _fp_of(v: np.ndarray, kbits: int) -> np.ndarray:
    return ((v * _FP_MULT) >> np.uint32(32 - kbits)).astype(np.int64)


def expansion_count(m: int, k: int) -> int:
    """Number of enumerated v-values for one pattern window (k' = 0..k)."""
    total = 1
    if k >= 1:
        total += m * 255
    if k >= 2:
        total += (m * (m - 1) // 2) * 255 * 255
    return total


def relaxed_window_lut(
    pats: np.ndarray, *, kbits: int, k: int
) -> Optional[np.ndarray]:
    """(2^kbits,) bool LUT of every fingerprint reachable from any of the
    (P, m) patterns under <= k substitutions, or None when the gate would
    not pay (k > 2, window too wide for the salts, or table saturation)."""
    P, m = pats.shape
    if k > 2:
        return None
    coef = byte_coefs(m)
    if coef is None:
        return None
    cnt = P * expansion_count(m, k)
    if cnt > EXPAND_CAP:
        return None
    # balls-into-bins density estimate: cnt values into 2^kbits buckets
    # saturate the table long before cnt == 2^kbits; skip eagerly.
    table = 1 << kbits
    est_density = 1.0 - np.exp(-cnt / table)
    if est_density > DENSITY_MAX:
        return None

    lut = np.zeros(table, np.bool_)
    with np.errstate(over="ignore"):
        for p in range(P):
            pat = pats[p].astype(np.uint32)
            v0 = np.uint32(
                (pat.astype(np.uint64) * coef.astype(np.uint64)).sum()
                & np.uint64(0xFFFFFFFF)
            )
            lut[_fp_of(np.asarray([v0], np.uint32), kbits)] = True
            if k < 1:
                continue
            # per-position nonzero deltas: (m, 255) uint32
            vals = np.arange(256, dtype=np.uint32)
            dmat = (vals[None, :] - pat[:, None]) * coef[:, None]
            deltas = [dmat[j][vals != pat[j]] for j in range(m)]
            d1 = np.concatenate(deltas)
            lut[_fp_of(v0 + d1, kbits)] = True
            if k < 2:
                continue
            for j1 in range(m):  # chunked over the first position: O(m*255^2)
                for j2 in range(j1 + 1, m):
                    v = v0 + deltas[j1][:, None] + deltas[j2][None, :]
                    lut[_fp_of(v.reshape(-1), kbits)] = True
    if lut.sum() > DENSITY_MAX * table:
        return None
    return lut
