"""Baseline exact string-matching algorithms the paper compares against, in
PyTorch.

The PyTorch twin of ``repro.core.baselines`` (the paper's Tables 1-3 pit
EPSM against these):

  * ``naive_np``      — scalar numpy oracle (tests only).
  * ``packed_naive``  — vectorized shifted-AND over the full pattern.
  * ``shift_or``      — SO [Baeza-Yates & Gonnet 1992], bit-parallel NFA,
                        m <= 32.
  * ``kmp_dfa``       — KMP as an (m + 1) x 256 DFA.
  * ``rabin_karp``    — mod-2^32 rolling-hash filter + exact verification.
  * ``hash3``         — Lecroq's HASHq (q = 3) skip loop.
  * ``bndm``          — Backward Nondeterministic DAWG Matching, m <= 31.

``packed_naive`` and ``rabin_karp`` are plain tensor code on the tensor's
device, as the reference computes them in ``jnp``.  The other four are the
reference's sequential device loops (``lax.scan`` / ``lax.while_loop``); on
a CUDA tensor each runs as the segmented CUDA loop of
``repro_torch.kernels.baselines`` (one thread a segment of ``seg`` bytes,
an exact seam rule), on a CPU tensor as that loop's plain version.  Their
tables are built on the host, as the reference builds them.  Host inputs go
to the card unless ``device="cpu"`` (``packing.resolve_device``).

Every function returns ``mask: bool[n]``, True where an occurrence starts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packing import as_u8, as_u8_np, shift_left, valid_start_mask

# Default segment width, in bytes, of each device loop: one thread a
# segment.  Chosen from a sweep of 4-4096 on an H100 at 4 MiB over the
# paper's three corpora and m in {4, 8, 16, 32} (chip_smoke.py, phase
# timing-baselines; PERF.md §6): each thread's loop is a chain of dependent
# loads, so the time falls with the number of threads down to 16 bytes a
# segment (1024 blocks) even where the scans' warm-up of m - 1 bytes is
# twice the segment; below 16 the warm-up wins.  BNDM's skips, as long as
# m, favour 32.
SEG = {"shift_or": 16, "kmp_dfa": 16, "hash3": 16, "bndm": 32}


def _tensors(text, pattern, device=None):
    t = as_u8(text, device)
    p = as_u8(pattern, t.device)
    if t.ndim != 1 or p.ndim != 1:
        raise ValueError("text and pattern must be 1-D byte arrays")
    return t, p


# The largest m of the loops that keep their state in one 32-bit word.
_M_MAX = {"shift_or": 32, "bndm": 31}


def _table(arr: np.ndarray, device) -> torch.Tensor:
    """A host table as a flat int32 tensor (uint32 entries keep their bits)."""
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Scalar oracle (numpy; used by tests and to define ground truth)
# ---------------------------------------------------------------------------

def naive_np(text, pattern) -> np.ndarray:
    t = as_u8_np(text)
    p = as_u8_np(pattern)
    n, m = len(t), len(p)
    mask = np.zeros(n, dtype=bool)
    for i in range(n - m + 1):
        if np.array_equal(t[i : i + m], p):
            mask[i] = True
    return mask


# ---------------------------------------------------------------------------
# Vectorized baselines
# ---------------------------------------------------------------------------

def packed_naive(text, pattern, *, device=None) -> torch.Tensor:
    """Shifted-AND over all m characters (EPSMa generalized to any m)."""
    t, p = _tensors(text, pattern, device)
    n, m = t.shape[0], p.shape[0]
    if n < m:
        return torch.zeros(n, dtype=torch.bool, device=t.device)
    acc = torch.ones(n, dtype=torch.bool, device=t.device)
    for j in range(m):
        acc &= shift_left(t, j) == p[j]
    return acc & valid_start_mask(n, m, t.device)


def _so_table(p: np.ndarray) -> np.ndarray:
    # B[c] bit j set <=> p[j] != c
    cs = np.arange(256, dtype=np.uint8)
    bits = (p[None, :] != cs[:, None]).astype(np.uint32) << np.arange(len(p), dtype=np.uint32)[None, :]
    return bits.sum(axis=1, dtype=np.uint64).astype(np.uint32)


def shift_or(text, pattern, *, device=None) -> torch.Tensor:
    """SO: D' = (D << 1) | B[c]; match-end when bit m-1 of D is clear."""
    return _loop("shift_or", text, pattern, SEG["shift_or"], device=device)


def _kmp_table(p: np.ndarray) -> np.ndarray:
    m = len(p)
    dfa = np.zeros((m + 1, 256), dtype=np.int32)
    dfa[0, p[0]] = 1
    x = 0
    for j in range(1, m):
        dfa[j, :] = dfa[x, :]
        dfa[j, p[j]] = j + 1
        x = dfa[x, p[j]]
    # after a full match continue from the border state
    dfa[m, :] = dfa[x, :]
    dfa[m, p[x] if x < m else 0] = dfa[x, p[x]] if x < m else dfa[m, 0]
    return dfa


def kmp_dfa(text, pattern, *, device=None) -> torch.Tensor:
    """KMP compiled to a (m+1) x 256 DFA, one segmented scan."""
    return _loop("kmp_dfa", text, pattern, SEG["kmp_dfa"], device=device)


def rabin_karp(text, pattern, *, base: int = 1000003, device=None) -> torch.Tensor:
    """Karp-Rabin mod-2^32 rolling hash filter + exact verification.

    The uint32 hash is carried in int64 masked to 32 bits; the powers of
    ``base`` are reduced mod 2^32 on the host."""
    t, p = _tensors(text, pattern, device)
    n, m = t.shape[0], p.shape[0]
    if n < m:
        return torch.zeros(n, dtype=torch.bool, device=t.device)
    mask32 = 0xFFFFFFFF
    w = [pow(int(base), m - 1 - j, 1 << 32) for j in range(m)]
    h = torch.zeros(n, dtype=torch.int64, device=t.device)
    for j in range(m):
        h = (h + shift_left(t, j).long() * w[j]) & mask32
    hp = sum(int(c) * wj for c, wj in zip(as_u8_np(p), w)) & mask32
    ok = (h == hp) & valid_start_mask(n, m, t.device)
    # exact verification of candidates (dense masked)
    for j in range(m):
        ok &= shift_left(t, j) == p[j]
    return ok


# ---------------------------------------------------------------------------
# Skip-loop baselines
# ---------------------------------------------------------------------------

def _hash3_tables(p: np.ndarray, hs: int = 4096):
    m = len(p)
    q = 3

    def h(c0, c1, c2):
        return (int(c0) + (int(c1) << 3) + (int(c2) << 6)) & (hs - 1)

    shift = np.full(hs, m - q + 1, dtype=np.int32)
    # q-gram ending at pattern position j+q-1 allows shift m-1-(j+q-1)
    for j in range(m - q + 1):
        v = h(p[j], p[j + 1], p[j + 2])
        shift[v] = min(shift[v], m - 1 - (j + q - 1))
    return shift


def hash3(text, pattern, *, device=None) -> torch.Tensor:
    """Lecroq HASHq (q=3): Wu-Manber style q-gram shift table + skip loop."""
    return _loop("hash3", text, pattern, SEG["hash3"], device=device)


def _bndm_table(p: np.ndarray) -> np.ndarray:
    m = len(p)
    B = np.zeros(256, dtype=np.uint32)
    for j in range(m):
        B[p[j]] |= np.uint32(1) << np.uint32(m - 1 - j)
    return B


def bndm(text, pattern, *, device=None) -> torch.Tensor:
    """BNDM: bit-parallel suffix automaton with window skips (m <= 31)."""
    return _loop("bndm", text, pattern, SEG["bndm"], device=device)


_TABLES = {"shift_or": _so_table, "kmp_dfa": _kmp_table, "hash3": _hash3_tables,
           "bndm": _bndm_table}


def _loop(name: str, text, pattern, seg: int, *, device=None) -> torch.Tensor:
    """Device loop ``name`` over segments of ``seg`` bytes, under the
    reference's edge rules: the one-word limit checked first, HASH3 below m
    = 3 as ``packed_naive``, an empty pattern refused, n < m all False."""
    t, p = _tensors(text, pattern, device)
    n, m = t.shape[0], p.shape[0]
    if m > _M_MAX.get(name, m):
        raise ValueError(f"{name} supports m <= {_M_MAX[name]} (single 32-bit word)")
    if name == "hash3" and m < 3:
        return packed_naive(t, p)
    if m == 0:
        raise ValueError("empty pattern")
    if seg < 1:
        raise ValueError(f"{name}: seg must be >= 1")
    if n < m:
        return torch.zeros(n, dtype=torch.bool, device=t.device)
    from repro_torch.kernels.baselines import ops

    return getattr(ops, name)(t, p, loop_table(name, p, t.device), int(seg))


def loop_table(name: str, pattern, device) -> torch.Tensor:
    """The host table of device loop ``name`` for ``pattern``, as the flat
    int32 tensor its kernel and plain version read, on ``device``."""
    return _table(_TABLES[name](as_u8_np(pattern)), device)


BASELINES = {
    "packed_naive": packed_naive,
    "shift_or": shift_or,
    "kmp_dfa": kmp_dfa,
    "rabin_karp": rabin_karp,
    "hash3": hash3,
    "bndm": bndm,
}
