"""Launch wrapper of the k-mismatch CUDA kernel (``csrc/approx.cu``).

Replaces the TPU kernel ``repro/kernels/approx/approx.py:_approx_kernel``
together with the valid-start masking of its ``ops._run``.  The kernel is
bound by bytes: B*n text bytes in, B*P*n mask bytes out (B*n*(P+1) / 3.35
TB/s on an H100 SXM); its design is described in the CUDA source.

Two paths, chosen by one static rule (``use_pieces``):

  * the pigeonhole filter: each pattern is cut into k + 1 disjoint pieces;
    a window within k mismatches matches one of them exactly, so k + 1
    probes of per-piece pattern-id tables (built once per patterns tensor
    and k, ``piece_tables``) name the only patterns worth counting;
  * the first-word path (the relaxed-LUT warp gate and a first packed
    word within k) for pieces shorter than a packed word (m < 4 (k + 1)),
    budgets of m or more, tables past PIECE_TABLE_CAP, and more than 32
    patterns whose per-position piece rows would not fit a block's shared
    memory (``pieces_smem_bytes``).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import _np_pack_words, _np_window_fingerprint, _word_offsets
from repro_torch.core.packing import FP_MULT, PACK, WORD_SALTS
from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR
from repro_torch.kernels.multipattern.multipattern import (
    LUT_MAX_KBITS,
    SALTS,
    _cached_bitset,
    _Salts,
)

# Rows of a piece table, 2^PIECE_BITS (the kernel's constant of that name)
PIECE_BITS = 12
# Most bytes the piece tables of one (patterns, k) may take on the card
PIECE_TABLE_CAP = 64 << 20
# Shared memory one block of an H100 may use (the kernel's SMEM_MAX)
SMEM_BUDGET = 227 * 1024
TILE = 4096  # positions a block owns

_ARGTYPES = [PTR, I64, I64, PTR, I64, PTR, PTR, I64, I64, ctypes.c_int, PTR, ctypes.c_int,
             ctypes.c_int, PTR, _Salts, ctypes.c_uint32, PTR]


def pieces(m: int, k: int) -> List[Tuple[int, int]]:
    """(offset, length) of the k + 1 disjoint pieces covering [0, m): the
    first k + 1 - m % (k + 1) of length m // (k + 1), the rest one longer
    (the layout ``approx_pieces_kernel`` computes in the CUDA source)."""
    n_p = k + 1
    short, extra = divmod(m, n_p)
    big0 = n_p - extra
    return [(j * short + max(0, j - big0), short + (j >= big0)) for j in range(n_p)]


def piece_table_bytes(P: int, k: int) -> int:
    return (k + 1) * (4 << PIECE_BITS) * -(-P // 32)


def pieces_smem_bytes(m: int, k: int, P: int) -> int:
    """Dynamic shared memory of the filter's block (``approx_pieces_smem_bytes``
    in the CUDA source): the staged text (the tile, the halo of min(m - 1,
    8192) bytes rounded up to 16, 16 of slack) and, for more than 32
    patterns, a uint16 row of every piece at every position of the tile."""
    staged = TILE + -(-min(m - 1, 8192) // 16) * 16 + 16
    return staged + (2 * (k + 1) * TILE if P > 32 else 0)


def use_pieces(m: int, k: int, P: int) -> bool:
    """The static rule: the pigeonhole filter takes (m, k, P) when every
    piece holds a packed word (m >= 4 (k + 1), so k < m), the tables fit
    PIECE_TABLE_CAP and the block's shared memory fits SMEM_BUDGET; the
    first-word path takes the rest."""
    return (m >= PACK * (k + 1) and piece_table_bytes(P, k) <= PIECE_TABLE_CAP
            and pieces_smem_bytes(m, k, P) <= SMEM_BUDGET)


def piece_hashes(pats: np.ndarray, k: int) -> np.ndarray:
    """(k + 1, P) int64 rows of each pattern's pieces: the engine's salted
    word chain over the piece's first <= len(WORD_SALTS) packed words
    (``_word_offsets`` of the piece), FP_MULT, top PIECE_BITS bits."""
    rows = []
    for off, ln in pieces(pats.shape[1], k):
        words = _np_pack_words(pats[:, off : off + ln], _word_offsets(ln))[:, : len(WORD_SALTS)]
        rows.append(_np_window_fingerprint(words, PIECE_BITS).astype(np.int64))
    return np.stack(rows)


def piece_tables_np(pats: np.ndarray, k: int) -> np.ndarray:
    """(k + 1, 2^PIECE_BITS, W) uint32: bit p % 32 of word p // 32 of row
    h of table j is set when piece j of pattern p hashes to h."""
    rows = piece_hashes(pats, k)
    P = pats.shape[0]
    tables = np.zeros((k + 1, 1 << PIECE_BITS, -(-P // 32)), np.uint32)
    pid = np.arange(P)
    bit = np.uint32(1) << (pid % 32).astype(np.uint32)
    for j in range(k + 1):
        np.bitwise_or.at(tables[j], (rows[j], pid // 32), bit)
    return tables


# (id(patterns), k) -> (weakref to patterns, its version, tables)
_PIECE_TABLES: dict = {}


def piece_tables(patterns: torch.Tensor, k: int) -> torch.Tensor:
    """The piece tables of a (P, m) patterns tensor for budget k, int32 on
    its device, built once and cached by the tensor's identity and version."""
    key = (id(patterns), k)
    ent = _PIECE_TABLES.get(key)
    if ent is not None and ent[0]() is patterns and ent[1] == patterns._version:
        return ent[2]
    tables = piece_tables_np(patterns.cpu().numpy(), k)
    tables = torch.from_numpy(tables.view(np.int32)).to(patterns.device)
    for dead in [kk for kk, (ref, _, _) in _PIECE_TABLES.items() if ref() is None]:
        del _PIECE_TABLES[dead]
    _PIECE_TABLES[key] = (weakref.ref(patterns), patterns._version, tables)
    return tables


def approx_cuda(texts: torch.Tensor, patterns: torch.Tensor, anchors: torch.Tensor, k: int,
                lut: Optional[torch.Tensor] = None, *, kbits: int = 17,
                lengths: torch.Tensor = None, start_min: int = 0,
                _pieces: Optional[bool] = None) -> torch.Tensor:
    """bool (B, P, n): start i of text b is within ``k`` mismatches of
    pattern p, with start_min <= i <= lengths[b] - m.

    ``texts`` is a contiguous (B, n) uint8 CUDA tensor, ``patterns`` the
    (P, m) uint8 stack of one plan and ``anchors`` its (P, nw) int32 packed
    words (``_word_offsets(m)``).  ``lut``, when given, is the plan's
    (2^kbits,) bool relaxed fingerprint table, used as a warp gate on the
    first-word path: it must hold every fingerprint reachable within k
    mismatches (a plan compiled for a budget of at least k).  The path is
    ``use_pieces(m, k, P)``; ``_pieces=False`` (a test hook) forces the
    first-word path.
    """
    if texts.ndim != 2 or texts.dtype != torch.uint8 or not texts.is_contiguous() or not texts.is_cuda:
        raise ValueError("approx: texts must be a contiguous (B, n) uint8 CUDA tensor")
    B, n = texts.shape
    dev = texts.device
    if patterns.ndim != 2 or patterns.dtype != torch.uint8 or patterns.device != dev:
        raise ValueError(f"approx: patterns must be (P, m) uint8 on {dev}")
    P, m = patterns.shape
    nw = m // 4 + (m % 4 != 0) if m >= 4 else 0
    if m < 1 or k < 0:
        raise ValueError(f"approx kernel requires m >= 1 and k >= 0 (m={m}, k={k})")
    if anchors.shape != (P, nw) or anchors.dtype != torch.int32 or anchors.device != dev:
        raise ValueError(f"approx: anchors must be ({P}, {nw}) int32 on {dev}")
    use_lut = lut is not None
    if use_lut and (lut.dtype != torch.bool or lut.numel() != 1 << kbits or lut.device != dev
                    or not 1 <= kbits <= LUT_MAX_KBITS or not 1 <= nw <= len(WORD_SALTS)):
        raise ValueError(f"approx: the gate needs a (2^kbits,) bool LUT on {dev}, "
                         f"1 <= kbits <= {LUT_MAX_KBITS} and 1 to {len(WORD_SALTS)} words")
    if lengths is None:
        lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or lengths.device != dev:
        raise ValueError(f"approx: lengths must be ({B},) int32 on {dev}")
    if _pieces not in (None, False):
        raise ValueError("approx: _pieces is None (the rule) or False (first-word path)")
    out = torch.empty((B, P, n), dtype=torch.bool, device=dev)
    if out.numel() == 0:
        return out
    patterns, anchors, lengths = patterns.contiguous(), anchors.contiguous(), lengths.contiguous()
    with_pieces = _pieces is None and use_pieces(m, k, P)
    tables = piece_tables(patterns, k) if with_pieces else None
    bitset = _cached_bitset(lut) if use_lut and not with_pieces else None
    fn = _build.function("approx", "approx_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        # a budget of m or more admits every window: clamp it into an int
        rc = fn(texts.data_ptr(), B, n, lengths.data_ptr(), int(start_min), patterns.data_ptr(),
                anchors.data_ptr(), P, m, min(int(k), m),
                None if bitset is None else bitset.data_ptr(),
                int(kbits if bitset is not None else 17), int(bitset is not None),
                None if tables is None else tables.data_ptr(), SALTS, int(FP_MULT),
                out.data_ptr(), _build.stream_of(texts))
    _build.raise_on_error("approx", rc)
    _build.count_launch(approx_cuda)
    return out


approx_cuda.launches = 0
