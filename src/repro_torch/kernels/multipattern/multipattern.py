"""Launch wrapper of the multi-pattern CUDA kernel (``csrc/multipattern.cu``).

Replaces the TPU kernel ``repro/kernels/multipattern/multipattern.py:_mp_kernel``
together with the valid-start masking of its ``ops._run``.  The kernel is
bound by bytes: B*n text bytes in, B*P*n mask bytes out (B*n*(P+1) / 3.35
TB/s on an H100 SXM); its design is described in the CUDA source.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from repro_torch.core.packing import FP_MULT, WORD_SALTS
from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR

TILE = 4096  # the kernel's tile; the longest pattern it takes
LUT_MAX_KBITS = 26


class _Salts(ctypes.Structure):
    _fields_ = [("s", ctypes.c_uint32 * len(WORD_SALTS))]


# the engine's word salts as the kernels' by-value Salts argument, built once
SALTS = _Salts((ctypes.c_uint32 * len(WORD_SALTS))(*(int(s) for s in WORD_SALTS)))


def _lut_bitset(lut: torch.Tensor) -> torch.Tensor:
    """(2^kbits,) bool -> int32 words of 32 bits each, bit j of word w being
    lut[32 w + j] (padded to a whole word).  The bits of a word are distinct,
    so their int32 sum wraps into exactly the word's bits."""
    pad = (-lut.numel()) % 32
    bits = torch.nn.functional.pad(lut.to(torch.int32), (0, pad)).view(-1, 32)
    shifts = torch.arange(32, dtype=torch.int32, device=lut.device)
    return (bits << shifts).sum(-1, dtype=torch.int32)


# id(lut) -> (weakref to lut, its version, bitset): a plan's LUT is packed once
_BITSETS: dict = {}


def _cached_bitset(lut: torch.Tensor) -> torch.Tensor:
    ent = _BITSETS.get(id(lut))
    if ent is not None and ent[0]() is lut and ent[1] == lut._version:
        return ent[2]
    bitset = _lut_bitset(lut)
    for key in [k for k, (ref, _, _) in _BITSETS.items() if ref() is None]:
        del _BITSETS[key]
    _BITSETS[id(lut)] = (weakref.ref(lut), lut._version, bitset)
    return bitset


def multipattern_cuda(texts: torch.Tensor, anchors: torch.Tensor, m: int, lut: torch.Tensor, *,
                      kbits: int, use_lut: bool, lengths: torch.Tensor = None,
                      start_min: int = 0) -> torch.Tensor:
    """bool (B, P, n) match-start masks of P same-length patterns in B texts.

    ``texts`` is a contiguous (B, n) uint8 tensor, ``anchors`` the (P, nw)
    int32 packed anchor words of a plan (``_word_offsets(m)``), ``lut`` its
    (2^kbits,) bool union fingerprint table, used as a tile gate when
    ``use_lut``.  A start i counts when start_min <= i <= lengths[b] - m.
    """
    if texts.ndim != 2 or texts.dtype != torch.uint8 or not texts.is_contiguous() or not texts.is_cuda:
        raise ValueError("multipattern: texts must be a contiguous (B, n) uint8 CUDA tensor")
    B, n = texts.shape
    dev = texts.device
    nw = m // 4 + (m % 4 != 0)
    if not 4 <= m <= TILE:
        raise ValueError(f"multipattern kernel requires 4 <= m <= {TILE} (m={m})")
    if anchors.ndim != 2 or anchors.shape[1] != nw or anchors.dtype != torch.int32 or anchors.device != dev:
        raise ValueError(f"multipattern: anchors must be (P, {nw}) int32 on {dev}")
    if use_lut and (nw > len(WORD_SALTS) or lut.dtype != torch.bool or lut.numel() != 1 << kbits
                    or lut.device != dev or not 1 <= kbits <= LUT_MAX_KBITS):
        raise ValueError(f"multipattern: the gate needs a (2^kbits,) bool LUT on {dev}, "
                         f"1 <= kbits <= {LUT_MAX_KBITS} and at most {len(WORD_SALTS)} words")
    if lengths is None:
        lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or lengths.device != dev:
        raise ValueError(f"multipattern: lengths must be ({B},) int32 on {dev}")
    P = anchors.shape[0]
    out = torch.empty((B, P, n), dtype=torch.bool, device=dev)
    if out.numel() == 0:
        return out
    anchors = anchors.contiguous()
    lengths = lengths.contiguous()
    bitset = _cached_bitset(lut) if use_lut else anchors  # unread without the gate
    fn = _build.function("multipattern", "multipattern_launch",
                         [PTR, I64, I64, PTR, I64, PTR, I64, I64, PTR, ctypes.c_int,
                          ctypes.c_int, _Salts, ctypes.c_uint32, PTR])
    with torch.cuda.device(dev):
        rc = fn(texts.data_ptr(), B, n, lengths.data_ptr(), int(start_min), anchors.data_ptr(),
                P, m, bitset.data_ptr(), int(kbits if use_lut else 17), int(use_lut), SALTS,
                int(FP_MULT), out.data_ptr(), _build.stream_of(texts))
    _build.raise_on_error("multipattern", rc)
    _build.count_launch(multipattern_cuda)
    return out


multipattern_cuda.launches = 0
