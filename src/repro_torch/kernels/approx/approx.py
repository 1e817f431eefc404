"""Launch wrapper of the k-mismatch CUDA kernel (``csrc/approx.cu``).

Replaces the TPU kernel ``repro/kernels/approx/approx.py:_approx_kernel``
together with the valid-start masking of its ``ops._run``.  The kernel is
bound by bytes: B*n text bytes in, B*P*n mask bytes out (B*n*(P+1) / 3.35
TB/s on an H100 SXM); its design is described in the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.packing import FP_MULT, WORD_SALTS
from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR
from repro_torch.kernels.multipattern.multipattern import LUT_MAX_KBITS, _cached_bitset, _Salts


def approx_cuda(texts: torch.Tensor, patterns: torch.Tensor, anchors: torch.Tensor, k: int,
                lut: Optional[torch.Tensor] = None, *, kbits: int = 17,
                lengths: torch.Tensor = None, start_min: int = 0) -> torch.Tensor:
    """bool (B, P, n): start i of text b is within ``k`` mismatches of
    pattern p, with start_min <= i <= lengths[b] - m.

    ``texts`` is a contiguous (B, n) uint8 CUDA tensor, ``patterns`` the
    (P, m) uint8 stack of one plan and ``anchors`` its (P, nw) int32 packed
    words (``_word_offsets(m)``).  ``lut``, when given, is the plan's
    (2^kbits,) bool relaxed fingerprint table, used as a warp gate: it must
    hold every fingerprint reachable within k mismatches (a plan compiled
    for a budget of at least k).
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
    out = torch.empty((B, P, n), dtype=torch.bool, device=dev)
    if out.numel() == 0:
        return out
    patterns, anchors, lengths = patterns.contiguous(), anchors.contiguous(), lengths.contiguous()
    bitset = _cached_bitset(lut) if use_lut else lengths  # unread without the gate
    salts = _Salts((ctypes.c_uint32 * len(WORD_SALTS))(*(int(s) for s in WORD_SALTS)))
    fn = _build.function("approx", "approx_launch",
                         [PTR, I64, I64, PTR, I64, PTR, PTR, I64, I64, ctypes.c_int, PTR,
                          ctypes.c_int, ctypes.c_int, _Salts, ctypes.c_uint32, PTR])
    with torch.cuda.device(dev):
        # a budget of m or more admits every window: clamp it into an int
        rc = fn(texts.data_ptr(), B, n, lengths.data_ptr(), int(start_min), patterns.data_ptr(),
                anchors.data_ptr(), P, m, min(int(k), m), bitset.data_ptr(),
                int(kbits if use_lut else 17), int(use_lut), salts, int(FP_MULT), out.data_ptr(),
                _build.stream_of(texts))
    _build.raise_on_error("approx", rc)
    approx_cuda.launches += 1
    return out


approx_cuda.launches = 0
