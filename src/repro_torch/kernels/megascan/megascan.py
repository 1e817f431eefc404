"""Launch wrapper of the fused streaming CUDA kernel (``csrc/megascan.cu``).

Replaces the TPU kernel ``repro/kernels/megascan/megascan.py:_mega_kernel``
together with the per-tile sum of its ``ops.megascan_count_window``: the
kernel adds each tile's counts straight into the caller's (P_total,) int32
accumulator.  Counts, not masks, come out, so the kernel reads the window
once (n / 3.35 TB/s on an H100 SXM) and spends its time on integer work;
its design is described in the CUDA source.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict

import torch

from repro_torch.core.epsm import EPSMC_BETA
from repro_torch.core.packing import FP_MULT, WORD_SALTS, fingerprint_weights
from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR
from repro_torch.kernels.multipattern.multipattern import _cached_bitset, _Salts

TILE = 4096  # positions a block owns; the staged halo is one tile each side
STAGED = 3 * TILE + 16  # the kernel's staged bytes
KINDS = {"a": 0, "b": 1, "c": 2, "x": 3}


class _Weights(ctypes.Structure):
    _fields_ = [("w", ctypes.c_int32 * EPSMC_BETA)]


class _Group(ctypes.Structure):
    """The kernel's ``Group`` record: the group's statics, then pointers to
    its operands on the card."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "kind", "m", "P", "kbits", "col", "k", "use_lut", "stride", "noff", "nw", "W", "pad")] + [
        ("pats", ctypes.c_void_p), ("anchors", ctypes.c_void_p), ("lut", ctypes.c_void_p),
        ("bits", ctypes.c_void_p)]


# (spec, plan identities) -> (plans, device table, operands it points to)
_TABLES: "OrderedDict" = OrderedDict()
_TABLES_MAX = 8


def group_table(plans, spec):
    """The device array of ``_Group`` records of (plans, spec), built once and
    cached.  The entry holds the plans and every tensor the records point to,
    so the pointers stay valid while it is cached."""
    key = (spec, tuple(id(p) for p in plans))
    ent = _TABLES.get(key)
    if ent is not None:
        _TABLES.move_to_end(key)
        return ent[1]
    dev = plans[0].device
    recs = (_Group * len(spec.groups))()
    keep = []
    for rec, plan, g in zip(recs, plans, spec.groups):
        lut = plan.lut_any if g.kind in ("b", "c") else plan.relaxed_lut if g.use_lut else None
        bitset = _cached_bitset(lut) if lut is not None else None
        pats, anchors = plan.patterns.contiguous(), plan.anchors.contiguous()
        bits = plan.lut_bits.contiguous() if g.kind == "c" else None
        keep += [pats, anchors, bitset, bits]
        rec.kind, rec.m, rec.P, rec.kbits, rec.col = KINDS[g.kind], g.m, g.n_patterns, g.kbits, g.col
        rec.k, rec.use_lut, rec.stride, rec.noff = g.k, int(g.use_lut), g.stride, g.noff_used
        rec.nw, rec.W = anchors.shape[1], 0 if bits is None else bits.shape[1]
        rec.pats, rec.anchors = pats.data_ptr(), anchors.data_ptr()
        rec.lut = 0 if bitset is None else bitset.data_ptr()
        rec.bits = 0 if bits is None else bits.data_ptr()
    table = torch.frombuffer(bytearray(bytes(recs)), dtype=torch.uint8).to(dev)
    _TABLES[key] = (tuple(plans), table, keep)
    if len(_TABLES) > _TABLES_MAX:
        _TABLES.popitem(last=False)
    return table


def megascan_cuda(window: torch.Tensor, plans, spec, *, length: int, prev_ov: int,
                  out: torch.Tensor) -> torch.Tensor:
    """Add the counts of one streaming window to ``out`` and return it.

    ``window`` is a contiguous 1-D uint8 CUDA tensor of n bytes, ``length``
    of them valid; an occurrence counts when it starts at s <= length - m
    and ends at s + m - 1 >= prev_ov.  ``out`` is the (P_total,) int32
    accumulator in plan-concatenated order, on the window's card.
    """
    _build.check_u8("megascan", window)
    n = window.shape[0]
    dev = window.device
    if spec.tile != TILE:
        raise ValueError(f"megascan kernel is built for tile {TILE} (spec tile {spec.tile})")
    if not 0 <= length <= n or prev_ov < 0:
        raise ValueError(f"megascan: need 0 <= length <= n and prev_ov >= 0 "
                         f"(length={length}, n={n}, prev_ov={prev_ov})")
    if out.shape != (spec.p_total,) or out.dtype != torch.int32 or out.device != dev:
        raise ValueError(f"megascan: out must be ({spec.p_total},) int32 on {dev}")
    if any(p.device != dev for p in plans):
        raise ValueError(f"megascan: plans must be on {dev}")
    if n == 0:
        return out
    table = group_table(plans, spec)
    w = fingerprint_weights(EPSMC_BETA).tolist()
    salts = _Salts((ctypes.c_uint32 * len(WORD_SALTS))(*(int(s) for s in WORD_SALTS)))
    fn = _build.function("megascan", "megascan_launch",
                         [PTR, I64, I64, I64, PTR, ctypes.c_int, ctypes.c_int, _Weights, _Salts,
                          ctypes.c_uint32, PTR])
    with torch.cuda.device(dev):
        rc = fn(window.data_ptr(), n, int(length), int(prev_ov), table.data_ptr(),
                len(spec.groups), spec.p_total, _Weights((ctypes.c_int32 * EPSMC_BETA)(*w)),
                salts, int(FP_MULT), out.data_ptr(), _build.stream_of(window))
    _build.raise_on_error("megascan", rc)
    megascan_cuda.launches += 1
    return out


megascan_cuda.launches = 0
