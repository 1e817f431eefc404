"""Launch wrapper of the fused streaming CUDA kernel (``csrc/megascan.cu``).

Replaces the TPU kernel ``repro/kernels/megascan/megascan.py:_mega_kernel``
together with the per-tile sum of its ``ops.megascan_count_window``: the
kernel adds each tile's counts straight into the caller's (P_total,) int32
accumulator.  Counts, not masks, come out, so the kernel reads the window
once (n / 3.35 TB/s on an H100 SXM) and spends its time on integer work;
its design is described in the CUDA source.

Everything a launch needs besides the window is built once per (spec,
plans) and cached (``group_table``): the device array of Group records,
the private pattern-id tables of the 'a' and 'b' groups, and the launch's
static arguments.  A call only checks its window and launches.  The cache
is locked (the lanes of a sharded scan launch from several threads) and
never drops an entry that someone still holds: a ``StreamScanner`` on the
card keeps its entry (``kernel_entry``) for its whole life, so no launch of
its reads tables that were freed under it.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import _np_window_fingerprint
from repro_torch.core.epsm import EPSMC_BETA
from repro_torch.core.packing import FP_MULT, fingerprint_weights
from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR
from repro_torch.kernels.multipattern.multipattern import SALTS, _cached_bitset, _Salts

TILE = 4096  # positions a block owns
SLACK = 16   # staged bytes past the forward halo
KINDS = {"a": 0, "b": 1, "c": 2, "x": 3}
# Bytes an 'a' group's private table may take: 2^abits rows of W words
A_TABLE_BYTES = 8192


def round16(x: int) -> int:
    return -(-x // 16) * 16


def staged_bytes(back: int, fwd: int) -> int:
    """Text bytes a block stages: the back halo, the tile, the forward halo
    and the slack (``mega_staged`` in the CUDA source)."""
    return back + TILE + fwd + SLACK


def smem_bytes(back: int, fwd: int, p_total: int) -> int:
    """The kernel's dynamic shared memory per block: the staged bytes and one
    int32 counter per pattern (``megascan_smem_bytes`` in the CUDA source)."""
    return staged_bytes(back, fwd) + 4 * p_total


def a_table_bits(P: int) -> int:
    """Rows of an 'a' group's private table, as a power of two: about eight
    per pattern, at most A_TABLE_BYTES of W = ceil(P/32) words a row."""
    W = -(-P // 32)
    return min(P.bit_length() + 3, (A_TABLE_BYTES // (4 * W)).bit_length() - 1)


def _pid_bitmask(rows: np.ndarray, nbits: int) -> np.ndarray:
    """(2^nbits, ceil(P/32)) uint32: bit p % 32 of word p // 32 of row
    rows[p] is set for every pattern p."""
    P = rows.shape[0]
    table = np.zeros((1 << nbits, -(-P // 32)), np.uint32)
    pid = np.arange(P)
    np.bitwise_or.at(table, (rows, pid // 32), (np.uint32(1) << (pid % 32).astype(np.uint32)))
    return table


def a_words_of(pats: np.ndarray) -> np.ndarray:
    """(P, m < 4) uint8 -> (P,) uint32 little-endian packed patterns: the
    masked gram a window must equal."""
    w = np.zeros(pats.shape[0], np.uint32)
    for j in range(pats.shape[1]):
        w |= pats[:, j].astype(np.uint32) << np.uint32(8 * j)
    return w


def a_hash(x: np.ndarray, abits: int) -> np.ndarray:
    """Row of masked grams x (uint32) in an 'a' table: FP_MULT multiply-shift."""
    return ((x.astype(np.uint32) * FP_MULT) >> np.uint32(32 - abits)).astype(np.int64)


def a_table(pats: np.ndarray, abits: int) -> np.ndarray:
    """The private table of an 'a' plan: masked gram hash -> pattern ids."""
    return _pid_bitmask(a_hash(a_words_of(pats), abits), abits)


def b_table(anchors: np.ndarray, kbits: int) -> np.ndarray:
    """The private table of a 'b' plan: window fingerprint -> pattern ids
    (read by plans whose fingerprints are not distinct)."""
    rows = _np_window_fingerprint(anchors.view(np.uint32), kbits).astype(np.int64)
    return _pid_bitmask(rows, kbits)


class _Weights(ctypes.Structure):
    _fields_ = [("w", ctypes.c_int32 * EPSMC_BETA)]


_WEIGHTS = _Weights((ctypes.c_int32 * EPSMC_BETA)(*fingerprint_weights(EPSMC_BETA).tolist()))


class _Group(ctypes.Structure):
    """The kernel's ``Group`` record: the group's statics, then pointers to
    its operands on the card."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "kind", "m", "P", "kbits", "col", "k", "use_lut", "stride", "noff", "nw", "W", "abits")] + [
        ("pats", ctypes.c_void_p), ("anchors", ctypes.c_void_p), ("lut", ctypes.c_void_p),
        ("bits", ctypes.c_void_p), ("pid", ctypes.c_void_p)]


_ARGTYPES = [PTR, I64, I64, I64, PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _Weights, _Salts, ctypes.c_uint32, PTR]


class _Entry:
    """What a launch of (plans, spec) reads besides its window."""

    __slots__ = ("spec", "plans", "device", "table", "keep", "args", "__weakref__")

    def __init__(self, spec, plans: tuple, device: torch.device, table: torch.Tensor,
                 keep: list, args: tuple):
        self.spec = spec
        self.plans = plans
        self.device = device
        self.table = table  # the Group records on the card
        self.keep = keep    # every tensor the records point to
        self.args = args    # the launch's arguments after the three window ones


# (id(spec), plan identities) -> _Entry.  An entry holds its spec and plans,
# so their ids are not reused while it lives.  _LIVE finds every entry that
# anyone holds; _TABLES keeps the most recent ones alive between scanners.
_LOCK = threading.Lock()
_LIVE: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_TABLES: "OrderedDict" = OrderedDict()
_TABLES_MAX = 8


def private_table(plan, g) -> Optional[np.ndarray]:
    """The private pattern-id table the kernel reads for group ``g`` of
    ``plan``: the gram table of an 'a' group, the fingerprint table of a
    'b' group without ``lut_pid``; None for the others."""
    if g.kind == "a":
        return a_table(plan.patterns.cpu().numpy(), g.abits)
    if g.kind == "b" and plan.lut_pid is None:
        return b_table(plan.anchors.cpu().numpy(), g.kbits)
    return None


def kernel_entry(plans, spec) -> _Entry:
    """The cached launch entry of (plans, spec), built on first use.  Whoever
    keeps the returned object keeps its tables on the card: the cache never
    rebuilds or frees an entry that is still held."""
    key = (id(spec), *map(id, plans))
    with _LOCK:
        ent = _LIVE.get(key)
        if ent is None:
            ent = _LIVE[key] = _build_entry(plans, spec)
        _TABLES[key] = ent
        _TABLES.move_to_end(key)
        if len(_TABLES) > _TABLES_MAX:
            _TABLES.popitem(last=False)
        return ent


def _build_entry(plans, spec) -> _Entry:
    if spec.tile != TILE:
        raise ValueError(f"megascan kernel is built for tile {TILE} (spec tile {spec.tile})")
    dev = plans[0].device
    if any(p.device != dev for p in plans):
        raise ValueError("megascan: every plan must be on one device")
    recs = (_Group * len(spec.groups))()
    keep = []
    for rec, plan, g in zip(recs, plans, spec.groups):
        lut = plan.lut_any if g.kind in ("b", "c") else plan.relaxed_lut if g.use_lut else None
        bitset = _cached_bitset(lut) if lut is not None else None
        pats, anchors = plan.patterns.contiguous(), plan.anchors.contiguous()
        bits = plan.lut_bits.contiguous() if g.kind == "c" else None
        private = private_table(plan, g)
        if private is not None:
            bits = torch.from_numpy(private.view(np.int32)).to(dev)
        if g.kind == "a":
            words = a_words_of(plan.patterns.cpu().numpy())
            anchors = torch.from_numpy(words.view(np.int32)).to(dev)
        pid = plan.lut_pid.contiguous() if g.kind == "b" and plan.lut_pid is not None else None
        keep += [pats, anchors, bitset, bits, pid]
        rec.kind, rec.m, rec.P, rec.kbits, rec.col = KINDS[g.kind], g.m, g.n_patterns, g.kbits, g.col
        rec.k, rec.use_lut, rec.stride, rec.noff = g.k, int(g.use_lut), g.stride, g.noff_used
        rec.nw, rec.W = plan.anchors.shape[1], 0 if bits is None else bits.shape[1]
        rec.abits = g.abits
        rec.pats, rec.anchors = pats.data_ptr(), anchors.data_ptr()
        rec.lut = 0 if bitset is None else bitset.data_ptr()
        rec.bits = 0 if bits is None else bits.data_ptr()
        rec.pid = 0 if pid is None else pid.data_ptr()
    table = torch.frombuffer(bytearray(bytes(recs)), dtype=torch.uint8).to(dev)
    args = (table.data_ptr(), len(spec.groups), spec.p_total, spec.halo_back, spec.halo_fwd,
            _WEIGHTS, SALTS, int(FP_MULT))
    return _Entry(spec, tuple(plans), dev, table, keep, args)


def group_table(plans, spec) -> torch.Tensor:
    """The device array of ``_Group`` records of (plans, spec), built once and
    cached with the private tables and operands its pointers reach."""
    return kernel_entry(plans, spec).table


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
    if not 0 <= length <= n or prev_ov < 0:
        raise ValueError(f"megascan: need 0 <= length <= n and prev_ov >= 0 "
                         f"(length={length}, n={n}, prev_ov={prev_ov})")
    if out.shape != (spec.p_total,) or out.dtype != torch.int32 or out.device != dev:
        raise ValueError(f"megascan: out must be ({spec.p_total},) int32 on {dev}")
    ent = kernel_entry(plans, spec)
    if ent.device != dev:
        raise ValueError(f"megascan: plans must be on {dev}")
    if n == 0:
        return out
    fn = _build.function("megascan", "megascan_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(window.data_ptr(), n, int(length), int(prev_ov), *ent.args, out.data_ptr(),
                _build.stream_of(window))
    _build.raise_on_error("megascan", rc)
    _build.count_launch(megascan_cuda)
    return out


megascan_cuda.launches = 0
