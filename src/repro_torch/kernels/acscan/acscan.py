"""Launch wrappers of the Aho-Corasick transition-scan CUDA kernel
(``csrc/acscan.cu``), one for each of its two modes.

Replaces the TPU kernel ``repro/kernels/acscan/acscan.py:_ac_kernel``
together with the class-window build around it (``_segment_classes``): the
kernel reads the text bytes and maps them to classes itself.  The ``states``
mode writes the int32 state after each byte; the ``counts`` mode writes
the (B, n_term) histogram of terminal states, with no state array in device
memory.  Its time goes to a chain of dependent table loads per lane; its
bounds and its design are described in the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR

# Smallest segment width of the kernel: 132 positions a lane, ~10 % warm-up
# at max_m = 15.
SEG_MIN = 132
_TABLE = {None: -1, "global": 0, "shared": 1}
_HIST = {None: -1, "shared": 1, "global": 2}
_CONFIG = ("table_shared", "mode", "lanes", "threads", "grid", "smem_bytes", "blocks_per_sm",
           "entry_bytes", "one_block")
_ARGTYPES = [PTR, I64, I64, PTR, PTR, I64, I64, I64, I64, I64, ctypes.c_int, I64, PTR, I64,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, PTR, PTR]
_ENTRY_BYTES = {torch.uint16: 2, torch.int32: 4}


def kernel_seg(ov: int) -> int:
    """The kernel's segment width for a warm-up of ``ov`` bytes: the
    smallest seg >= max(SEG_MIN, ov) with seg / 4 odd, so a lane's warm-up
    never costs more than its owned positions."""
    s = -(-max(SEG_MIN, int(ov)) // 4) * 4
    return s + 4 if (s // 4) % 2 == 0 else s


def _check(text, classes, table, n_classes, max_m, _table, _hist, _lanes, _threads):
    if text.ndim != 2 or text.dtype != torch.uint8 or not text.is_contiguous() or not text.is_cuda:
        raise ValueError("acscan: text must be a contiguous (B, n) uint8 CUDA tensor")
    dev = text.device
    if classes.shape != (256,) or classes.dtype != torch.int32 or classes.device != dev:
        raise ValueError(f"acscan: classes must be (256,) int32 on {dev}")
    if (table.ndim != 1 or table.dtype not in _ENTRY_BYTES or table.device != dev
            or n_classes < 1 or table.numel() % n_classes):
        raise ValueError(f"acscan: table must be (n_states * {n_classes},) uint16 or int32 "
                         f"on {dev}")
    if max_m < 1:
        raise ValueError("acscan: max_m must be >= 1")
    if _table not in _TABLE or _hist not in _HIST:
        raise ValueError("acscan: _table and _hist must be None, 'shared' or 'global'")
    if _lanes not in (None, 1, 4) or not (_threads is None or (32 <= _threads <= 1024
                                                                and _threads % 32 == 0)):
        raise ValueError("acscan: _lanes must be 1 or 4, _threads 32..1024 in steps of 32")


def _launch(text, classes, table, n_classes, max_m, seg, out, counts, n_term, lengths, end_min,
            _table, _hist, _lanes, _threads, _one_block):
    """One launch; returns the launch's choices (``config``)."""
    if text.data_ptr() % 16:
        text = text.clone()  # the kernel reads the text in aligned 16-byte words
    B, n = text.shape
    classes, table = classes.contiguous(), table.contiguous()
    config = (ctypes.c_int * len(_CONFIG))()
    fn = _build.function("acscan", "acscan_launch", _ARGTYPES)
    with torch.cuda.device(text.device):
        rc = fn(text.data_ptr(), B, n, classes.data_ptr(), table.data_ptr(),
                _ENTRY_BYTES[table.dtype], table.numel(), int(n_classes), int(max_m) - 1, seg,
                int(counts), int(n_term), None if lengths is None else lengths.data_ptr(),
                int(end_min), _TABLE[_table], _HIST[_hist], -1 if _lanes is None else int(_lanes),
                -1 if _threads is None else int(_threads),
                -1 if _one_block is None else int(_one_block), out.data_ptr(),
                ctypes.addressof(config), _build.stream_of(text))
    _build.raise_on_error("acscan", rc)
    return dict(zip(_CONFIG, list(config)), seg=seg)


def acscan_cuda(text: torch.Tensor, classes: torch.Tensor, table: torch.Tensor, n_classes: int,
                max_m: int, *, seg: Optional[int] = None, _table: Optional[str] = None,
                _lanes: Optional[int] = None, _threads: Optional[int] = None,
                _one_block: Optional[bool] = None) -> torch.Tensor:
    """The ``states`` mode: int32 (B, n), the automaton state after each byte
    of each row, in the ids of ``table``.

    ``text`` is a contiguous (B, n) uint8 CUDA tensor, ``classes`` the
    (256,) int32 class map and ``table`` the flat (n_states * n_classes,)
    uint16 or int32 transition table (``AutomatonPlan.delta``, or its uint16
    copy from ``core.automaton.kernel_tables``); ``max_m`` the longest
    pattern.  ``seg`` defaults to :func:`kernel_seg`.  The launcher places
    the table and picks the block; its choices are in ``acscan_cuda.config``.
    ``_table`` ("shared" or "global"), ``_lanes`` (1 or 4 lanes a thread),
    ``_threads`` and ``_one_block`` (True: one block an SM, the rest of its
    memory left to L1) are test hooks that force a variant, so that each one
    can be held against the plain version.
    """
    _check(text, classes, table, n_classes, max_m, _table, None, _lanes, _threads)
    seg = kernel_seg(int(max_m) - 1) if seg is None else int(seg)
    if seg < 1:
        raise ValueError("acscan: seg must be >= 1")
    B, n = text.shape
    out = torch.empty((B, n), dtype=torch.int32, device=text.device)
    if out.numel() == 0:
        return out
    config = _launch(text, classes, table, n_classes, max_m, seg, out, False, 0, None, 0,
                     _table, None, _lanes, _threads, _one_block)
    _build.count_launch(acscan_cuda)
    acscan_cuda.config = config
    return out


def acscan_counts_cuda(text: torch.Tensor, classes: torch.Tensor, table: torch.Tensor,
                       n_classes: int, n_term: int, max_m: int, lengths: torch.Tensor, *,
                       end_min: Optional[int] = None, seg: Optional[int] = None,
                       _table: Optional[str] = None, _hist: Optional[str] = None,
                       _lanes: Optional[int] = None, _threads: Optional[int] = None,
                       _one_block: Optional[bool] = None) -> torch.Tensor:
    """The ``counts`` mode: int32 (B, n_term), how often each terminal state
    is the state after a byte at a position i with end_min <= i <
    lengths[b] of row b.

    ``table`` is a private table of the plan (``kernel_tables(plan).counts``)
    whose terminal states are 1..n_term and root 0; column t counts state
    1 + t.  ``lengths`` is a (B,) integer tensor on the text's card.  No
    state array is written.  ``_hist`` ("shared" or "global") forces where
    the histogram is summed, the other hooks are those of
    :func:`acscan_cuda`; the choices of the last launch are in
    ``acscan_counts_cuda.config``.
    """
    _check(text, classes, table, n_classes, max_m, _table, _hist, _lanes, _threads)
    B, n = text.shape
    if n_term < 1:
        raise ValueError("acscan: n_term must be >= 1")
    if table.numel() // n_classes <= n_term:
        raise ValueError("acscan: the table must hold the root and the n_term terminal states")
    lengths = torch.as_tensor(lengths, device=text.device).to(torch.int64).reshape(B).contiguous()
    seg = kernel_seg(int(max_m) - 1) if seg is None else int(seg)
    if seg < 1:
        raise ValueError("acscan: seg must be >= 1")
    out = torch.zeros((B, int(n_term)), dtype=torch.int32, device=text.device)
    if B == 0 or n == 0:
        return out
    config = _launch(text, classes, table, n_classes, max_m, seg, out, True, n_term, lengths,
                     0 if end_min is None else max(0, int(end_min)), _table, _hist, _lanes,
                     _threads, _one_block)
    _build.count_launch(acscan_counts_cuda)
    acscan_counts_cuda.config = config
    return out


acscan_cuda.launches = 0
acscan_cuda.config = None
acscan_counts_cuda.launches = 0
acscan_counts_cuda.config = None
