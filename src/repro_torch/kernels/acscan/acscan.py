"""Launch wrapper of the Aho-Corasick transition-scan CUDA kernel
(``csrc/acscan.cu``).

Replaces the TPU kernel ``repro/kernels/acscan/acscan.py:_ac_kernel``
together with the class-window build around it (``_segment_classes``): the
kernel reads the text bytes and maps them to classes itself.  Its time goes
to a chain of dependent table loads per lane; its bound (bytes: the text,
the states and the table once, over 3.35 TB/s on an H100 SXM) and its design
are described in the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR

# Smallest segment width of the kernel: 132 positions a lane (132 / 4 odd
# keeps a warp's staged reads on distinct shared-memory banks), ~10 %
# warm-up at max_m = 15.
SEG_MIN = 132
_PLACEMENT = {None: -1, "global": 0, "shared": 1}


def kernel_seg(ov: int) -> int:
    """The kernel's segment width for a warm-up of ``ov`` bytes: the
    smallest seg >= max(SEG_MIN, ov) with seg / 4 odd, so a lane's warm-up
    never costs more than its owned positions."""
    s = -(-max(SEG_MIN, int(ov)) // 4) * 4
    return s + 4 if (s // 4) % 2 == 0 else s


def acscan_cuda(text: torch.Tensor, classes: torch.Tensor, delta: torch.Tensor, n_classes: int,
                max_m: int, *, seg: Optional[int] = None, _table: Optional[str] = None,
                _staged: Optional[bool] = None) -> torch.Tensor:
    """int32 (B, n): the automaton state after each byte of each row.

    ``text`` is a contiguous (B, n) uint8 CUDA tensor, ``classes`` the
    (256,) int32 class map and ``delta`` the flat (n_states * n_classes,)
    int32 table of one AutomatonPlan; ``max_m`` its longest pattern.
    ``seg`` defaults to :func:`kernel_seg`.  The launcher places the table
    and the text span itself; the placement of the last launch is in
    ``acscan_cuda.config``.  ``_table`` ("shared" or "global") and
    ``_staged`` are test hooks that force a placement, so that each one can
    be held against the plain version.
    """
    if text.ndim != 2 or text.dtype != torch.uint8 or not text.is_contiguous() or not text.is_cuda:
        raise ValueError("acscan: text must be a contiguous (B, n) uint8 CUDA tensor")
    B, n = text.shape
    dev = text.device
    if classes.shape != (256,) or classes.dtype != torch.int32 or classes.device != dev:
        raise ValueError(f"acscan: classes must be (256,) int32 on {dev}")
    if (delta.ndim != 1 or delta.dtype != torch.int32 or delta.device != dev
            or n_classes < 1 or delta.numel() % n_classes):
        raise ValueError(f"acscan: delta must be (n_states * {n_classes},) int32 on {dev}")
    if max_m < 1:
        raise ValueError("acscan: max_m must be >= 1")
    if _table not in _PLACEMENT:
        raise ValueError("acscan: _table must be None, 'shared' or 'global'")
    ov = int(max_m) - 1
    seg = kernel_seg(ov) if seg is None else int(seg)
    if seg < 1:
        raise ValueError("acscan: seg must be >= 1")
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    classes, delta = classes.contiguous(), delta.contiguous()
    config = (ctypes.c_int * 6)()
    fn = _build.function("acscan", "acscan_launch",
                         [PTR, I64, I64, PTR, PTR, I64, I64, I64, I64, ctypes.c_int,
                          ctypes.c_int, PTR, PTR])
    with torch.cuda.device(dev):
        rc = fn(text.data_ptr(), B, n, classes.data_ptr(), delta.data_ptr(), delta.numel(),
                int(n_classes), ov, seg, _PLACEMENT[_table],
                -1 if _staged is None else int(_staged), out.data_ptr(),
                ctypes.addressof(config), _build.stream_of(text))
    _build.raise_on_error("acscan", rc)
    acscan_cuda.launches += 1
    acscan_cuda.config = dict(zip(("table_shared", "staged", "lanes", "grid", "smem_bytes",
                                   "blocks_per_sm"), list(config)), seg=seg)
    return out


acscan_cuda.launches = 0
acscan_cuda.config = None
