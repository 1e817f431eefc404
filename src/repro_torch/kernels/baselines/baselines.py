"""Launch wrappers of the baselines' segmented device loops
(``csrc/baselines.cu``): Shift-Or, KMP, HASH3 and BNDM, one thread a
segment of ``seg`` bytes.

Replaces no Pallas kernel: these are the port's counterpart of the
reference's sequential device loops (``repro/core/baselines.py``: the
``lax.scan`` of ``shift_or`` and ``kmp_dfa``, the ``lax.while_loop`` of
``hash3`` and ``bndm``).  Each wrapper counts its own launches.  The tables
come from the host, built as the reference builds them; the seam rule, the
bounds and the design are described in the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I64, PTR

_ALGO = {"shift_or": 0, "kmp_dfa": 1, "hash3": 2, "bndm": 3}
_ARGTYPES = [ctypes.c_int, PTR, I64, PTR, I64, PTR, I64, PTR]


def _launch(name: str, wrapper, text: torch.Tensor, pattern: torch.Tensor, table: torch.Tensor,
            seg: int) -> torch.Tensor:
    _build.check_u8(name, text, pattern)
    if table.dtype != torch.int32 or table.device != text.device or not table.is_contiguous():
        raise ValueError(f"{name}: the table must be a contiguous int32 tensor on {text.device}")
    n, m = text.shape[0], pattern.shape[0]
    if not 1 <= m <= n or seg < 1:
        raise ValueError(f"{name} kernel requires 1 <= m <= n and seg >= 1 (m={m}, n={n}, seg={seg})")
    out = torch.zeros(n, dtype=torch.bool, device=text.device)
    fn = _build.function("baselines", "baselines_launch", _ARGTYPES)
    with torch.cuda.device(text.device):
        rc = fn(_ALGO[name], text.data_ptr(), n, pattern.data_ptr(), m, table.data_ptr(),
                int(seg), out.data_ptr(), _build.stream_of(text))
    _build.raise_on_error("baselines", rc)
    _build.count_launch(wrapper)
    return out


def shift_or_cuda(text, pattern, table, seg: int) -> torch.Tensor:
    """Shift-Or start mask; ``table`` is B[256] as int32 bits, m <= 32."""
    if pattern.shape[0] > 32 or table.shape != (256,):
        raise ValueError("shift_or kernel: m <= 32 and a (256,) table")
    return _launch("shift_or", shift_or_cuda, text, pattern, table, seg)


def kmp_dfa_cuda(text, pattern, table, seg: int) -> torch.Tensor:
    """KMP start mask; ``table`` is the (m + 1) x 256 int32 DFA, flat."""
    if table.shape != ((pattern.shape[0] + 1) * 256,):
        raise ValueError("kmp_dfa kernel: the table must be the flat (m + 1) x 256 DFA")
    return _launch("kmp_dfa", kmp_dfa_cuda, text, pattern, table, seg)


def hash3_cuda(text, pattern, table, seg: int) -> torch.Tensor:
    """HASH3 start mask; ``table`` is the 4096-entry shift table, m >= 3."""
    if pattern.shape[0] < 3 or table.shape != (4096,):
        raise ValueError("hash3 kernel: m >= 3 and a (4096,) shift table")
    return _launch("hash3", hash3_cuda, text, pattern, table, seg)


def bndm_cuda(text, pattern, table, seg: int) -> torch.Tensor:
    """BNDM start mask; ``table`` is B[256] as int32 bits, m <= 31."""
    if pattern.shape[0] > 31 or table.shape != (256,):
        raise ValueError("bndm kernel: m <= 31 and a (256,) table")
    return _launch("bndm", bndm_cuda, text, pattern, table, seg)


for _w in (shift_or_cuda, kmp_dfa_cuda, hash3_cuda, bndm_cuda):
    _w.launches = 0
