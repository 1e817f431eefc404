"""Public k-mismatch ops: the CUDA kernel on the card, its plain version on
the CPU.  The relaxed fingerprint LUT comes from the engine's plan compiler,
so kernel and engine share one gate.

The kernel's path is one static rule, ``use_pieces(m, k, P)``: the
pigeonhole filter (k + 1 pieces, each probed in a per-piece pattern-id
table) when m >= 4 (k + 1), the tables fit ``PIECE_TABLE_CAP`` and the
block's shared memory fits (``pieces_smem_bytes``); the first-word path
(relaxed-LUT warp gate, first packed word within k) for shorter pieces,
k >= m, larger tables and, past 32 patterns, more than 27 pieces.  Both
give the same masks."""

from __future__ import annotations

import torch

from repro_torch.core.engine import compile_patterns_cached
from repro_torch.core.packing import as_u8
from repro_torch.kernels import _build
from repro_torch.kernels.approx.approx import PIECE_TABLE_CAP, approx_cuda, use_pieces
from repro_torch.kernels.approx.ref import approx_batched_ref

# The reference op's bound on m (its int8 accumulator's safety argument,
# DESIGN.md §8); the CUDA kernel counts in int32 and takes any m.
MAX_M = 127


def approx_batched(texts, patterns, k: int, lengths=None, *, device=None) -> torch.Tensor:
    """(B, n) texts x (P, m) same-length patterns -> bool (B, P, n) masks of
    positions matching under <= k mismatches; 1 <= m <= 127.

    ``lengths`` gives per-row true lengths (matches never start in padding).
    Host inputs go to ``device`` (default: the card).  On the card the
    kernel takes the pigeonhole filter when ``use_pieces(m, k, P)``; on the
    first-word path the relaxed LUT gate is used when the plan compiled for
    this k carries one (m >= 4, k <= 2, unsaturated expansion), otherwise
    every warp verifies.
    """
    t = as_u8(texts, device)
    if t.ndim == 1:
        t = t[None, :]
    ps = as_u8(patterns, t.device)
    if ps.ndim != 2:
        raise ValueError("patterns must be (P, m)")
    if not 1 <= ps.shape[1] <= MAX_M:
        raise ValueError(f"approx kernel requires 1 <= m <= {MAX_M}")
    if k < 0:
        raise ValueError("mismatch budget k must be >= 0")
    B, n = t.shape
    if lengths is None:
        lengths = torch.full((B,), n, dtype=torch.int32, device=t.device)
    lengths = torch.as_tensor(lengths).to(device=t.device, dtype=torch.int32)
    if n == 0:
        return torch.zeros((B, ps.shape[0], 0), dtype=torch.bool, device=t.device)
    # one same-length group, so the plan keeps the input's row order; the
    # op reads only the patterns, anchors and relaxed LUT (no automaton)
    plans = compile_patterns_cached(list(ps.cpu().numpy()), k=int(k), automaton=False,
                                    device=t.device)
    assert len(plans) == 1 and plans[0].ids == tuple(range(ps.shape[0]))
    plan = plans[0]
    lut = plan.relaxed_lut if plan.relaxed_lut is not None and int(k) <= plan.k else None

    def kernel(t, ps, k, lengths):
        return approx_cuda(t.contiguous(), plan.patterns, plan.anchors, k, lut,
                           kbits=plan.kbits, lengths=lengths)

    return _build.on_device(t, kernel, approx_batched_ref)(t, ps, int(k), lengths)


def approx_multipattern(text, patterns, k: int, *, device=None) -> torch.Tensor:
    """(P, m) pattern stack -> bool (P, n) k-mismatch match-start masks for
    one text."""
    t = as_u8(text, device)
    if t.ndim != 1:
        raise ValueError("text must be 1-D; use approx_batched")
    ps = as_u8(patterns, t.device)
    if ps.ndim != 2:
        raise ValueError("patterns must be (P, m)")
    if t.shape[0] == 0:
        return torch.zeros((ps.shape[0], 0), dtype=torch.bool, device=t.device)
    return approx_batched(t[None, :], ps, k)[0]
