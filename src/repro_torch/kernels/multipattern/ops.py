"""Public multi-pattern ops: the CUDA kernel on the card, its plain version
on the CPU.  The union fingerprint LUT comes from the engine's plan compiler,
so kernel and engine share one fingerprint."""

from __future__ import annotations

import torch

from repro_torch.core.engine import compile_patterns_cached
from repro_torch.core.packing import PACK, as_u8
from repro_torch.kernels import _build
from repro_torch.kernels.multipattern.multipattern import TILE, multipattern_cuda
from repro_torch.kernels.multipattern.ref import multipattern_batched_ref


def multipattern_batched(texts, patterns, lengths=None, *, device=None) -> torch.Tensor:
    """(B, n) texts x (P, m) same-length patterns -> bool (B, P, n); 4 <= m <= 4096.

    ``lengths`` gives per-row true lengths (matches never start in padding).
    Host inputs go to ``device`` (default: the card); a tensor stays where
    it is.  The LUT gate is used for EPSMb plans (m < 16) only: for m >= 16
    the plan's LUT is keyed by block fingerprints the kernel does not compute.
    """
    t = as_u8(texts, device)
    if t.ndim == 1:
        t = t[None, :]
    ps = as_u8(patterns, t.device)
    if ps.ndim != 2:
        raise ValueError("patterns must be (P, m)")
    if ps.shape[1] < PACK:
        raise ValueError("multipattern kernel requires m >= 4")
    if ps.shape[1] > TILE:
        raise ValueError("pattern longer than tile")
    B, n = t.shape
    if lengths is None:
        lengths = torch.full((B,), n, dtype=torch.int32, device=t.device)
    lengths = torch.as_tensor(lengths).to(device=t.device, dtype=torch.int32)
    if n == 0:
        return torch.zeros((B, ps.shape[0], 0), dtype=torch.bool, device=t.device)
    # one same-length group, so the plan keeps the input's row order.  The
    # op reads only the LUT and the anchors, so no automaton is compiled
    # (the reference builds one here at 1024+ patterns and leaves it unused).
    plans = compile_patterns_cached(list(ps.cpu().numpy()), automaton=False, device=t.device)
    assert len(plans) == 1 and plans[0].ids == tuple(range(ps.shape[0]))
    plan = plans[0]

    def kernel(t, ps, lengths):
        return multipattern_cuda(t.contiguous(), plan.anchors, plan.m, plan.lut_any,
                                 kbits=plan.kbits, use_lut=plan.regime == "b", lengths=lengths)

    return _build.on_device(t, kernel, multipattern_batched_ref)(t, ps, lengths)


def multipattern(text, patterns, *, device=None) -> torch.Tensor:
    """(P, m) pattern stack -> bool (P, n) match-start masks for one text."""
    t = as_u8(text, device)
    if t.ndim != 1:
        raise ValueError("text must be 1-D; use multipattern_batched")
    ps = as_u8(patterns, t.device)
    if ps.ndim != 2:
        raise ValueError("patterns must be (P, m)")
    if t.shape[0] == 0:
        return torch.zeros((ps.shape[0], 0), dtype=torch.bool, device=t.device)
    return multipattern_batched(t[None, :], ps)[0]
