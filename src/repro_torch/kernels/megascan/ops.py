"""Megakernel dispatch layer: static group specs, the card's eligibility
rule, and the op that turns (window, plans, k, prev_ov) into one launch.

``build_mega_spec`` walks a plan set ONCE and decides, per length group,
which in-kernel matcher answers it ('a'/'b'/'c' exact, 'x' k-mismatch) and
whether the whole set is eligible for ``csrc/megascan.cu``.  Ineligible sets
return None and the caller (core/stream.py) counts with the acscan and
approx kernels instead: a static decision, logged, never a different result.  A failed build
or launch raises; it is never a reason to fall back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.engine import PatternPlan, _effective_k, compile_patterns
from repro_torch.core.epsm import EPSMC_BETA, _epsmc_stride
from repro_torch.core.packing import PACK
from repro_torch.kernels import _build
from repro_torch.kernels.megascan.megascan import (
    TILE,
    a_table_bits,
    megascan_cuda,
    round16,
    smem_bytes,
)
from repro_torch.kernels.megascan.ref import megascan_count_window_ref

# Shared memory one block of an H100 may use (232,448 bytes of the SM's
# 256 KB): the kernel keeps its staged text and one int32 counter per
# pattern there.
SMEM_BUDGET = 227 * 1024
# Per-group pattern ceiling: 'x' groups and 'c' candidates may walk all P
# rows, so dictionary-scale groups belong on the engine's bounded CSR
# routes, as in the reference.
MEGA_P_MAX = 512
# The int8 accumulator clamp ceiling of the reference kernel.
K_MAX = 127


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Static per-group kernel plan (hashable)."""

    kind: str        # 'a' | 'b' | 'c' | 'x'
    m: int
    n_patterns: int
    kbits: int
    col: int         # first output column (plan-concatenated order)
    k: int = 0       # mismatch budget ('x' only)
    use_lut: bool = False   # 'x': relaxed-LUT gate available
    stride: int = 0  # 'c' only
    noff_used: int = 0  # 'c' only
    abits: int = 0   # 'a' only: rows of the private gram table, 2^abits


@dataclasses.dataclass(frozen=True)
class MegaSpec:
    """Static kernel configuration for one (plans, k) combination."""

    groups: Tuple[GroupSpec, ...]
    p_total: int
    tile: int
    beta: int
    smem_bytes: int   # the kernel's dynamic shared memory per block
    k: Optional[int] = None  # the budget override the spec was built for
    halo_back: int = 0   # staged bytes before the tile: largest 'c' stride - 1, to 16
    halo_fwd: int = 16   # staged bytes after it: largest m - 1 + 3, rounded up to 16


def build_mega_spec(plans: Sequence[PatternPlan], *, k: Optional[int] = None) -> Optional[MegaSpec]:
    """Static spec for the fused kernel, or None when the set is ineligible.

    The card's rule: the reference's halo and verify rules, with its VMEM
    budget replaced by what the CUDA kernel keeps in shared memory.

      * every group needs m <= 4096 - 3 and EPSMc groups stride + m <=
        4096 (the halo rules of the reference's prev|cur|next tiles; the
        kernel stages only the halo the set needs: back the largest 'c'
        stride - 1, forward the largest m - 1 + 3, each rounded up to 16);
        bucketed EPSMc plans (CSR payloads, no lut_bits) are ineligible;
      * at most MEGA_P_MAX = 512 patterns a group;
      * k <= 127 (the reference's int8 clamp ceiling); k > 0 groups ('x')
        use the relaxed-LUT gate only when the plan was compiled for >= k
        and m >= 4;
      * the staged bytes plus one int32 counter per pattern fit the 227 KB
        of shared memory a block may use.  The 'a' groups' private tables
        are read from global memory, so they never make a set ineligible.
    """
    if not plans:
        return None
    groups = []
    col = 0
    beta = EPSMC_BETA
    for plan in plans:
        kk = _effective_k(plan, k)
        P, m = plan.n_patterns, plan.m
        if m > TILE - PACK + 1 or P > MEGA_P_MAX:
            return None
        if plan.regime == "c" and kk == 0 and plan.lut_bits is None:
            return None  # bucketed EPSMc: CSR payloads, not the lut_bits bitmask
        if kk > 0:
            if kk > K_MAX:
                return None
            use_lut = plan.relaxed_lut is not None and kk <= plan.k and m >= PACK
            groups.append(GroupSpec(kind="x", m=m, n_patterns=P, kbits=plan.kbits, col=col,
                                    k=kk, use_lut=use_lut))
        elif plan.regime == "a":
            groups.append(GroupSpec(kind="a", m=m, n_patterns=P, kbits=0, col=col,
                                    abits=a_table_bits(P)))
        elif plan.regime == "b":
            groups.append(GroupSpec(kind="b", m=m, n_patterns=P, kbits=plan.kbits, col=col))
        else:
            stride = _epsmc_stride(m, beta)
            if stride + m > TILE:
                return None
            groups.append(GroupSpec(kind="c", m=m, n_patterns=P, kbits=plan.kbits, col=col,
                                    stride=stride, noff_used=min(stride, m - beta + 1)))
        col += P
    back = round16(max([g.stride - 1 for g in groups if g.kind == "c"], default=0))
    fwd = round16(max(g.m for g in groups) - 1 + PACK - 1)
    smem = smem_bytes(back, fwd, col)
    if smem > SMEM_BUDGET:
        return None
    return MegaSpec(groups=tuple(groups), p_total=col, tile=TILE, beta=beta, smem_bytes=smem,
                    k=k, halo_back=back, halo_fwd=fwd)


def megascan_plans(plans: Sequence[PatternPlan]) -> Tuple[PatternPlan, ...]:
    """The same patterns as a plan set ``build_mega_spec`` can take: each
    length group compiled again flat (no CSR buckets, no automaton) at the
    budget it was compiled for, in slices of at most MEGA_P_MAX patterns.
    Each slice keeps the original indices in ``ids``, so ``plan_order``
    still maps rows back.  Plans that are flat and small already are kept
    as they are."""
    out = []
    for plan in plans:
        flat = plan.bbits == 0 and plan.automaton is None and (
            plan.regime != "c" or plan.lut_bits is not None)
        if flat and plan.n_patterns <= MEGA_P_MAX:
            out.append(plan)
            continue
        rows = plan.patterns.cpu().numpy()
        for lo in range(0, len(rows), MEGA_P_MAX):
            (part,) = compile_patterns(list(rows[lo : lo + MEGA_P_MAX]), k=plan.k, bucket=False,
                                       automaton=False, device=plan.device)
            out.append(dataclasses.replace(part, ids=plan.ids[lo : lo + MEGA_P_MAX]))
    return tuple(out)


def megascan_count_window(
    window: torch.Tensor,
    plans: Sequence[PatternPlan],
    spec: MegaSpec,
    *,
    length: Optional[int] = None,
    prev_ov: int = 0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(P_total,) int32 counts of one streaming window through the fused
    kernel — plan-concatenated order, bit-identical to the engine's counts
    over ``build_index(window, [length])`` with ``end_min=prev_ov`` in plain
    PyTorch (``megascan_count_window_ref``).

    The counts are added into ``out`` when given (the stream's device
    accumulator), else into a new zero tensor.  A CUDA window launches the
    kernel; a CPU window runs the plain version.
    """
    if window.ndim != 1 or window.dtype != torch.uint8:
        raise ValueError("megascan: window must be a 1-D uint8 tensor")
    n = window.shape[0]
    length = n if length is None else int(length)
    if out is None:
        out = torch.zeros((spec.p_total,), dtype=torch.int32, device=window.device)

    def kernel(window):
        return megascan_cuda(window.contiguous(), plans, spec, length=length,
                             prev_ov=int(prev_ov), out=out)

    def plain(window):
        out.add_(megascan_count_window_ref(window, plans, k=spec.k, length=length,
                                           prev_ov=int(prev_ov)))
        return out

    return _build.on_device(window, kernel, plain)(window)
