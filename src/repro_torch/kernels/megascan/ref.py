"""Plain version of the fused megakernel.

The per-group engine IS the specification: one window's fused kernel counts
must equal the engine's counts over the same plans with the seam gate
``end_min`` — which the engine proves equivalent to the two-pass
overlap-prefix subtraction (DESIGN.md §11).  Exact groups take
``count_many``, whose count routes are plain PyTorch on every device;
k-mismatch groups take the dense mismatch count ``_dense_match_approx``, not
``count_many``, whose dense k > 0 route runs the approx kernel on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.engine import (
    FingerprintBank,
    PatternPlan,
    _effective_k,
    _valid_starts,
    build_index,
    count_many,
)
from repro_torch.core.packing import FP_MULT, as_u8, shift_left


def megascan_count_window_ref(
    window,
    plans: Sequence[PatternPlan],
    *,
    k: Optional[int] = None,
    length: Optional[int] = None,
    prev_ov: int = 0,
) -> torch.Tensor:
    """(P_total,) int32 — the plain PyTorch answer for one streaming window
    whose first ``length`` bytes are valid (all of them by default)."""
    from repro_torch.approx.counting import _dense_match_approx

    t = as_u8(window, plans[0].device)
    n = t.shape[0]
    idx = build_index(t, [n if length is None else int(length)])
    outs = []
    for p in plans:
        kk = _effective_k(p, k)
        if kk == 0:
            outs.append(count_many(idx, [p], k=0, end_min=int(prev_ov))[0])
        else:
            outs.append(_dense_match_approx(idx, p, kk, int(prev_ov)).sum(-1, dtype=torch.int32)[0])
    return torch.cat(outs)


def _pid_bits(table: torch.Tensor, rows: torch.Tensor, P: int) -> torch.Tensor:
    """(P, n) bool: bit p of row rows[i] of a (R, W) pattern-id bitmask."""
    words = table[rows.long()]  # (n, W)
    p = torch.arange(P, device=rows.device)
    return ((words[:, p // 32] >> (p % 32)) & 1).T.bool()


def megascan_candidates_ref(
    window,
    plans: Sequence[PatternPlan],
    spec,
    *,
    length: Optional[int] = None,
    prev_ov: int = 0,
) -> list:
    """The kernel's candidate step in plain PyTorch: per group, the (P, n)
    bool mask of the (pattern, start) pairs its probe flags for the
    verification, or None for 'c' and 'x' groups (unchanged designs).

    'a': the masked gram's row of the plan's private gram table; 'b': a
    union-LUT hit, then the plan's ``lut_pid`` entry when its fingerprints
    are distinct, else the row of its private fingerprint table.  Starts
    outside the seam gate are never flagged.  Every occurrence the kernel
    counts must be flagged here.
    """
    from repro_torch.kernels.megascan.megascan import private_table

    t = as_u8(window, plans[0].device)
    n = t.shape[0]
    idx = build_index(t, [n if length is None else int(length)])
    bank = FingerprintBank(idx.packed)
    out = []
    for plan, g in zip(plans, spec.groups):
        valid = _valid_starts(idx, g.m, int(prev_ov))[0]
        if g.kind == "a":
            x = torch.zeros(n, dtype=torch.int64, device=t.device)
            for j in range(g.m):
                x |= shift_left(t.to(torch.int64), j) << (8 * j)
            rows = ((x * int(FP_MULT)) & 0xFFFFFFFF) >> (32 - g.abits)
            table = torch.from_numpy(private_table(plan, g).astype("int64")).to(t.device)
            out.append(_pid_bits(table, rows, g.n_patterns) & valid)
        elif g.kind == "b":
            fp = bank.window_fp(g.m, g.kbits)[0].long()
            hit = plan.lut_any[fp] & valid
            if plan.lut_pid is not None:
                p = torch.arange(g.n_patterns, device=t.device)[:, None]
                out.append((plan.lut_pid[fp][None, :] == p) & hit)
            else:
                table = torch.from_numpy(private_table(plan, g).astype("int64")).to(t.device)
                out.append(_pid_bits(table, fp, g.n_patterns) & hit)
        else:
            out.append(None)
    return out
