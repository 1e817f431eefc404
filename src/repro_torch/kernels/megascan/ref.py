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

from repro_torch.core.engine import PatternPlan, _effective_k, build_index, count_many
from repro_torch.core.packing import as_u8


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
