"""Plain PyTorch Aho-Corasick transition scan, and the sequential oracles.

``acscan_states_ref`` is the reference's ``lax.scan`` path of
``core.automaton.automaton_states``: the text mapped to classes, cut into
overlapping lane windows, and a loop of T = seg + max_m - 1 gathers over the
(B, lanes) state vector, keeping the last seg states of each lane.  It is
the plain version of the ``acscan`` kernel.  ``ac_states_ref`` (one
transition per byte, numpy) and ``count_ref`` (sliding-window counts) are
copies of the reference's oracles in ``repro/kernels/acscan/ref.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def acscan_states_ref(text: torch.Tensor, classes: torch.Tensor, delta: torch.Tensor,
                      n_classes: int, max_m: int, *, seg: Optional[int] = None) -> torch.Tensor:
    """int32 (B, n): the automaton state after each byte of each row."""
    from repro_torch.core.automaton import AC_SEG, _segment_classes

    seg = AC_SEG if seg is None else int(seg)
    B, n = text.shape
    if n == 0 or B == 0:
        return torch.zeros((B, n), dtype=torch.int32, device=text.device)
    ov = int(max_m) - 1
    win, lanes = _segment_classes(classes[text.long()], seg, ov)
    s = torch.zeros((B, lanes), dtype=torch.int32, device=text.device)
    out = torch.empty((B, lanes, seg), dtype=torch.int32, device=text.device)
    for t in range(seg + ov):
        s = delta[(s * int(n_classes) + win[:, :, t]).long()]
        if t >= ov:
            out[:, :, t - ov] = s
    return out.view(B, lanes * seg)[:, :n]


def ac_states_ref(text_row: np.ndarray, classes, delta, n_classes: int) -> np.ndarray:
    """(n,) int32 state after consuming each byte of ONE text row."""
    cls = np.asarray(classes, np.int64)[np.asarray(text_row, np.uint8)]
    d = np.asarray(delta, np.int64).reshape(-1, n_classes)
    out = np.zeros(cls.shape[0], np.int32)
    s = 0
    for i, c in enumerate(cls):
        s = d[s, c]
        out[i] = s
    return out


def count_ref(text_row: np.ndarray, length: int, patterns) -> np.ndarray:
    """Naive per-pattern sliding-window counts over one row (oracle)."""
    t = np.asarray(text_row, np.uint8)[: int(length)]
    out = np.zeros(len(patterns), np.int64)
    for i, p in enumerate(patterns):
        if isinstance(p, (bytes, bytearray, str)):
            p = np.frombuffer(p.encode() if isinstance(p, str) else p, np.uint8)
        else:
            p = np.asarray(p, np.uint8)
        m = p.shape[0]
        if m > t.shape[0]:
            continue
        win = np.lib.stride_tricks.sliding_window_view(t, m)
        out[i] = int((win == p[None, :]).all(-1).sum())
    return out.astype(np.int32)
