"""Plain PyTorch Aho-Corasick transition scan, and the sequential oracles.

``acscan_states_ref`` is the reference's ``lax.scan`` path of
``core.automaton.automaton_states``: the text mapped to classes, cut into
overlapping lane windows, and a loop of T = seg + max_m - 1 gathers over the
(B, lanes) state vector, keeping the last seg states of each lane.  It is
the plain version of the ``acscan`` kernel's states mode, and
``acscan_counts_ref`` (those states, gated and histogrammed by terminal
state) of its counts mode.  ``ac_states_ref`` (one
transition per byte, numpy) and ``count_ref`` (sliding-window counts) are
copies of the reference's oracles in ``repro/kernels/acscan/ref.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def acscan_states_ref(text: torch.Tensor, classes: torch.Tensor, table: torch.Tensor,
                      n_classes: int, max_m: int, *, seg: Optional[int] = None) -> torch.Tensor:
    """int32 (B, n): the automaton state after each byte of each row, in the
    ids of ``table`` (uint16 or int32 entries)."""
    from repro_torch.core.automaton import AC_SEG, _segment_classes

    seg = AC_SEG if seg is None else int(seg)
    B, n = text.shape
    if n == 0 or B == 0:
        return torch.zeros((B, n), dtype=torch.int32, device=text.device)
    ov = int(max_m) - 1
    delta = table.to(torch.int32)
    win, lanes = _segment_classes(classes[text.long()], seg, ov)
    s = torch.zeros((B, lanes), dtype=torch.int32, device=text.device)
    out = torch.empty((B, lanes, seg), dtype=torch.int32, device=text.device)
    for t in range(seg + ov):
        s = delta[(s * int(n_classes) + win[:, :, t]).long()]
        if t >= ov:
            out[:, :, t - ov] = s
    return out.view(B, lanes * seg)[:, :n]


def acscan_counts_ref(text: torch.Tensor, classes: torch.Tensor, table: torch.Tensor,
                      n_classes: int, n_term: int, max_m: int, lengths, *,
                      end_min: Optional[int] = None, seg: Optional[int] = None) -> torch.Tensor:
    """int32 (B, n_term): for each row b and terminal state 1 + t of
    ``table`` (a private table with terminal states 1..n_term, root 0), the
    positions end_min <= i < lengths[b] whose state is 1 + t."""
    B, n = text.shape
    dev = text.device
    if n == 0 or B == 0:
        return torch.zeros((B, int(n_term)), dtype=torch.int32, device=dev)
    key = acscan_states_ref(text, classes, table, n_classes, max_m, seg=seg) - 1
    lengths = torch.as_tensor(lengths).to(device=dev, dtype=torch.int64).reshape(B)
    pos = torch.arange(n, device=dev)[None, :]
    gate = (key >= 0) & (key < int(n_term)) & (pos < lengths[:, None])
    if end_min is not None:
        gate &= pos >= int(end_min)
    rows = torch.arange(B, device=dev)[:, None].expand(B, n)[gate]
    hist = torch.bincount(rows * int(n_term) + key[gate].long(), minlength=B * int(n_term))
    return hist.view(B, int(n_term)).to(torch.int32)


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
