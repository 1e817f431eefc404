"""Plain PyTorch versions of the baselines' segmented device loops.

Each cuts the text into segments of ``seg`` bytes exactly as the CUDA
kernel does and steps all segments in lockstep: one vector step a byte of a
segment for the scans (Shift-Or, KMP), one iteration of every lane's skip
loop a step for HASH3 and BNDM, with masks for the lanes that are done.  So
a call costs about seg + m steps, not n, and with ``seg >= n`` it is the
reference's sequential loop.  The seam rule is the kernel's (see
``csrc/baselines.cu``).

uint32 state (Shift-Or's D, BNDM's D) is carried in int64 masked to 32
bits.  Hits are scattered into a mask of n + 1 entries whose last entry
takes every lane that did not hit, so no step waits for the device.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
HASH3_SIZE = 4096
# Steps between the skip loops' checks whether any lane is still running
_CHECK_EVERY = 32


def _segments(n: int, seg: int, device):
    """Start a and end e of every segment's owned range [a, e)."""
    a = torch.arange(0, n, seg, device=device, dtype=torch.int64)
    return a, torch.clamp(a + seg, max=n)


def _scan(text, m: int, seg: int, init: int, step, is_hit):
    """Run ``state = step(state, byte)`` over every segment from ``init`` at
    its warm-up start a - (m - 1), writing the starts of the owned ends
    where ``is_hit(state)``; returns (mask, bytes read a lane)."""
    n = text.shape[0]
    a, e = _segments(n, seg, text.device)
    state = torch.full_like(a, init)
    st = torch.clamp(a - (m - 1), min=0)
    reads = e - st
    out = torch.zeros(n + 1, dtype=torch.bool, device=text.device)
    for k in range(int(reads.max())):
        pos = st + k
        live = pos < e
        c = text[torch.clamp(pos, max=n - 1)].long()
        state = torch.where(live, step(state, c), state)
        hit = live & (pos >= a) & is_hit(state)
        out[torch.where(hit, pos - (m - 1), n)] = True
    return out[:n], reads


def _shift_or(text, pattern, table, seg):
    m = pattern.shape[0]
    B = table.long() & MASK32
    return _scan(text, m, seg, MASK32, lambda D, c: ((D << 1) | B[c]) & MASK32,
                 lambda D: ((D >> (m - 1)) & 1) == 0)


def _kmp_dfa(text, pattern, table, seg):
    m = pattern.shape[0]
    dfa = table.long()
    return _scan(text, m, seg, 0, lambda s, c: dfa[s * 256 + c], lambda s: s == m)


def _hash3(text, pattern, table, seg):
    """HASH3's skip loop in every segment: window ends i from max(a, m - 1)
    while i < e; returns (mask, loop iterations a lane)."""
    n, m = text.shape[0], pattern.shape[0]
    a, e = _segments(n, seg, text.device)
    i = torch.clamp(a, min=m - 1)
    shift = table.long()
    offsets = torch.arange(m, device=text.device)
    out = torch.zeros(n + 1, dtype=torch.bool, device=text.device)
    iters = torch.zeros_like(a)
    k = 0
    while True:
        live = i < e
        if k % _CHECK_EVERY == 0 and not bool(live.any()):
            break
        ic = torch.clamp(i, max=n - 1)
        h = (text[ic - 2].long() + (text[ic - 1].long() << 3) + (text[ic].long() << 6)) & (
            HASH3_SIZE - 1)
        s = shift[h]
        start = ic - m + 1
        ok = live & (s == 0) & (text[start[:, None] + offsets] == pattern).all(-1)
        out[torch.where(ok, start, n)] = True
        i = torch.where(live, i + torch.where(s == 0, 1, s), i)
        iters += live
        k += 1
    return out[:n], iters


def _bndm(text, pattern, table, seg):
    """BNDM's nested loops in every segment, one inner step a lockstep step:
    window starts pos from a while pos < min(e, n - m + 1); returns (mask,
    inner steps a lane)."""
    n, m = text.shape[0], pattern.shape[0]
    a, e = _segments(n, seg, text.device)
    lim = torch.clamp(e, max=n - m + 1)
    B = table.long() & MASK32
    top, D0 = 1 << (m - 1), MASK32 >> (32 - m)
    pos = a.clone()
    j = torch.full_like(a, m)
    D = torch.full_like(a, D0)
    last = torch.full_like(a, m)
    out = torch.zeros(n + 1, dtype=torch.bool, device=text.device)
    steps = torch.zeros_like(a)
    k = 0
    while True:
        active = pos < lim
        if k % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        D = D & B[text[torch.clamp(pos + j - 1, 0, n - 1)].long()]
        j = j - 1
        hit = (D & top) != 0
        out[torch.where(active & hit & (j == 0), pos, n)] = True
        last_now = torch.where(hit & (j > 0), j, last)
        D = torch.where(j > 0, (D << 1) & MASK32, 0)
        done = D == 0
        # a finished window moves on by `last` and starts afresh
        pos = torch.where(active & done, pos + last_now, pos)
        j = torch.where(done, m, j)
        D = torch.where(done, D0, D)
        last = torch.where(done, m, last_now)
        steps += active
        k += 1
    return out[:n], steps


_LOOPS = {"shift_or": _shift_or, "kmp_dfa": _kmp_dfa, "hash3": _hash3, "bndm": _bndm}


def shift_or_ref(text, pattern, table, seg: int) -> torch.Tensor:
    return _shift_or(text, pattern, table, seg)[0]


def kmp_dfa_ref(text, pattern, table, seg: int) -> torch.Tensor:
    return _kmp_dfa(text, pattern, table, seg)[0]


def hash3_ref(text, pattern, table, seg: int) -> torch.Tensor:
    return _hash3(text, pattern, table, seg)[0]


def bndm_ref(text, pattern, table, seg: int) -> torch.Tensor:
    return _bndm(text, pattern, table, seg)[0]


def lane_steps(name: str, text, pattern, table, seg: int) -> torch.Tensor:
    """Steps each segment's loop takes (int64, one a segment): bytes read
    for the scans, loop iterations for HASH3, inner steps for BNDM.  Their
    sum is the work this input needs; a warp waits for its longest lane."""
    return _LOOPS[name](text, pattern, table, seg)[1]
