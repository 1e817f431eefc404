"""Packed k-mismatch counting filter + the engine's approximate matchers.

The port's copy of ``repro.approx.counting`` (DESIGN.md §8).  Per-position
mismatch counting reuses the exact path's packed substrate: the TextIndex's
packed 4-gram view XOR'd against a pattern's packed anchor words yields
agreeing bytes as zero bytes of the result, so one 32-bit lane op counts 4
byte agreements (``count_zero_bytes_u32``).  Only the strided words are used
(the overlapping final anchor word would double-count its bytes); the m % 4
tail is counted byte-wise.

Two count paths, mirroring the exact engine:

  * dense — (B, P, n) mismatch accumulation, always exact for any k; the
    fallback and the small-input / saturated-gate path;
  * sparse — the relaxed fingerprint LUT (``repro_torch.approx.relaxed``)
    gates candidate blocks of APPROX_CAND_BLOCK positions before
    verification.

The reference's ``lax.cond`` between them becomes a synced count of the
candidate blocks against the same budget, as in the port's exact engine.
On a CUDA index the full-mask route ``match_group_approx`` (and so the dense
count) runs the hand-written ``approx`` kernel; on a CPU index it runs
``_dense_match_approx``, the same function in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core.engine import FingerprintBank, PatternPlan, TextIndex
from repro_torch.core.packing import PACK, count_zero_bytes_u32, shift_left

# Candidate-block granularity of the sparse k-mismatch path: the relaxed LUT
# is ~2 orders of magnitude denser than the exact union LUT, so blocks are
# narrower than the exact engine's CAND_BLOCK.
APPROX_CAND_BLOCK = 8
# Sparse path only when the expected candidate-block fraction stays below
# this; above it the gather + compaction can't beat dense.
BLOCK_FRAC_MAX = 0.25
# ... and only once dense O(B n P) counting is this large (the reference's
# measured floor, a literal in its count_group_approx).
APPROX_SPARSE_MIN_ELEMS = 8_000_000


def _n_strided(m: int) -> int:
    """Packed words usable for counting: full non-overlapping 4-grams."""
    return m // PACK


def mismatch_counts(index: TextIndex, plan: PatternPlan) -> torch.Tensor:
    """int32 (B, P, n) — Hamming distance between the m-byte window at every
    text position and every pattern (garbage in the <m tail; callers mask
    with _valid_starts).  Packed: m // 4 lane ops + m % 4 byte ops."""
    t, w = index.text, index.packed
    P, m = plan.patterns.shape
    B, n = t.shape
    mm = torch.zeros((B, P, n), dtype=torch.int32, device=t.device)
    for i in range(_n_strided(m)):
        x = shift_left(w, PACK * i)[:, None, :] ^ plan.anchors[None, :, i, None]
        mm += PACK - count_zero_bytes_u32(x)
    for j in range(_n_strided(m) * PACK, m):
        mm += (shift_left(t, j)[:, None, :] != plan.patterns[None, :, j, None]).to(torch.int32)
    return mm


def _dense_match_approx(index: TextIndex, plan: PatternPlan, k: int, end_min=None) -> torch.Tensor:
    """The plain version of the approx kernel's (B, P, n) mask."""
    ok = mismatch_counts(index, plan) <= k
    return ok & engine._valid_starts(index, plan.m, end_min)[:, None, :]


def _match_approx_kernel(index: TextIndex, plan: PatternPlan, k: int, end_min=None) -> torch.Tensor:
    from repro_torch.kernels.approx.approx import approx_cuda

    use_lut = plan.relaxed_lut is not None and k <= plan.k
    start_min = 0 if end_min is None else int(end_min) - (plan.m - 1)
    return approx_cuda(
        index.text, plan.patterns, plan.anchors, k,
        plan.relaxed_lut if use_lut else None, kbits=plan.kbits,
        lengths=index.lengths, start_min=start_min,
    )


def match_group_approx(index: TextIndex, plan: PatternPlan, k: int, end_min=None) -> torch.Tensor:
    """bool (B, P, n) k-mismatch match-start mask.  Dense by design: for full
    masks the output write dominates, so the counting filter runs at every
    position.  ``end_min`` is the streaming seam gate (engine.match_many)."""
    from repro_torch.kernels import _build

    return _build.on_device(index.text, _match_approx_kernel, _dense_match_approx)(
        index, plan, k, end_min)


def _dense_count_approx(index: TextIndex, plan: PatternPlan, k: int, end_min=None) -> torch.Tensor:
    return match_group_approx(index, plan, k, end_min).sum(-1, dtype=torch.int32)


def _block_frac(plan: PatternPlan) -> float:
    """Expected candidate-block fraction on random text (host-side)."""
    density = plan.relaxed_bits / (1 << plan.kbits)
    return 1.0 - (1.0 - density) ** APPROX_CAND_BLOCK


def _approx_candidates(index: TextIndex, plan: PatternPlan,
                       bank: Optional[FingerprintBank] = None, end_min=None):
    """Relaxed-LUT candidate blocks: one O(n) window fingerprint + probe
    (independent of P and k), reduced to APPROX_CAND_BLOCK granularity; the
    fingerprint is a shared-prefix read from the FingerprintBank.  Returns
    (blk_any, budget, nblk)."""
    B, n = index.text.shape
    if bank is None:
        bank = FingerprintBank(index.packed)
    h = bank.window_fp(plan.m, plan.kbits)
    cand = plan.relaxed_lut[h.long()] & engine._valid_starts(index, plan.m, end_min)
    C = APPROX_CAND_BLOCK
    nblk = -(-n // C)
    blk_any = engine._block_any(cand, nblk, C)
    # 2x the random-text expectation plus per-row slack covers fingerprint
    # collisions and true fuzzy matches; overflow falls back to dense.
    exp_blocks = int(B * nblk * _block_frac(plan))
    budget = int(min(B * nblk, max(1024, 2 * exp_blocks + 8 * B)))
    return blk_any, budget, nblk


def _approx_verify_counts(index: TextIndex, plan: PatternPlan, k: int, blk_any, nblk: int,
                          end_min=None) -> torch.Tensor:
    """Gather candidate blocks, count mismatches at all C positions x P
    patterns on the packed gathered rows, add per-text counts."""
    B = index.batch
    P, m = plan.patterns.shape
    C = APPROX_CAND_BLOCK
    rows_packed, bvec, bstart = engine._gather_candidate_rows(index, m, blk_any, nblk, cblock=C)
    nb = rows_packed.shape[0]
    mm = torch.zeros((nb, C, P), dtype=torch.int32, device=index.device)
    for i in range(_n_strided(m)):
        o = PACK * i
        x = rows_packed[:, o : o + C, None] ^ plan.anchors[None, None, :, i]
        mm += PACK - count_zero_bytes_u32(x)
    for j in range(_n_strided(m) * PACK, m):
        # byte at gathered position q is the low byte of its packed word
        byte = rows_packed[:, j : j + C] & 0xFF
        mm += (byte[:, :, None] != plan.patterns[None, None, :, j].to(torch.int32)).to(torch.int32)
    in_row = engine._start_gate(index, m, engine._block_starts(bstart, C), bvec, end_min)
    ok = (mm <= k) & in_row[:, :, None]
    counts = torch.zeros((B, P), dtype=torch.int32, device=index.device)
    counts.index_put_((bvec,), ok.sum(1, dtype=torch.int32), accumulate=True)
    return counts


def _gated(index: TextIndex, plan: PatternPlan, k: int) -> bool:
    """Whether count_group_approx tries the relaxed-LUT sparse path: the
    reference's measured heuristic (the gate pays only once dense O(B n P)
    counting dwarfs the sparse floor and the union LUT is sparse enough)."""
    B, n = index.text.shape
    return (
        plan.relaxed_lut is not None
        and k <= plan.k  # reachable set for plan.k covers any smaller budget
        and n >= 4 * APPROX_CAND_BLOCK
        and plan.n_patterns >= 4
        and B * n * plan.n_patterns >= APPROX_SPARSE_MIN_ELEMS
        and _block_frac(plan) <= BLOCK_FRAC_MAX
    )


def count_group_approx(index: TextIndex, plan: PatternPlan, k: int,
                       bank: Optional[FingerprintBank] = None, end_min=None) -> torch.Tensor:
    """int32 (B, P) k-mismatch occurrence counts: relaxed-LUT sparse path
    when the plan carries a usable gate and the candidate blocks fit their
    budget (one synced count), dense counting otherwise."""
    if not _gated(index, plan, k):
        return _dense_count_approx(index, plan, k, end_min)
    blk_any, budget, nblk = _approx_candidates(index, plan, bank, end_min)
    if engine._within(blk_any, budget):
        return _approx_verify_counts(index, plan, k, blk_any, nblk, end_min)
    return _dense_count_approx(index, plan, k, end_min)
