"""Multi-pattern packed matching, in PyTorch (cf. Faro & Kulekci, "Fast
multiple string matching using streaming SIMD extensions technology",
SPIRE 2012 — reference [10] of the paper).

The PyTorch twin of ``repro.core.multipattern``.  Two layers:

  * the per-pattern baseline ``find_multi_vmap`` / ``count_multi_vmap``: one
    ``epsm.find`` per pattern of a (P, m) stack, O(P * n) work — the
    benchmark baseline and semantic reference (the reference vmaps it);
  * the engine path (``repro_torch.core.engine``): pack + fingerprint the
    text once, compile each length group once, and answer P patterns x B
    texts together.  ``find_multi``, ``count_multi``, ``contains_any`` and
    ``PatternSet`` route through it.

Host inputs go to ``device`` (default: the card); tensors stay where they are.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import engine, epsm
from repro_torch.core.packing import as_u8, as_u8_np


# ---------------------------------------------------------------------------
# Per-pattern baseline
# ---------------------------------------------------------------------------

def find_multi_vmap(text, patterns, *, algo: str = "auto", device=None) -> torch.Tensor:
    """One single-pattern scan per row of a (P, m) stack: bool[P, n]."""
    t = as_u8(text, device)
    ps = as_u8(patterns, t.device)
    if ps.ndim != 2:
        raise ValueError("patterns must be (P, m)")
    if ps.shape[0] == 0:
        return torch.zeros((0, t.shape[0]), dtype=torch.bool, device=t.device)
    return torch.stack([epsm.find(t, p, algo=algo) for p in ps])


def count_multi_vmap(text, patterns, *, algo: str = "auto", device=None) -> torch.Tensor:
    return find_multi_vmap(text, patterns, algo=algo, device=device).sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Engine-backed API
# ---------------------------------------------------------------------------

def _stack_plans(patterns, device):
    ps = as_u8_np(patterns)
    if ps.ndim != 2:
        raise ValueError("patterns must be (P, m)")
    return engine.compile_patterns_cached(list(ps), device=device)


def _index_and_plans(text, patterns, device):
    idx = engine.build_index(as_u8(text, device))
    return idx, _stack_plans(patterns, idx.device)


def find_multi(text, patterns, *, algo: str = "auto", device=None) -> torch.Tensor:
    """Match-start masks for a (P, m) stack of equal-length patterns:
    bool[P, n], one engine join; the plan build is memoized on the bytes."""
    del algo  # the engine selects the regime per length group
    idx, plans = _index_and_plans(text, patterns, device)
    return engine.match_many(idx, plans)[0]


def count_multi(text, patterns, *, algo: str = "auto", device=None) -> torch.Tensor:
    del algo
    idx, plans = _index_and_plans(text, patterns, device)
    return engine.count_many(idx, plans)[0]


def contains_any(text, patterns, *, algo: str = "auto", device=None) -> torch.Tensor:
    """0-d bool: does any of the stacked patterns occur in text?"""
    del algo
    idx, plans = _index_and_plans(text, patterns, device)
    return engine.count_many(idx, plans).sum() > 0


class PatternSet:
    """Blocklist over patterns of arbitrary (mixed) lengths.

    Compiles every length group into a PatternPlan ONCE, on ``device``
    (default: the card); every query afterwards is one engine join over all
    groups.  ``k`` is a Hamming mismatch budget: a k-compiled set treats a
    document as blocked when any pattern occurs within <= k byte
    substitutions, since every query flows through the engine's per-plan
    default.
    """

    def __init__(self, patterns: Sequence, *, k: int = 0, bucket="auto",
                 automaton="auto", recorder=None, device=None):
        if not patterns:
            raise ValueError("empty PatternSet")
        self.k = int(k)
        self.plans = engine.compile_patterns(
            patterns, k=self.k, bucket=bucket, automaton=automaton,
            recorder=recorder, device=device,
        )
        self.device = self.plans[0].device
        self.order = engine.plan_order(self.plans)
        # group-major order of the original patterns
        self.groups = {p.m: p.patterns for p in self.plans}
        self._scanners: dict = {}  # chunk_bytes -> StreamScanner (reusable)
        self._stream_plans = None  # the plans megascan takes, built at first stream

    def index(self, text_or_batch, lengths=None) -> engine.TextIndex:
        return engine.build_index(text_or_batch, lengths, device=self.device)

    def contains_any(self, text) -> torch.Tensor:
        """0-d bool for a single text."""
        idx = engine.build_index(as_u8(text, self.device))
        return engine.count_many(idx, self.plans).sum() > 0

    def blocked(self, texts, lengths=None) -> torch.Tensor:
        """bool[B] blocklist verdicts for a padded (B, L) document batch."""
        if lengths is None:
            idx = self.index(texts)
            return engine.count_many(idx, self.plans).sum(-1) > 0
        return engine.blocked(texts, lengths, self.plans, device=self.device)

    def count_each(self, text) -> torch.Tensor:
        """Concatenated per-pattern occurrence counts (group order), int32."""
        idx = engine.build_index(as_u8(text, self.device))
        return engine.count_many(idx, self.plans)[0]

    def contains_any_stream(self, source, *, chunk_bytes: int = 1 << 22) -> bool:
        """Bounded-memory verdict for one oversize document or byte stream:
        O(chunk_bytes) device memory regardless of its length, with early
        exit on a hit.  The scanner is cached per chunk size.

        The scanner counts with the megascan kernel on the card, over the
        set recompiled as plans it takes (``megascan_plans``: flat groups
        of at most 512 patterns).  A set megascan still cannot take (an
        EPSMc pattern whose stride plus length passes its tile, a pattern
        over 4093 bytes, k > 127, more counters than shared memory holds)
        streams through the port's other kernels instead: ``StreamScanner``
        logs a ``kernel_fallback`` event and counts each window with one
        acscan counts launch over the set's Aho-Corasick automaton (the
        approx kernel for k > 0), where the reference's scanner counts such
        plans with its engine."""
        sc = self._scanners.get(chunk_bytes)
        if sc is None:
            from repro_torch.core.stream import StreamScanner
            from repro_torch.kernels.megascan.ops import megascan_plans

            if self._stream_plans is None:
                self._stream_plans = megascan_plans(self.plans)
            sc = StreamScanner(self._stream_plans, chunk_bytes, k=self.k)
            self._scanners[chunk_bytes] = sc
        return sc.contains_any(source)
