"""Shared-text batched multi-pattern matching engine, in PyTorch.

The PyTorch twin of ``repro.core.engine`` (DESIGN.md §7, §9, §14, §15):

  * :class:`TextIndex` — what depends only on the text, computed ONCE per
    (B, n) batch: the packed 4-gram view and the aligned block fingerprints.
  * :class:`PatternPlan` — what depends only on the patterns, compiled once
    per equal-length group on the host: stacked anchor words, the union
    fingerprint LUT and its payloads (pattern ids / bitmasks when flat, CSR
    slot tables when bucketed).
  * :func:`match_many` / :func:`count_many` join them: P patterns x B texts
    with a per-position filter whose cost does not grow with P.

Names, signatures, constants and routing decisions are the reference's, so
every output is bit-identical to it.  Internals differ where PyTorch allows:
the reference's fixed-budget ``jnp.nonzero(size=budget)`` + ``lax.cond``
becomes a Python ``if`` on the synced candidate count and a dynamic
``torch.nonzero`` (the budget and every route decision are unchanged), and
``.at[...].add(mode="drop")`` becomes ``index_put_(accumulate=True)`` on
in-range indices.  PyTorch runs eagerly, so there is no ``match_many_jit``.

On a CUDA index the full-mask EPSMb route (``_match_group_b``) runs the
hand-written ``multipattern`` kernel; on a CPU index it runs ``_dense_b``,
the same compare in plain PyTorch.  Groups with a mismatch budget k > 0 go
to the k-mismatch routes of ``repro_torch.approx.counting``, whose full-mask
route runs the ``approx`` kernel on a CUDA index.

Dictionary-scale plan sets (AUTOMATON_MIN_P patterns or more with a
bucketed EPSMb group) carry a packed Aho-Corasick automaton over the whole
dictionary (``repro_torch.core.automaton``); the shared EPSMb pass falls
back to it on overflow, and on a CUDA index its transition scan runs the
hand-written ``acscan`` kernel.

Dtype rule (``core/packing.py``): packed words and fingerprints are carried
as int32 bits; plan arrays that are uint32 or uint16 in the reference are
int32 here with the same values (uint32 as the same bits).
"""

from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.automaton import (
    AutomatonPlan,
    automaton_from_numpy,
    compile_automaton,
    count_automaton,
)
from repro_torch.core.epsm import EPSMA_MAX, EPSMB_MAX, EPSMC_BETA, _epsmc_stride
from repro_torch.core.packing import (
    FP_MULT as _FP_MULT,
    PACK,
    WORD_SALTS as _WORD_SALTS,
    as_u8,
    as_u8_np,
    fingerprint_weights,
    fp_accum_word,
    fp_finalize,
    hash_blocks,
    pack_u32,
    resolve_device,
    shift_left,
)
from repro_torch.obs.recorder import Recorder, logging_sink

# Constants copied from the reference (tests/test_torch_packing.py pins them).
ENGINE_KBITS = 17
DICT_BUCKET_MIN_P = 128
DICT_BBITS_MAX = 5
DICT_SLOTS_PER_PATTERN = 64
SLOT_VERIFY_CAP = 64
AUTOMATON_MIN_P = 1024
DENSE_ROUTE_RHO = 0.5
CAND_BLOCK = 32
SPARSE_B_MIN_ELEMS = 8_000_000
# (B, P, n) mask elements one step of the dense count fallback materializes
DENSE_STEP_ELEMS = 1 << 28

_LOG = logging.getLogger("repro_torch.engine")
_DEFAULT_REC = Recorder(enabled=False, fence=False, sinks=(logging_sink(_LOG),))

# ---------------------------------------------------------------------------
# Phase 1: TextIndex — pack & fingerprint the text once
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TextIndex:
    """Pattern-independent view of a (B, n) batch of padded texts."""

    text: torch.Tensor      # (B, n) uint8
    packed: torch.Tensor    # (B, n) int32 — LE-packed 4-gram per position
    block_fp: torch.Tensor  # (B, n // beta) int32 — aligned beta-block k-bit fps
    lengths: torch.Tensor   # (B,) int32 — true byte length of each row

    @property
    def batch(self) -> int:
        return self.text.shape[0]

    @property
    def n(self) -> int:
        return self.text.shape[1]

    @property
    def device(self) -> torch.device:
        return self.text.device


def build_index(
    texts,
    lengths=None,
    *,
    beta: int = EPSMC_BETA,
    kbits: int = ENGINE_KBITS,
    device=None,
) -> TextIndex:
    """Pack + fingerprint once.  ``texts`` is (n,) or (B, n) uint8, or a list
    of byte strings padded to the longest.  A tensor stays on its device;
    host inputs go to ``device`` (default: the card)."""
    if isinstance(texts, (list, tuple)):
        rows = [as_u8_np(t) for t in texts]
        n = max((len(r) for r in rows), default=0)
        mat = np.zeros((len(rows), n), np.uint8)
        for i, r in enumerate(rows):
            mat[i, : len(r)] = r
        texts = mat
        if lengths is None:
            lengths = np.asarray([len(r) for r in rows], np.int32)
    t = as_u8(texts, device)
    if t.ndim == 1:
        t = t[None, :]
    if t.ndim != 2:
        raise ValueError("texts must be (n,) or (B, n)")
    B, n = t.shape
    if lengths is None:
        lengths = torch.full((B,), n, dtype=torch.int32, device=t.device)
    lengths = torch.as_tensor(lengths).to(device=t.device, dtype=torch.int32)
    packed = pack_u32(t)
    nblk = n // beta
    blocks = t[:, : nblk * beta].reshape(B, nblk, beta)
    block_fp = hash_blocks(blocks, fingerprint_weights(beta, device=t.device), kbits)
    return TextIndex(text=t, packed=packed, block_fp=block_fp, lengths=lengths)


# ---------------------------------------------------------------------------
# Phase 2: PatternPlan — compile a same-length pattern group once
# ---------------------------------------------------------------------------

def _word_offsets(m: int) -> Tuple[int, ...]:
    """Offsets of the packed words covering bytes [0, m): strided 4-gram
    words plus one overlapping final word when m % 4 != 0."""
    offs = list(range(0, m - PACK + 1, PACK))
    if m % PACK and m >= PACK:
        offs.append(m - PACK)
    return tuple(offs)


def _np_pack_words(pats: np.ndarray, offsets) -> np.ndarray:
    """(P, m) uint8 -> (P, nw) uint32 LE-packed anchor words."""
    p32 = pats.astype(np.uint32)
    cols = []
    for o in offsets:
        cols.append(
            p32[:, o]
            | (p32[:, o + 1] << 8)
            | (p32[:, o + 2] << 16)
            | (p32[:, o + 3] << 24)
        )
    return np.stack(cols, axis=1) if cols else np.zeros((pats.shape[0], 0), np.uint32)


def _np_window_fingerprint(words: np.ndarray, kbits: int) -> np.ndarray:
    """Fingerprint of a full window from its packed words (numpy side)."""
    v = np.zeros(words.shape[:-1], np.uint32)
    for i in range(words.shape[-1]):
        v = v + words[..., i] * _WORD_SALTS[i]
    return ((v * _FP_MULT) >> np.uint32(32 - kbits)).astype(np.int32)


def _window_fingerprint(packed: torch.Tensor, offsets, kbits: int) -> torch.Tensor:
    """(..., n) packed view -> (..., n) int32 fingerprint of the window
    starting at every position; O(n) work whatever the number of patterns."""
    v = torch.zeros(packed.shape, dtype=torch.int32, device=packed.device)
    for i, o in enumerate(offsets):
        v = fp_accum_word(v, shift_left(packed, o), i)
    return fp_finalize(v, kbits)


def _n_strided_words(m: int) -> int:
    """Number of strided (4-aligned) anchor words in _word_offsets(m)."""
    return len(range(0, m - PACK + 1, PACK))


class FingerprintBank:
    """Shared incremental window-fingerprint substrate (DESIGN.md §9).

    The strided word offsets (0, 4, 8, ...) of every pattern length form a
    prefix chain with fixed salts, so the salted terms are accumulated ONCE
    and each length group reads its prefix, plus its one overlapping tail
    word when m % 4 != 0.  Addition mod 2^32 is associative, so the
    fingerprints equal ``_window_fingerprint``'s bit for bit.
    """

    def __init__(self, packed: torch.Tensor):
        self.packed = packed
        self._prefix = {0: torch.zeros(packed.shape, dtype=torch.int32, device=packed.device)}
        self._fps: dict = {}  # (m, kbits) -> finalized fingerprint map

    def _strided_sum(self, nterms: int) -> torch.Tensor:
        done = max(t for t in self._prefix if t <= nterms)
        acc = self._prefix[done]
        for i in range(done, nterms):
            acc = fp_accum_word(acc, shift_left(self.packed, PACK * i), i)
            self._prefix[i + 1] = acc
        return self._prefix[nterms]

    def window_fp(self, m: int, kbits: int) -> torch.Tensor:
        """(..., n) int32 fingerprint of the m-byte window at every position."""
        key = (m, kbits)
        fp = self._fps.get(key)
        if fp is None:
            ns = _n_strided_words(m)
            v = self._strided_sum(ns)
            if m % PACK and m >= PACK:
                v = fp_accum_word(v, shift_left(self.packed, m - PACK), ns)
            fp = fp_finalize(v, kbits)
            self._fps[key] = fp
        return fp


@dataclasses.dataclass(frozen=True)
class PatternPlan:
    """Compiled matcher state for one equal-length pattern group.

    The reference's fields, as tensors on one device; ``automaton`` is the
    dictionary's AutomatonPlan on bucketed EPSMb plans of a dictionary-scale
    set (the shared pass's fallback), else None.
    """

    m: int                   # pattern length
    kbits: int               # fingerprint width (widened when bucketed)
    ids: Tuple[int, ...]     # original indices of the group's patterns
    distinct: bool           # all P window fingerprints unique (EPSMb)
    patterns: torch.Tensor   # (P, m) uint8
    anchors: torch.Tensor    # (P, nw) int32 — uint32 bits of the anchor words
    lut_any: torch.Tensor    # (2^kbits,) bool union fingerprint table
    lut_pid: Optional[torch.Tensor] = None   # (2^kbits,) int32 pattern ids (EPSMb)
    lut_bits: Optional[torch.Tensor] = None  # (2^kbits, ceil(P/32)) int32 bitmask (EPSMc)
    hp: Optional[torch.Tensor] = None        # (P, stride) int32 block fps (EPSMc)
    k: int = 0               # mismatch budget the plan was compiled for
    relaxed_lut: Optional[torch.Tensor] = None  # (2^kbits,) bool <=k-reachable fps
    relaxed_bits: int = 0    # set-bit count of relaxed_lut (budgeting)
    bbits: int = 0           # widening over ENGINE_KBITS (0 = flat)
    lut_pop: int = 0         # union-LUT popcount (budget heuristics)
    slot_max: int = 0        # max CSR slot occupancy (verify bound)
    slot_off: Optional[torch.Tensor] = None        # (2^kbits + 1,) int32 (EPSMb)
    slot_ids: Optional[torch.Tensor] = None        # (P,) int32 fp-sorted ids
    anchors_sorted: Optional[torch.Tensor] = None  # (P, nw) int32 fp-sorted anchors
    c_slot_off: Optional[torch.Tensor] = None      # (2^kbits + 1,) int32 (EPSMc)
    c_entry_pid: Optional[torch.Tensor] = None     # (P*stride,) int32
    c_entry_off: Optional[torch.Tensor] = None     # (P*stride,) int32
    c_entry_pat: Optional[torch.Tensor] = None     # (P*stride, m) uint8
    automaton: Optional[AutomatonPlan] = None      # whole-dictionary fallback

    @property
    def n_patterns(self) -> int:
        return self.patterns.shape[0]

    @property
    def device(self) -> torch.device:
        return self.patterns.device

    @property
    def regime(self) -> str:
        if self.m < EPSMA_MAX:
            return "a"
        if self.m < EPSMB_MAX:
            return "b"
        return "c"


TENSOR_FIELDS = tuple(
    f.name for f in dataclasses.fields(PatternPlan)
    if f.name not in ("m", "kbits", "ids", "distinct", "k", "relaxed_bits", "bbits", "lut_pop",
                      "slot_max", "automaton")
)


def _to_tensor(a: Optional[np.ndarray], device) -> Optional[torch.Tensor]:
    """A host plan array as a tensor: uint32 keeps its bits as int32, uint16
    and other integer ids widen to int32."""
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype in (np.uint16, np.int64):
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def plan_from_numpy(fields: dict, *, device=None) -> PatternPlan:
    """A PatternPlan from a reference plan's fields as host values.

    ``fields`` maps each reference field name to its numpy array (array
    fields) or Python value (static fields), e.g. from ``jax.device_get`` of
    the reference plan, k-mismatch plans (``k``, ``relaxed_lut``,
    ``relaxed_bits``) included.  ``automaton`` is None, a port
    AutomatonPlan, or the reference automaton's fields as host values
    (converted by :func:`automaton_from_numpy`).
    """
    dev = resolve_device(device)
    auto = fields.get("automaton")
    if auto is not None:
        auto = auto.to(dev) if isinstance(auto, AutomatonPlan) else automaton_from_numpy(
            auto, device=dev)
    return PatternPlan(
        m=int(fields["m"]),
        kbits=int(fields["kbits"]),
        ids=tuple(int(i) for i in fields["ids"]),
        distinct=bool(fields["distinct"]),
        k=int(fields.get("k", 0)),
        relaxed_bits=int(fields.get("relaxed_bits", 0)),
        bbits=int(fields.get("bbits", 0)),
        lut_pop=int(fields.get("lut_pop", 0)),
        slot_max=int(fields.get("slot_max", 0)),
        automaton=auto,
        **{name: _to_tensor(fields.get(name), dev) for name in TENSOR_FIELDS},
    )


def _dict_bbits(P: int, kbits: int) -> int:
    """Widening that targets DICT_SLOTS_PER_PATTERN slots per pattern."""
    need = int(np.ceil(np.log2(max(2, DICT_SLOTS_PER_PATTERN * P)))) - kbits
    return int(min(DICT_BBITS_MAX, max(0, need)))


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n - 1).bit_length())


def compile_patterns(
    patterns: Sequence,
    *,
    kbits: int = ENGINE_KBITS,
    beta: int = EPSMC_BETA,
    k: int = 0,
    bucket="auto",
    automaton="auto",
    canonical: bool = False,
    recorder: Optional[Recorder] = None,
    device=None,
) -> Tuple[PatternPlan, ...]:
    """Group patterns by length and compile one PatternPlan per group.

    Same contract as ``repro.core.engine.compile_patterns`` (plans sorted by
    m, ``ids`` mapping rows back to input positions, ``bucket`` /
    ``canonical`` as there), built on the host in numpy and placed on
    ``device`` (default: the card).  ``k > 0`` additionally fills the
    relaxed fingerprint LUT of every <= k-reachable window fingerprint
    (``repro_torch.approx.relaxed``).  ``automaton`` gates the packed
    Aho-Corasick fallback attached to bucketed EPSMb plans, as in the
    reference: True builds it, "auto" builds it from AUTOMATON_MIN_P
    patterns, both only when a group is a bucketed EPSMb plan and the
    automaton's size caps hold (``automaton_built`` / ``automaton_skipped``
    events), False skips it.
    """
    if k < 0:
        raise ValueError("mismatch budget k must be >= 0")
    if bucket not in (True, False, "auto"):
        raise ValueError("bucket must be True, False, or 'auto'")
    if automaton not in (True, False, "auto"):
        raise ValueError("automaton must be True, False, or 'auto'")
    dev = resolve_device(device)
    rec = _DEFAULT_REC if recorder is None else recorder
    groups: dict = {}
    arrs: List[np.ndarray] = []
    for i, p in enumerate(patterns):
        arr = as_u8_np(p)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError("patterns must be non-empty 1-D byte strings")
        groups.setdefault(arr.size, []).append((i, arr))
        arrs.append(arr)

    plans: List[PatternPlan] = []
    with rec.span("plan_compile", groups=len(groups), p_total=len(arrs)):
        for m in sorted(groups):
            ids = tuple(i for i, _ in groups[m])
            pats = np.stack([a for _, a in groups[m]])
            P = pats.shape[0]
            anchors = _np_pack_words(pats, _word_offsets(m))
            bucketed = m >= EPSMA_MAX and (
                bucket is True or (bucket == "auto" and P >= DICT_BUCKET_MIN_P)
            )
            bbits = _dict_bbits(P, kbits) if bucketed else 0
            kb = kbits + bbits
            lut_any = np.zeros((1 << kb,), np.bool_)
            arrays: dict = {}
            slot_max = 0
            slot_cap = P  # total CSR entries; EPSMc registers P * stride
            distinct = False
            if m < EPSMA_MAX:
                pass  # dense byte compares; no fingerprint machinery
            elif m < EPSMB_MAX:
                hw = _np_window_fingerprint(anchors, kb)  # (P,)
                lut_any[hw] = True
                distinct = len(set(hw.tolist())) == P
                if bucketed:
                    order = np.argsort(hw, kind="stable")
                    occ = np.bincount(hw, minlength=1 << kb)
                    slot_off = np.zeros((1 << kb) + 1, np.int32)
                    slot_off[1:] = np.cumsum(occ).astype(np.int32)
                    arrays.update(
                        slot_off=slot_off,
                        slot_ids=order.astype(np.uint16 if P <= (1 << 16) else np.int32),
                        anchors_sorted=anchors[order],
                    )
                    slot_max = int(occ.max())
                elif distinct:
                    lut_pid = np.zeros((1 << kb,), np.int32)
                    lut_pid[hw] = np.arange(P, dtype=np.int32)
                    arrays["lut_pid"] = lut_pid
            else:
                # EPSMc: register the block fingerprints at offsets < stride
                # only (each occurrence's unique dedup block, _match_group_c)
                stride = _epsmc_stride(m, beta)
                w = fingerprint_weights(beta).numpy().astype(np.int64)
                offs = np.arange(stride)
                blocks = pats[:, offs[:, None] + np.arange(beta)[None, :]]
                h = (blocks.astype(np.int64) * w[None, None, :]).sum(-1)
                hp = (h & ((1 << kb) - 1)).astype(np.int32)  # (P, stride)
                arrays["hp"] = hp
                lut_any[hp.reshape(-1)] = True
                if bucketed:
                    keys = hp.reshape(-1)  # entry e = pid * stride + off
                    order = np.argsort(keys, kind="stable")
                    occ = np.bincount(keys, minlength=1 << kb)
                    c_slot_off = np.zeros((1 << kb) + 1, np.int32)
                    c_slot_off[1:] = np.cumsum(occ).astype(np.int32)
                    c_entry_pid = (order // stride).astype(np.int32)
                    arrays.update(
                        c_slot_off=c_slot_off,
                        c_entry_pid=c_entry_pid,
                        c_entry_off=(order % stride).astype(np.int32),
                        c_entry_pat=pats[c_entry_pid],
                    )
                    slot_max = int(occ.max())
                    slot_cap = P * stride
                else:
                    lut_bits = np.zeros((1 << kb, -(-P // 32)), np.uint32)
                    for p_i in range(P):
                        lut_bits[hp[p_i], p_i // 32] |= np.uint32(1 << (p_i % 32))
                    arrays["lut_bits"] = lut_bits
            lut_pop = int(lut_any.sum())
            relaxed = None
            relaxed_bits = 0
            if k > 0:
                from repro_torch.approx.relaxed import relaxed_window_lut

                relaxed = relaxed_window_lut(pats, kbits=kb, k=k)
                if relaxed is not None:
                    relaxed_bits = int(relaxed.sum())
            if canonical:
                # pow2-round the budget/bound statics; slot_max is clamped to
                # the plan's TOTAL entry count (an EPSMc slot can exceed P)
                lut_pop = min(1 << kb, _pow2_ceil(max(1, lut_pop)))
                if slot_max:
                    slot_max = min(slot_cap, _pow2_ceil(slot_max))
                if relaxed_bits:
                    relaxed_bits = min(1 << kb, _pow2_ceil(relaxed_bits))
            rec.event(
                "plan_group", m=m, n_patterns=P, bucketed=int(bucketed),
                bbits=bbits, kbits=kb, lut_pop=lut_pop, slot_max=slot_max,
                occupancy=lut_pop / float(1 << kb),
            )
            rec.gauge(f"plan.lut_occupancy.m{m}", lut_pop / float(1 << kb))
            rec.gauge(f"plan.buckets.m{m}", float(1 << bbits))
            plans.append(
                PatternPlan(
                    m=m, kbits=kb, ids=ids, distinct=distinct,
                    patterns=_to_tensor(pats, dev),
                    anchors=_to_tensor(anchors, dev),
                    lut_any=_to_tensor(lut_any, dev),
                    k=k, relaxed_lut=_to_tensor(relaxed, dev), relaxed_bits=relaxed_bits,
                    bbits=bbits, lut_pop=lut_pop, slot_max=slot_max,
                    **{name: _to_tensor(a, dev) for name, a in arrays.items()},
                )
            )
        # the automaton covers the WHOLE input dictionary in input order, so
        # any plan subset column-selects its counts via plan.ids; it rides
        # on every bucketed EPSMb plan (the shared pass's fallback users)
        want_auto = automaton is True or (automaton == "auto" and len(arrs) >= AUTOMATON_MIN_P)
        if want_auto and any(p.slot_off is not None for p in plans):
            with rec.span("automaton_compile", p_total=len(arrs)):
                auto = compile_automaton(arrs, device=dev)
            if auto is None:
                rec.event("automaton_skipped", p_total=len(arrs))
            else:
                rec.event("automaton_built", states=auto.n_states, classes=auto.n_classes,
                          entries=auto.n_entries, out_max=auto.out_max)
                plans = [dataclasses.replace(p, automaton=auto) if p.slot_off is not None else p
                         for p in plans]
    return tuple(plans)


def plan_order(plans: Sequence[PatternPlan]) -> np.ndarray:
    """Row i of the concatenated engine output is pattern ``order[i]`` of
    the original input sequence."""
    return np.asarray([i for plan in plans for i in plan.ids], np.int64)


def replicate_plans(plans: Sequence[PatternPlan], device) -> Tuple[PatternPlan, ...]:
    """Copies of compiled plans on ``device`` (None = leave as is)."""
    if device is None:
        return tuple(plans)
    dev = torch.device(device)
    autos: dict = {}  # one copy of an automaton the plans share
    out = []
    for p in plans:
        moved = {f: getattr(p, f).to(dev) for f in TENSOR_FIELDS if getattr(p, f) is not None}
        if p.automaton is not None:
            if id(p.automaton) not in autos:
                autos[id(p.automaton)] = p.automaton.to(dev)
            moved["automaton"] = autos[id(p.automaton)]
        out.append(dataclasses.replace(p, **moved))
    return tuple(out)


_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 64
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0}
# id(object) -> (weakref, bytes): a tensor pays its device-to-host copy once
_DIGEST_MEMO: dict = {}
_DIGEST_MEMO_MAX = 256


def _pattern_cache_token(p) -> bytes:
    """Canonical uint8 bytes of one pattern; a tensor hits a per-object memo
    (id + weakref identity) so only its first sighting copies it to the host."""
    if isinstance(p, (bytes, bytearray, memoryview)):
        return bytes(p)
    if isinstance(p, str):
        return p.encode("utf-8", errors="surrogateescape")
    if isinstance(p, np.ndarray):
        a = p if p.dtype == np.uint8 else p.astype(np.uint8)
        return a.tobytes()
    if isinstance(p, (list, tuple)):
        return np.asarray(p).astype(np.uint8).tobytes()
    ent = _DIGEST_MEMO.get(id(p))
    if ent is not None:
        ref, tok = ent
        if ref() is p:
            return tok
    tok = bytes(as_u8_np(p))
    try:
        if len(_DIGEST_MEMO) >= _DIGEST_MEMO_MAX:
            for i in [i for i, (r, _) in _DIGEST_MEMO.items() if r() is None]:
                del _DIGEST_MEMO[i]
            if len(_DIGEST_MEMO) >= _DIGEST_MEMO_MAX:
                _DIGEST_MEMO.clear()
        _DIGEST_MEMO[id(p)] = (weakref.ref(p), tok)
    except TypeError:
        pass  # not weakref-able: stay correct, just uncached
    return tok


def compile_patterns_cached(
    patterns: Sequence, *, k: int = 0, bucket="auto", automaton="auto",
    canonical: bool = False, recorder: Optional[Recorder] = None, device=None,
) -> Tuple[PatternPlan, ...]:
    """compile_patterns behind a small host-side LRU memo keyed by the
    pattern bytes, the compile knobs and the device.  Hits refresh recency;
    totals are in plan_cache_stats() and, with a recorder, the
    plan_cache.hit / plan_cache.miss counters."""
    rec = _DEFAULT_REC if recorder is None else recorder
    dev = resolve_device(device)
    key = (k, bucket, automaton, canonical, str(dev)) + tuple(
        _pattern_cache_token(p) for p in patterns
    )
    plans = _PLAN_CACHE.pop(key, None)
    if plans is None:
        _PLAN_CACHE_STATS["misses"] += 1
        rec.count("plan_cache.miss")
        plans = compile_patterns(patterns, k=k, bucket=bucket, automaton=automaton,
                                 canonical=canonical, recorder=recorder, device=dev)
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    else:
        _PLAN_CACHE_STATS["hits"] += 1
        rec.count("plan_cache.hit")
    _PLAN_CACHE[key] = plans  # (re)insert at the recent end
    return plans


def plan_cache_stats() -> dict:
    """Lifetime hit/miss totals and current size of the plan memo."""
    return dict(_PLAN_CACHE_STATS, entries=len(_PLAN_CACHE))


# ---------------------------------------------------------------------------
# Matchers (one per regime).  Each returns mask (B, P, n) or counts (B, P).
# ---------------------------------------------------------------------------

def _valid_starts(index: TextIndex, m: int, end_min=None) -> torch.Tensor:
    """(B, n) — True where a length-m occurrence may start: inside the row's
    true length, and (with ``end_min``, the streaming seam bound) ending at
    or past end_min."""
    pos = torch.arange(index.n, dtype=torch.int32, device=index.device)[None, :]
    ok = pos <= (index.lengths[:, None] - m)
    if end_min is not None:
        ok = ok & (pos + (m - 1) >= int(end_min))
    return ok


def _match_group_a(index: TextIndex, plan: PatternPlan, bank=None, end_min=None) -> torch.Tensor:
    """m < 4: dense shifted byte compares (EPSMa, batched over B and P)."""
    del bank  # no fingerprint machinery in this regime
    t = index.text
    acc = _valid_starts(index, plan.m, end_min)[:, None, :].expand(
        index.batch, plan.n_patterns, index.n
    ).clone()
    for j in range(plan.m):
        acc &= shift_left(t, j)[:, None, :] == plan.patterns[None, :, j, None]
    return acc


def _dense_b(index: TextIndex, plan: PatternPlan, end_min=None) -> torch.Tensor:
    """Stacked-anchor dense compare: AND over packed word compares, the exact
    EPSMb filter + verify fused (also the count path's overflow fallback)."""
    acc = _valid_starts(index, plan.m, end_min)[:, None, :].expand(
        index.batch, plan.n_patterns, index.n
    ).clone()
    for i, o in enumerate(_word_offsets(plan.m)):
        w = shift_left(index.packed, o)
        acc &= w[:, None, :] == plan.anchors[None, :, i, None]
    return acc


def _expected_union_blocks(
    B: int, n: int, plans: Sequence[PatternPlan], cblock: int = CAND_BLOCK
) -> Tuple[int, float]:
    """(expected candidate blocks, expected block density) from the static
    per-plan LUT popcounts: a block of C positions survives when any of its
    positions hits any plan's occupied slots."""
    nblk = -(-n // cblock)
    miss = 1.0
    for p in plans:
        occ = min(1.0, p.lut_pop / float(1 << p.kbits))
        miss *= (1.0 - occ) ** cblock
    rho = 1.0 - miss
    return int(B * nblk * rho), rho


def _block_any(cand: torch.Tensor, nblk: int, C: int = CAND_BLOCK) -> torch.Tensor:
    """(B, n) bool -> (B, nblk): does any position of each C-block survive?"""
    B, n = cand.shape
    padded = torch.zeros((B, nblk * C), dtype=torch.bool, device=cand.device)
    padded[:, :n] = cand
    return padded.reshape(B, nblk, C).any(-1)


def _b_candidates(index: TextIndex, plan: PatternPlan, bank=None, end_min=None):
    """One O(n) fingerprint + union-LUT probe (independent of P), reduced to
    CAND_BLOCK granularity; returns (blk_any, budget, nblk)."""
    B, n = index.text.shape
    if bank is None:
        bank = FingerprintBank(index.packed)
    h = bank.window_fp(plan.m, plan.kbits)
    cand = plan.lut_any[h.long()] & _valid_starts(index, plan.m, end_min)
    nblk = -(-n // CAND_BLOCK)
    blk_any = _block_any(cand, nblk)
    exp, _ = _expected_union_blocks(B, n, (plan,))
    budget = int(min(B * nblk, max(1024, 4 * exp + 8 * B, (B * nblk) // 3)))
    return blk_any, budget, nblk


def _within(mask: torch.Tensor, budget: int) -> bool:
    """The sparse-vs-fallback decision: candidate count within budget (syncs)."""
    return int(mask.sum(dtype=torch.int64)) <= budget


def _gather_candidate_rows(index: TextIndex, m: int, blk_any, nblk: int, cblock: int = CAND_BLOCK):
    """Sparse-path prelude: the candidate blocks, each block's C+m-1 bytes
    gathered and re-packed once.  Returns (rows_packed (nb, C+m-1) int32,
    bvec (nb,), bstart (nb,))."""
    B, n = index.text.shape
    C = cblock
    flat = torch.nonzero(blk_any.reshape(-1)).flatten()
    bvec = flat // nblk
    bstart = (flat % nblk) * C
    t_pad = torch.zeros((B, nblk * C + m), dtype=torch.uint8, device=index.device)
    t_pad[:, :n] = index.text
    cols = bstart[:, None] + torch.arange(C + m - 1, device=index.device)
    rows = t_pad[bvec[:, None], cols]
    return pack_u32(rows), bvec, bstart


def _block_starts(bstart: torch.Tensor, C: int = CAND_BLOCK) -> torch.Tensor:
    return bstart[:, None] + torch.arange(C, dtype=bstart.dtype, device=bstart.device)[None, :]


def _start_gate(index: TextIndex, m: int, starts, bvec, end_min):
    """Per-gathered-start validity: inside the row's true length, plus the
    streaming seam bound when one is given (see _valid_starts)."""
    ok = starts <= (index.lengths[bvec][:, None] - m)
    if end_min is not None:
        ok = ok & (starts + (m - 1) >= int(end_min))
    return ok


def _add_counts(counts: torch.Tensor, rows, cols, ok) -> torch.Tensor:
    """counts[rows, cols] += 1 wherever ``ok`` holds, duplicate indices summed
    (the reference's ``.at[...].add`` of ok); only the hits are scattered,
    and integer adds are order-independent."""
    r, c = rows[ok], cols[ok]
    counts.index_put_((r, c), torch.ones_like(r, dtype=counts.dtype), accumulate=True)
    return counts


def _b_verify(index: TextIndex, plan: PatternPlan, blk_any, nblk: int, end_min=None):
    """Gathered candidate blocks x all P patterns: returns (ok (nb, C, P),
    bvec (nb,))."""
    m, C = plan.m, CAND_BLOCK
    rows_packed, bvec, bstart = _gather_candidate_rows(index, m, blk_any, nblk)
    ok = None
    for i, o in enumerate(_word_offsets(m)):
        eq = rows_packed[:, o : o + C, None] == plan.anchors[None, None, :, i]
        ok = eq if ok is None else ok & eq
    in_row = _start_gate(index, m, _block_starts(bstart), bvec, end_min)
    return ok & in_row[:, :, None], bvec


def _dense_count(index: TextIndex, plan: PatternPlan, dense_fn, end_min=None) -> torch.Tensor:
    """Counts via the dense mask (fallback only), a slice of the plan's
    patterns at a time so that no step holds more than DENSE_STEP_ELEMS
    (B, P, n) mask elements (and their int32 sum): the whole mask of a
    64-pattern group over 256 MiB would take 16 GiB, its sum 64 GiB."""
    step = max(1, DENSE_STEP_ELEMS // max(1, index.batch * index.n))
    P = plan.n_patterns
    if step >= P:
        return dense_fn(index, plan, end_min).sum(-1, dtype=torch.int32)
    outs = []
    for s in range(0, P, step):
        sub = dataclasses.replace(plan, patterns=plan.patterns[s : s + step],
                                  anchors=plan.anchors[s : s + step])
        outs.append(dense_fn(index, sub, end_min).sum(-1, dtype=torch.int32))
    return torch.cat(outs, dim=1)


def _match_group_b(index: TextIndex, plan: PatternPlan, bank=None, end_min=None) -> torch.Tensor:
    """Full (B, P, n) EPSMb masks: the ``multipattern`` kernel on the card
    (window-fingerprint tile gate + stacked anchor verify), ``_dense_b`` on
    the CPU.  The output write dominates either way."""
    del bank
    from repro_torch.kernels import _build

    return _build.on_device(index.text, _match_b_kernel, _dense_b)(index, plan, end_min)


def _match_b_kernel(index: TextIndex, plan: PatternPlan, end_min=None) -> torch.Tensor:
    from repro_torch.kernels.multipattern.multipattern import multipattern_cuda

    # the seam bound start + m - 1 >= end_min is a lower bound on the start
    start_min = 0 if end_min is None else int(end_min) - (plan.m - 1)
    return multipattern_cuda(
        index.text, plan.anchors, plan.m, plan.lut_any, kbits=plan.kbits,
        use_lut=True, lengths=index.lengths, start_min=start_min,
    )


def _b_verify_pid(index: TextIndex, plan: PatternPlan, blk_any, nblk: int, end_min=None):
    """Distinct-fingerprint fast verify: each candidate position names its
    one claimed pattern through lut_pid, so it compares a single anchor row.
    Returns (ok (nb, C) int32, bvec (nb,), pid (nb, C))."""
    m, C = plan.m, CAND_BLOCK
    rows_packed, bvec, bstart = _gather_candidate_rows(index, m, blk_any, nblk)
    h = _window_fingerprint(rows_packed, _word_offsets(m), plan.kbits)[:, :C].long()
    pid = plan.lut_pid[h]  # (nb, C) the one pattern that could start here
    sel = plan.anchors[pid.long()]  # (nb, C, nw)
    ok = plan.lut_any[h]
    for i, o in enumerate(_word_offsets(m)):
        ok = ok & (rows_packed[:, o : o + C] == sel[:, :, i])
    ok = ok & _start_gate(index, m, _block_starts(bstart), bvec, end_min)
    return ok.to(torch.int32), bvec, pid


def _b_count_rows_csr(index: TextIndex, plan: PatternPlan, rows_packed, bvec, starts,
                      row_bank: FingerprintBank, end_min=None) -> torch.Tensor:
    """Bounded CSR verify on gathered candidate rows (bucketed EPSMb): each
    position walks at most ``slot_max`` entries of its slot's id list."""
    B = index.text.shape[0]
    C = starts.shape[1]
    P = plan.n_patterns
    h = row_bank.window_fp(plan.m, plan.kbits)[:, :C].long()
    base = plan.slot_off[h]
    cnt = plan.slot_off[h + 1] - base
    ok_pos = _start_gate(index, plan.m, starts, bvec, end_min)
    words = [rows_packed[:, o : o + C] for o in _word_offsets(plan.m)]
    counts = torch.zeros((B, P), dtype=torch.int32, device=index.device)
    brow = bvec[:, None].expand(-1, C)
    for j in range(plan.slot_max):
        idx = torch.clamp(base + j, max=P - 1).long()
        sel = plan.anchors_sorted[idx]  # (nb, C, nw) — contiguous per slot
        ok = (j < cnt) & ok_pos
        for i in range(len(words)):
            ok = ok & (words[i] == sel[..., i])
        _add_counts(counts, brow, plan.slot_ids[idx].long(), ok)
    return counts


def _count_b_slot_dense(index: TextIndex, plan: PatternPlan, bank=None, end_min=None) -> torch.Tensor:
    """Slot-dense bounded verify: EVERY position checks its slot's id list,
    O(n * slot_max * nw) with slot_max fixed by the pattern set."""
    B, n = index.text.shape
    P = plan.n_patterns
    if bank is None:
        bank = FingerprintBank(index.packed)
    h = bank.window_fp(plan.m, plan.kbits).long()
    base = plan.slot_off[h]
    cnt = plan.slot_off[h + 1] - base
    valid = _valid_starts(index, plan.m, end_min)
    words = [shift_left(index.packed, o) for o in _word_offsets(plan.m)]
    counts = torch.zeros((B, P), dtype=torch.int32, device=index.device)
    brow = torch.arange(B, device=index.device)[:, None].expand(B, n)
    for j in range(plan.slot_max):
        idx = torch.clamp(base + j, max=P - 1).long()
        sel = plan.anchors_sorted[idx]  # (B, n, nw)
        ok = (j < cnt) & valid
        for i in range(len(words)):
            ok = ok & (words[i] == sel[..., i])
        _add_counts(counts, brow, plan.slot_ids[idx].long(), ok)
    return counts


def _sparse_b_eligible(index: TextIndex, plan: PatternPlan) -> bool:
    B, n = index.text.shape
    return (
        n >= 4 * CAND_BLOCK
        and plan.n_patterns >= 4
        and B * n * plan.n_patterns >= SPARSE_B_MIN_ELEMS
    )


def _count_b_sparse_csr(index: TextIndex, plan: PatternPlan, blk_any, nblk: int, end_min=None):
    rows_packed, bvec, bstart = _gather_candidate_rows(index, plan.m, blk_any, nblk)
    return _b_count_rows_csr(index, plan, rows_packed, bvec, _block_starts(bstart),
                             FingerprintBank(rows_packed), end_min)


def _count_b_sparse_pid(index: TextIndex, plan: PatternPlan, blk_any, nblk: int, end_min=None):
    ok, bvec, pid = _b_verify_pid(index, plan, blk_any, nblk, end_min)
    counts = torch.zeros((index.batch, plan.n_patterns), dtype=torch.int32, device=index.device)
    return _add_counts(counts, bvec[:, None].expand_as(pid), pid.long(), ok.bool())


def _count_b_sparse_all(index: TextIndex, plan: PatternPlan, blk_any, nblk: int, end_min=None):
    ok, bvec = _b_verify(index, plan, blk_any, nblk, end_min)
    counts = torch.zeros((index.batch, plan.n_patterns), dtype=torch.int32, device=index.device)
    counts.index_put_((bvec,), ok.sum(1, dtype=torch.int32), accumulate=True)
    return counts


def _count_group_b(index: TextIndex, plan: PatternPlan, bank=None, end_min=None) -> torch.Tensor:
    B, n = index.text.shape
    if plan.slot_off is not None:
        # bucketed plan: sparse CSR verify, with the bounded slot-dense scan
        # as both the static dense-density route and the overflow fallback
        if bank is None:
            bank = FingerprintBank(index.packed)
        _, rho = _expected_union_blocks(B, n, (plan,))
        if (
            not _sparse_b_eligible(index, plan)
            or rho > DENSE_ROUTE_RHO
            or plan.slot_max > SLOT_VERIFY_CAP
        ):
            return _count_b_slot_dense(index, plan, bank, end_min)
        blk_any, budget, nblk = _b_candidates(index, plan, bank, end_min)
        if _within(blk_any, budget):
            return _count_b_sparse_csr(index, plan, blk_any, nblk, end_min)
        return _count_b_slot_dense(index, plan, bank, end_min)
    if not _sparse_b_eligible(index, plan):
        return _dense_count(index, plan, _dense_b, end_min)
    blk_any, budget, nblk = _b_candidates(index, plan, bank, end_min)
    if _within(blk_any, budget):
        sparse = _count_b_sparse_pid if plan.distinct else _count_b_sparse_all
        return sparse(index, plan, blk_any, nblk, end_min)
    return _dense_count(index, plan, _dense_b, end_min)


@dataclasses.dataclass(frozen=True)
class _SharedRoute:
    """Host-static routing decision for one shared EPSMb set."""

    budget: int            # candidate-block budget for the sparse gate
    exp_blocks: int        # expected candidate blocks (static model)
    rho: float             # expected candidate-block density
    static_fallback: bool  # skip the sparse machinery entirely
    automaton: Optional[AutomatonPlan]  # the fallback's automaton, or None
    kind: str              # fallback kind: "automaton" | "slot_dense" | "dense"


def _shared_b_route(index: TextIndex, plans: Sequence[PatternPlan]) -> _SharedRoute:
    """One routing decision shared by _count_groups_b_shared and
    route_probe, so the dispatcher and the probe cannot disagree: an
    overflowing slot table with an automaton at hand, or an expected block
    density past DENSE_ROUTE_RHO, skips the sparse pass statically."""
    B, n = index.text.shape
    nblk = -(-n // CAND_BLOCK)
    exp, rho = _expected_union_blocks(B, n, plans)
    budget = int(min(B * nblk, max(4096, 2 * exp + 8 * B + (B * nblk) // 16)))
    auto = next((p.automaton for p in plans if p.automaton is not None), None)
    slot_cap_hit = any(p.slot_off is not None and p.slot_max > SLOT_VERIFY_CAP for p in plans)
    static_fallback = (slot_cap_hit and auto is not None) or rho > DENSE_ROUTE_RHO
    if auto is not None:
        kind = "automaton"
    elif any(p.slot_off is not None for p in plans):
        kind = "slot_dense"
    else:
        kind = "dense"
    return _SharedRoute(budget=budget, exp_blocks=exp, rho=rho,
                        static_fallback=static_fallback, automaton=auto, kind=kind)


def _automaton_counts(index: TextIndex, auto: AutomatonPlan, end_min=None) -> torch.Tensor:
    """(B, N_input) exact counts through the packed Aho-Corasick fallback,
    linear in n whatever the candidate density (DESIGN.md §14)."""
    return count_automaton(index.text, index.lengths, auto, end_min=end_min)


def _union_blocks(index: TextIndex, plans: Sequence[PatternPlan], bank: FingerprintBank,
                  end_min=None) -> torch.Tensor:
    """(B, nblk) OR over the groups' candidate blocks."""
    nblk = -(-index.n // CAND_BLOCK)
    union = None
    for p in plans:
        h = bank.window_fp(p.m, p.kbits)
        cand = p.lut_any[h.long()] & _valid_starts(index, p.m, end_min)
        blk = _block_any(cand, nblk)
        union = blk if union is None else union | blk
    return union


def _count_groups_b_shared(index: TextIndex, plans: Sequence[PatternPlan],
                           bank: FingerprintBank, end_min=None) -> torch.Tensor:
    """Multi-group EPSMb counting with ONE shared candidate pass: the groups'
    candidate blocks are OR'd into one union, compacted and gathered once
    (spanning max_m), and each group verifies only its own patterns on the
    shared rows.  Union overflow sends every group to its fallback: the
    packed automaton when a plan carries one (counted once over the whole
    dictionary, each plan column-selecting its ids), else the slot-dense
    verify for bucketed plans and the dense compare for flat ones."""
    B, n = index.text.shape
    C = CAND_BLOCK
    nblk = -(-n // C)
    max_m = max(p.m for p in plans)
    route = _shared_b_route(index, plans)

    def fallback():
        if route.automaton is not None:
            ca = _automaton_counts(index, route.automaton, end_min)
            return torch.cat([ca[:, list(p.ids)] for p in plans], dim=1)
        outs = []
        for p in plans:
            if p.slot_off is not None:
                outs.append(_count_b_slot_dense(index, p, bank, end_min))
            else:
                outs.append(_dense_count(index, p, _dense_b, end_min))
        return torch.cat(outs, dim=1)

    if route.static_fallback:
        return fallback()
    union = _union_blocks(index, plans, bank, end_min)
    if not _within(union, route.budget):
        return fallback()

    rows_packed, bvec, bstart = _gather_candidate_rows(index, max_m, union, nblk)
    row_bank = FingerprintBank(rows_packed)
    starts = _block_starts(bstart)
    outs = []
    for p in plans:
        ok_pos = _start_gate(index, p.m, starts, bvec, end_min)
        counts = torch.zeros((B, p.n_patterns), dtype=torch.int32, device=index.device)
        if p.slot_off is not None:
            outs.append(_b_count_rows_csr(index, p, rows_packed, bvec, starts, row_bank, end_min))
        elif p.distinct:
            h = row_bank.window_fp(p.m, p.kbits)[:, :C].long()
            pid = p.lut_pid[h].long()
            sel = p.anchors[pid]  # (nb, C, nw)
            ok = p.lut_any[h]
            for i, o in enumerate(_word_offsets(p.m)):
                ok = ok & (rows_packed[:, o : o + C] == sel[:, :, i])
            outs.append(_add_counts(counts, bvec[:, None].expand_as(pid), pid, ok & ok_pos))
        else:
            ok = None
            for i, o in enumerate(_word_offsets(p.m)):
                eq = rows_packed[:, o : o + C, None] == p.anchors[None, None, :, i]
                ok = eq if ok is None else ok & eq
            ok = ok & ok_pos[:, :, None]
            counts.index_put_((bvec,), ok.sum(1, dtype=torch.int32), accumulate=True)
            outs.append(counts)
    return torch.cat(outs, dim=1)


def _dense_c(index: TextIndex, plan: PatternPlan, end_min=None) -> torch.Tensor:
    """EPSMc overflow fallback: dense shifted byte compares, exact for any m."""
    return _match_group_a(index, plan, None, end_min)


def _c_candidates(index: TextIndex, plan: PatternPlan):
    """Probe the union LUT at the strided inspected blocks.  Every occurrence
    has exactly ONE inspected block with offset j < stride inside its
    window, so candidates are found, and counted, exactly once.  Bucketed
    plans fingerprint at the widened kbits, recomputed from the text."""
    beta = EPSMC_BETA
    stride = _epsmc_stride(plan.m, beta)
    step = stride // beta
    if plan.bbits > 0:
        B_, n_ = index.text.shape
        nb = n_ // beta
        blocks = index.text[:, : nb * beta].reshape(B_, nb, beta)[:, ::step]
        ht = hash_blocks(blocks, fingerprint_weights(beta, device=index.device), plan.kbits)
    else:
        ht = index.block_fp[:, ::step]  # (B, G)
    cand = plan.lut_any[ht.long()]
    B, G = cand.shape
    noff_used = min(stride, plan.m - beta + 1)
    exp = int(B * G * min(1.0, plan.lut_pop / float(1 << plan.kbits)))
    budget = int(min(max(B * G, 1), max(64, 4 * exp + 8 * B)))
    return ht, cand, stride, noff_used, budget


def _c_rows(index: TextIndex, m: int, flat, G: int, stride: int, noff_used: int):
    """Each candidate block's window bytes: (rows (nb, front+m), bvec, bsel)."""
    B, n = index.text.shape
    bvec = flat // G
    bsel = (flat % G) * stride  # inspected block start
    front = noff_used - 1
    span = front + m
    t_pad = torch.zeros((B, front + n + span), dtype=torch.uint8, device=index.device)
    t_pad[:, front : front + n] = index.text
    rows = t_pad[bvec[:, None], bsel[:, None] + torch.arange(span, device=index.device)]
    return rows, bvec, bsel


def _c_in_row(index: TextIndex, m: int, st, bvec, end_min):
    ok = (st >= 0) & (st <= index.lengths[bvec] - m)
    if end_min is not None:
        ok = ok & (st + (m - 1) >= int(end_min))
    return ok


def _c_verify(index, plan, ht, cand, stride, noff_used, end_min=None):
    """Verify candidate blocks against all P patterns at the offsets < stride,
    gated by the LUT's pattern-id bitmask.  Returns (ok (rows, P), b (rows,),
    start (rows,)) with n as the start of a rejected row."""
    n = index.n
    m = plan.m
    G = cand.shape[1]
    flat = torch.nonzero(cand.reshape(-1)).flatten()
    rows, bvec, bsel = _c_rows(index, m, flat, G, stride, noff_used)
    front = noff_used - 1
    P = plan.n_patterns
    bits = plan.lut_bits[ht.reshape(-1)[flat].long()]  # (nb, W)
    word = torch.arange(P, device=index.device) // 32
    shift = torch.arange(P, dtype=torch.int32, device=index.device) % 32
    pgate = ((bits[:, word] >> shift[None, :]) & 1).bool()  # (nb, P)
    oks, sts = [], []
    for j in range(noff_used):
        win = rows[:, front - j : front - j + m]  # window starting at bsel - j
        st = bsel - j
        in_row = _c_in_row(index, m, st, bvec, end_min)
        ok = pgate & in_row[:, None] & (win[:, None, :] == plan.patterns[None, :, :]).all(-1)
        oks.append(ok)
        sts.append(torch.where(in_row, st, torch.full_like(st, n)))
    return torch.cat(oks), torch.cat([bvec] * noff_used), torch.cat(sts)


def _c_verify_csr(index, plan, ht, cand, stride, noff_used, end_min=None):
    """Bounded CSR verify for bucketed EPSMc plans: a candidate block's wide
    fingerprint names a slot whose entries are exactly the (pattern, offset)
    pairs that registered it; at most slot_max entries are tested.  Returns
    per-entry (ok, pid, b, start) vectors of length slot_max * nb."""
    n = index.n
    m = plan.m
    G = cand.shape[1]
    flat = torch.nonzero(cand.reshape(-1)).flatten()
    rows, bvec, bsel = _c_rows(index, m, flat, G, stride, noff_used)
    front = noff_used - 1
    h = ht.reshape(-1)[flat].long()
    base = plan.c_slot_off[h]
    cnt = plan.c_slot_off[h + 1] - base
    E = plan.c_entry_pid.shape[0]
    ar = torch.arange(m, device=index.device)[None, :]
    oks, pids, sts = [], [], []
    for j in range(plan.slot_max):
        idx = torch.clamp(base + j, max=E - 1).long()
        pid = plan.c_entry_pid[idx]
        off = plan.c_entry_off[idx].long()
        pat = plan.c_entry_pat[idx]  # (nb, m)
        win = torch.gather(rows, 1, (front - off)[:, None] + ar)
        st = bsel - off
        ok = (j < cnt) & _c_in_row(index, m, st, bvec, end_min) & (win == pat).all(-1)
        oks.append(ok)
        pids.append(pid)
        sts.append(torch.where(ok, st, torch.full_like(st, n)))
    b_all = torch.cat([bvec] * plan.slot_max)
    return torch.cat(oks), torch.cat(pids).long(), b_all, torch.cat(sts)


def _scatter_mask(B: int, P: int, n: int, b, p, st, ok) -> torch.Tensor:
    """(B, P, n) mask with True at the (b, p, st) of every ok entry.  Every
    written value is True, so duplicate indices cannot disagree."""
    out = torch.zeros((B, P, n), dtype=torch.bool, device=ok.device)
    flat = (b.long() * P + p.long()) * n + st.long()
    out.view(-1).index_fill_(0, flat[ok], True)
    return out


def _match_group_c(index: TextIndex, plan: PatternPlan, bank=None, end_min=None) -> torch.Tensor:
    del bank  # keyed by aligned block fingerprints, not window fingerprints
    B, n = index.text.shape
    P = plan.n_patterns
    if index.block_fp.shape[1] == 0:
        return _dense_c(index, plan, end_min)
    ht, cand, stride, noff_used, budget = _c_candidates(index, plan)
    if plan.c_slot_off is not None:
        # bucketed: the bounded CSR verify over every inspected block is the
        # overflow route too, keeping the adversarial bound
        gate = cand if _within(cand, budget) else torch.ones_like(cand)
        ok, pid, b_all, st_all = _c_verify_csr(index, plan, ht, gate, stride, noff_used, end_min)
        return _scatter_mask(B, P, n, b_all, pid, st_all, ok)
    if not _within(cand, budget):
        return _dense_c(index, plan, end_min)
    ok, b_all, st_all = _c_verify(index, plan, ht, cand, stride, noff_used, end_min)
    rows, cols = torch.nonzero(ok, as_tuple=True)
    return _scatter_mask(B, P, n, b_all[rows], cols, st_all[rows], torch.ones_like(rows, dtype=torch.bool))


def _count_group_c(index: TextIndex, plan: PatternPlan, bank=None, end_min=None) -> torch.Tensor:
    del bank
    B = index.batch
    if index.block_fp.shape[1] == 0:
        return _dense_c(index, plan, end_min).sum(-1, dtype=torch.int32)
    ht, cand, stride, noff_used, budget = _c_candidates(index, plan)
    counts = torch.zeros((B, plan.n_patterns), dtype=torch.int32, device=index.device)
    if plan.c_slot_off is not None:
        gate = cand if _within(cand, budget) else torch.ones_like(cand)
        ok, pid, b_all, _ = _c_verify_csr(index, plan, ht, gate, stride, noff_used, end_min)
        return _add_counts(counts, b_all, pid, ok)
    if not _within(cand, budget):
        return _dense_count(index, plan, _dense_c, end_min)
    ok, b_all, _ = _c_verify(index, plan, ht, cand, stride, noff_used, end_min)
    counts.index_put_((b_all,), ok.to(torch.int32), accumulate=True)
    return counts


def _count_group_a(index: TextIndex, plan: PatternPlan, bank=None, end_min=None) -> torch.Tensor:
    return _match_group_a(index, plan, None, end_min).sum(-1, dtype=torch.int32)


_MATCH = {"a": _match_group_a, "b": _match_group_b, "c": _match_group_c}
_COUNT = {"a": _count_group_a, "b": _count_group_b, "c": _count_group_c}


# ---------------------------------------------------------------------------
# Public joins: P patterns x B texts
# ---------------------------------------------------------------------------

def _effective_k(plan: PatternPlan, k: Optional[int]) -> int:
    """Per-plan mismatch budget: an explicit k overrides; None means what
    the plan was compiled for (0 for exact plans)."""
    return plan.k if k is None else int(k)


def _check_devices(index: TextIndex, plans: Sequence[PatternPlan]) -> None:
    for p in plans:
        if p.device != index.device:
            raise ValueError(
                f"plan on {p.device} but index on {index.device}; "
                "use replicate_plans(plans, index.device)"
            )


def match_many(index: TextIndex, plans: Sequence[PatternPlan], *, k: Optional[int] = None,
               end_min: Optional[int] = None) -> torch.Tensor:
    """bool[B, P_total, n] match-start masks, rows in plan-concatenated order
    (``plan_order`` maps them back).  ``k`` is the mismatch budget: mask[b,
    p, i] is True iff the m-byte window at i differs from pattern p in at
    most k bytes (k = 0 runs the exact matchers).  ``end_min`` keeps only
    occurrences ending at position >= end_min (the streaming seam gate)."""
    if not plans:
        return torch.zeros((index.batch, 0, index.n), dtype=torch.bool, device=index.device)
    _check_devices(index, plans)
    bank = FingerprintBank(index.packed)
    outs = []
    for p in plans:
        kk = _effective_k(p, k)
        if kk == 0:
            outs.append(_MATCH[p.regime](index, p, bank, end_min))
        else:
            from repro_torch.approx import counting

            outs.append(counting.match_group_approx(index, p, kk, end_min))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _shared_plans(index: TextIndex, plans: Sequence[PatternPlan], k, shared: bool) -> List[int]:
    """Indices of the exact EPSMb groups that take the shared sparse pass."""
    return [
        i for i, p in enumerate(plans)
        if shared and _effective_k(p, k) == 0 and p.regime == "b" and _sparse_b_eligible(index, p)
    ]


def count_many(index: TextIndex, plans: Sequence[PatternPlan], *, k: Optional[int] = None,
               end_min: Optional[int] = None, shared: bool = True) -> torch.Tensor:
    """int32[B, P_total] occurrence counts, never materializing (B, P, n) on
    the sparse routes.  Every sparse-eligible EPSMb group shares one
    candidate compaction (even a single one); ``shared=False`` counts each
    group through its own matcher, the per-group reference path.  ``k`` as
    in :func:`match_many`; the k > 0 dense path builds the (B, P, n)
    mismatch mask before reducing."""
    if not plans:
        return torch.zeros((index.batch, 0), dtype=torch.int32, device=index.device)
    _check_devices(index, plans)
    bank = FingerprintBank(index.packed)
    outs: List[Optional[torch.Tensor]] = [None] * len(plans)
    shared_idx = _shared_plans(index, plans, k, shared)
    if shared_idx:
        joint = _count_groups_b_shared(index, [plans[i] for i in shared_idx], bank, end_min)
        col = 0
        for i in shared_idx:
            P = plans[i].n_patterns
            outs[i] = joint[:, col : col + P]
            col += P
    for i, p in enumerate(plans):
        if outs[i] is None:
            kk = _effective_k(p, k)
            if kk == 0:
                outs[i] = _COUNT[p.regime](index, p, bank, end_min)
            else:
                from repro_torch.approx import counting

                outs[i] = counting.count_group_approx(index, p, kk, bank, end_min)
    return torch.cat(outs, dim=1)


def route_probe(index: TextIndex, plans: Sequence[PatternPlan], *, k: Optional[int] = None,
                end_min: Optional[int] = None, shared: bool = True,
                recorder: Optional[Recorder] = None) -> dict:
    """Which route count_many takes for (index, plans), from the same
    _shared_b_route decision and union-block measurement, without running
    the verification.  Emits a ``fallback_route`` event.  Syncs."""
    rec = _DEFAULT_REC if recorder is None else recorder
    B, n = index.text.shape
    nblk = -(-n // CAND_BLOCK)
    shared_plans = [plans[i] for i in _shared_plans(index, plans, k, shared)]
    if not shared_plans:
        info = {"route": "per_group", "kind": "none", "blocks": 0, "budget": 0,
                "total_blocks": B * nblk, "density": 0.0, "rho": 0.0, "static": True}
        rec.event("fallback_route", **info)
        return info
    route = _shared_b_route(index, shared_plans)
    blocks = 0
    if not route.static_fallback:
        union = _union_blocks(index, shared_plans, FingerprintBank(index.packed), end_min)
        blocks = int(union.sum(dtype=torch.int64))
    overflow = route.static_fallback or blocks > route.budget
    info = {
        "route": route.kind if overflow else "sparse",
        "kind": route.kind,
        "blocks": blocks,
        "budget": route.budget,
        "exp_blocks": route.exp_blocks,
        "total_blocks": B * nblk,
        "density": blocks / float(max(1, B * nblk)),
        "rho": route.rho,
        "static": bool(route.static_fallback),
    }
    rec.event("fallback_route", **info)
    return info


def any_many(index: TextIndex, plans: Sequence[PatternPlan], *, k: Optional[int] = None) -> torch.Tensor:
    """bool[B, P_total] — does pattern p occur anywhere in text b?"""
    return count_many(index, plans, k=k) > 0


def any_hit(index: TextIndex, plans: Sequence[PatternPlan], *, k: Optional[int] = None) -> torch.Tensor:
    """bool[B] — does ANY pattern occur in text b?  (blocklist predicate)"""
    return any_many(index, plans, k=k).any(dim=-1)


def blocked(texts, lengths, plans, *, device=None) -> torch.Tensor:
    """bool[B] blocklist predicate over a padded (B, L) batch of documents."""
    return any_hit(build_index(texts, lengths, device=device), tuple(plans))
