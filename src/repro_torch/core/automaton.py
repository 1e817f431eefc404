"""Packed Aho-Corasick automaton: the engine's linear-time dictionary
fallback (DESIGN.md §14), in PyTorch.

The twin of ``repro.core.automaton``.  A failure-function automaton over the
whole dictionary makes one transition per text byte, O(n + occ) whatever
the text's fingerprints collide with, so the engine sends a fingerprint
flood (or a pattern set whose slots overflow) here.  The bounded-context
property makes it parallel: with every pattern at most ``max_m`` bytes
long, the state after position i depends only on the last ``max_m`` bytes,
so a lane that owns ``seg`` positions re-derives its entry state from the
root over ``max_m - 1`` bytes of warm-up and then emits the true sequential
states of its segment.

Two compressions keep the table small: byte classes (bytes that occur in no
pattern, and the virtual boundary before the text, share class 0, whose
root row stays at the root) and CSR output lists per state (suffix-chained,
so nested patterns all fire).

On a CUDA tensor the transition scan runs the hand-written ``acscan``
kernel (``kernels/acscan``), on a CPU tensor its plain PyTorch version.
Emission differs from the reference inside and not in its result: the
reference scatters ``out_max`` times over every position; here the
kernel's counts mode sums a gated histogram of terminal states per row
(no state array in device memory), which is multiplied out over the CSR:
the same integers at O(B * n_entries) instead of O(n * out_max).  The
kernel reads private tables (``kernel_tables``), built once per plan.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.packing import as_u8, as_u8_np, resolve_device

# Constants copied from the reference (tests/test_torch_automaton.py pins
# them).  AC_SEG is the plain scan's segment width; the kernel picks its own
# (kernels/acscan/acscan.py), which gives the same states.
AC_SEG = 128
AC_MAX_STATES = 1 << 20
AC_MAX_CELLS = 1 << 25   # n_states * n_classes (int32 table entries)
AC_MAX_OUT = 128         # max suffix-chained emissions per state

ARRAY_FIELDS = ("delta", "classes", "out_off", "out_ids")
STATIC_FIELDS = ("n_states", "n_classes", "n_entries", "out_max", "max_m", "n_patterns")
# Elements of the (rows, n_entries) product one emission step materializes
_EMIT_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True)
class AutomatonPlan:
    """Packed Aho-Corasick over one pattern dictionary, tensors on one device."""

    delta: torch.Tensor    # (n_states * n_classes,) int32 flat transition table
    classes: torch.Tensor  # (256,) int32 byte -> class (0 = absent/boundary)
    out_off: torch.Tensor  # (n_states + 1,) int32 CSR offsets into out_ids
    out_ids: torch.Tensor  # (n_entries,) int32 pattern ids (input order)
    n_states: int
    n_classes: int
    n_entries: int         # >= 1 (padded)
    out_max: int           # max emissions at any single state
    max_m: int             # longest pattern (bounded-context radius)
    n_patterns: int        # output column count
    # kernel_tables(plan), built at first use; not a field of the plan's
    # contract (a copy made by to() builds its own)
    _kernel: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                      compare=False)

    @property
    def device(self) -> torch.device:
        return self.delta.device

    def to(self, device) -> "AutomatonPlan":
        dev = torch.device(device)
        return dataclasses.replace(self, **{f: getattr(self, f).to(dev) for f in ARRAY_FIELDS})


def automaton_from_numpy(fields, *, device=None) -> AutomatonPlan:
    """An AutomatonPlan from a reference automaton's fields as host values:
    a mapping (or an object with those attributes) of ``delta``,
    ``classes``, ``out_off`` and ``out_ids`` as arrays, e.g. from
    ``jax.device_get``, and the six static ints."""
    get = fields.get if isinstance(fields, dict) else (lambda f: getattr(fields, f))
    dev = resolve_device(device)
    arrays = {
        f: torch.from_numpy(np.array(np.asarray(get(f)), dtype=np.int32, order="C")).to(dev)
        for f in ARRAY_FIELDS
    }
    return AutomatonPlan(**arrays, **{f: int(get(f)) for f in STATIC_FIELDS})


def _np_patterns(patterns: Sequence) -> list:
    rows = []
    for p in patterns:
        arr = as_u8_np(p)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError("patterns must be non-empty 1-D byte strings")
        rows.append(arr)
    return rows


def compile_automaton(
    patterns: Sequence,
    *,
    max_states: int = AC_MAX_STATES,
    max_cells: int = AC_MAX_CELLS,
    max_out: int = AC_MAX_OUT,
    device=None,
) -> Optional[AutomatonPlan]:
    """Build the packed automaton on the host, or None when the dictionary
    blows a cap; the arrays go to ``device`` (default: the card).

    Output columns are the INPUT pattern order, so the engine can
    column-select any plan subset via ``plan.ids``; duplicate patterns each
    get their own column (both ids sit on the shared terminal state)."""
    rows = _np_patterns(patterns)
    if not rows:
        return None
    max_m = max(len(r) for r in rows)
    total = sum(len(r) for r in rows)
    s_max = total + 1
    present = np.zeros(256, np.bool_)
    for r in rows:
        present[r] = True
    n_classes = int(present.sum()) + 1  # class 0 = absent bytes + boundary
    if s_max > max_states or s_max * n_classes > max_cells:
        return None
    classes = np.zeros(256, np.int32)
    classes[present] = np.arange(1, n_classes, dtype=np.int32)

    # --- trie (goto) over class-mapped patterns --------------------------
    goto = np.full((s_max, n_classes), -1, np.int32)
    depth = np.zeros(s_max, np.int32)
    term: list = [[]]  # state -> pattern ids ending exactly here
    n_states = 1
    for pid, r in enumerate(rows):
        s = 0
        for c in classes[r]:
            nxt = goto[s, c]
            if nxt < 0:
                nxt = n_states
                goto[s, c] = nxt
                depth[nxt] = depth[s] + 1
                term.append([])
                n_states += 1
            s = nxt
        term[s].append(pid)
    goto = goto[:n_states]
    depth = depth[:n_states]
    term_cnt = np.asarray([len(t) for t in term], np.int64)

    # --- BFS failure links, one numpy slab per trie level ----------------
    delta = goto.copy()
    fail = np.zeros(n_states, np.int32)
    elink = np.full(n_states, -1, np.int32)  # nearest terminal suffix state
    tot = term_cnt.copy()                    # total emissions per state
    order = np.argsort(depth, kind="stable")
    level_at = np.searchsorted(depth[order], np.arange(depth.max() + 2))
    root_row = delta[0]
    root_row[root_row < 0] = 0
    for d in range(1, int(depth.max()) + 1):
        L = order[level_at[d]:level_at[d + 1]]
        if L.size == 0:
            continue
        df = delta[fail[L]]              # (len(L), n_classes) — final rows
        rowsL = delta[L]
        miss = rowsL < 0
        children = rowsL[~miss]
        fail[children] = df[~miss]
        delta[L] = np.where(miss, df, rowsL)
        fl = fail[L]
        elink[L] = np.where(term_cnt[fl] > 0, fl, elink[fl])
        tot[L] += np.where(elink[L] >= 0, tot[np.maximum(elink[L], 0)], 0)
    out_max = int(tot.max()) if n_states else 0
    if out_max > max_out:
        return None

    # --- CSR output lists (suffix-chained), filled in depth order --------
    out_off = np.zeros(n_states + 1, np.int64)
    out_off[1:] = np.cumsum(tot)
    n_entries = int(out_off[-1])
    out_ids = np.zeros(max(n_entries, 1), np.int32)
    for s in order[tot[order] > 0]:
        o = out_off[s]
        for pid in term[s]:
            out_ids[o] = pid
            o += 1
        e = elink[s]
        if e >= 0:
            span = tot[e]
            out_ids[o:o + span] = out_ids[out_off[e]:out_off[e] + span]

    return automaton_from_numpy(
        {"delta": delta.reshape(-1), "classes": classes, "out_off": out_off,
         "out_ids": out_ids, "n_states": n_states, "n_classes": n_classes,
         "n_entries": max(n_entries, 1), "out_max": out_max, "max_m": max_m,
         "n_patterns": len(rows)},
        device=device,
    )


def _segment_classes(cls: torch.Tensor, seg: int, ov: int) -> Tuple[torch.Tensor, int]:
    """(B, n) class stream -> (B, lanes, seg + ov) lane windows.  Lane L owns
    positions [L*seg, (L+1)*seg); its window starts ov bytes earlier, with
    head positions before the row mapped to class 0 (the boundary class,
    whose root row stays at the root: the state before the first byte)."""
    B, n = cls.shape
    lanes = max(1, -(-n // seg))
    npad = lanes * seg
    cls = torch.nn.functional.pad(cls, (0, npad - n))
    gpos = (
        torch.arange(lanes, device=cls.device)[:, None] * seg - ov
        + torch.arange(seg + ov, device=cls.device)[None, :]
    )  # (lanes, seg + ov)
    win = cls[:, gpos.clamp(0, npad - 1)]  # (B, lanes, seg + ov)
    return torch.where((gpos >= 0)[None, :, :], win, torch.zeros_like(win)), lanes


def automaton_states(text, auto: AutomatonPlan, *, seg: Optional[int] = None,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """(B, n) int32 automaton state AFTER consuming each byte, equal to the
    sequential scan (``kernels/acscan/ref.py:ac_states_ref``) by the
    bounded-context property, for any ``seg``.

    ``use_kernel`` None (default) runs the ``acscan`` kernel on a CUDA
    tensor and its plain version on a CPU one; False pins the plain version
    on any device; True requires the card.  ``seg`` None lets each pick its
    own segment width (AC_SEG for the plain version)."""
    from repro_torch.kernels.acscan import ops

    t = as_u8(text, auto.device)
    if t.ndim == 1:
        t = t[None, :]
    if use_kernel is None:
        fn = ops.acscan_states
    elif use_kernel:
        fn = ops.acscan_cuda
    else:
        fn = ops.acscan_states_ref
    return fn(t, auto.classes, kernel_tables(auto).states, auto.n_classes, auto.max_m, seg=seg)


@dataclasses.dataclass(frozen=True)
class KernelTables:
    """The kernel's private tables of one AutomatonPlan, on its device.

    ``counts`` renumbers the states so that the root stays 0 and the
    n_term terminal states (those with an output list) are 1..n_term, in
    plan order: "is terminal" is one compare and the histogram column is
    the state - 1.  ``states`` keeps the plan's ids.  Both hold uint16
    entries when the ids fit (n_states <= 65536), else int32."""

    states: torch.Tensor   # (n_states * n_classes,) plan ids
    counts: torch.Tensor   # (n_states * n_classes,) private ids
    n_term: int
    entry_t: torch.Tensor  # (n_entries,) int64: histogram column of each CSR entry


def table_dtype(n_states: int) -> torch.dtype:
    """uint16 exactly when every state id fits in 16 bits."""
    return torch.uint16 if int(n_states) <= 1 << 16 else torch.int32


def _build_kernel_tables(auto: AutomatonPlan) -> KernelTables:
    S, C = auto.n_states, auto.n_classes
    dev = auto.device
    dtype = table_dtype(S)
    delta = auto.delta.view(S, C).long()
    tot = auto.out_off[1:] - auto.out_off[:-1]
    term = tot > 0
    ids = torch.arange(S, device=dev)
    term_ids, rest_ids = ids[term], ids[~term]  # the root (never terminal) leads rest_ids
    order = torch.cat([rest_ids[:1], term_ids, rest_ids[1:]])
    priv = torch.empty_like(order)
    priv[order] = ids
    counts = torch.empty_like(delta)
    counts[priv] = priv[delta]
    entry_state = torch.repeat_interleave(ids, tot.long(), output_size=auto.n_entries)
    states = auto.delta if dtype == torch.int32 else auto.delta.to(dtype)
    return KernelTables(states=states, counts=counts.reshape(-1).to(dtype),
                        n_term=int(term_ids.numel()), entry_t=priv[entry_state] - 1)


def kernel_tables(auto: AutomatonPlan) -> KernelTables:
    """The plan's KernelTables, built at the first call and kept with it."""
    kt = auto._kernel.get("tables")
    if kt is None:
        kt = auto._kernel["tables"] = _build_kernel_tables(auto)
    return kt


def count_automaton(text, lengths, auto: AutomatonPlan, *, end_min=None,
                    seg: Optional[int] = None, use_kernel: Optional[bool] = None) -> torch.Tensor:
    """int32 (B, n_patterns) occurrence counts in input pattern order.

    Same semantics as the reference and as engine.count_many: an occurrence
    counts when it ENDS inside the row's true length, and ``end_min`` keeps
    only occurrences ending at or past it (the streaming seam gate).  The
    scan is O(n) transitions and sums a gated histogram of terminal states
    per row (the ``acscan`` kernel's counts mode on a CUDA tensor, its plain
    version on a CPU one; ``use_kernel`` as in ``automaton_states``), which
    is multiplied out over the CSR output lists.  No call syncs the host
    after the plan's first."""
    from repro_torch.kernels.acscan import ops

    t = as_u8(text, auto.device)
    if t.ndim == 1:
        t = t[None, :]
    B, n = t.shape
    if n == 0 or B == 0:
        return torch.zeros((B, auto.n_patterns), dtype=torch.int32, device=t.device)
    kt = kernel_tables(auto)
    if use_kernel is None:
        fn = ops.acscan_counts
    elif use_kernel:
        fn = ops.acscan_counts_cuda
    else:
        fn = ops.acscan_counts_ref
    lengths = torch.as_tensor(lengths).to(device=t.device, dtype=torch.int64).reshape(B)
    hist = fn(t, auto.classes, kt.counts, auto.n_classes, kt.n_term, auto.max_m, lengths,
              end_min=end_min, seg=seg)
    return _counts_from_hist(hist, auto)


def _counts_from_hist(hist: torch.Tensor, auto: AutomatonPlan) -> torch.Tensor:
    """int32 (B, n_patterns): a (B, n_term) terminal-state histogram
    multiplied out over the plan's CSR output lists."""
    kt = kernel_tables(auto)
    B = hist.shape[0]
    counts = torch.zeros((B, auto.n_patterns), dtype=torch.int64, device=hist.device)
    step = max(1, _EMIT_ELEMS // max(1, auto.n_entries))
    ids = auto.out_ids.long()
    for r in range(0, B, step):
        counts[r : r + step].index_add_(1, ids, hist[r : r + step][:, kt.entry_t].long())
    return counts.to(torch.int32)
