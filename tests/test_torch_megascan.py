"""repro_torch.kernels.megascan against repro.kernels.megascan, bit for bit.

Mirrors tests/test_megascan.py: the op's counts for every grid shape (1 to
3 tiles, partial and exact), the seam phases, the k-mismatch 'x' groups, the
eligibility rules (at the card's rule: the reference's halo and group rules,
with shared memory in place of the VMEM budget), and the
StreamScanner(use_kernel=True) integration with its one-dispatch-per-chunk
contract, its default by device and its logged fallback.  The port runs on the CPU, where the op
runs its plain version; the reference side is its engine oracle
(``megascan_count_window_ref``) and, in one small case, the Pallas kernel in
interpret mode (the engine oracle is the reference's ``megascan_count_window_ref``
with the window's valid length, jitted).  No tolerance anywhere.
"""

import ctypes
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as R
from repro.core.stream import StreamScanner as RScanner
from repro.kernels import megascan as RM
from repro_torch.core import engine as E
from repro_torch.core.stream import StreamScanner
from repro_torch.kernels.megascan import (
    build_mega_spec,
    megascan_count_window,
    megascan_count_window_ref,
)
from repro_torch.kernels.megascan import megascan as MK
from repro_torch.kernels.megascan import ops as MO
from repro_torch.kernels.megascan.ref import megascan_candidates_ref
from repro_torch.obs.recorder import Recorder

from conftest import make_text

CPU = "cpu"
LENGTHS = (2, 5, 8, 13, 16, 24)  # regimes a, b (three), c (two)


@pytest.fixture
def rng():
    """A fresh generator per test, so no test's data depends on which tests
    ran before it in the same process."""
    return np.random.RandomState(0x3E6A)


def _patterns(rng, text, lengths):
    """One extracted pattern per length that fits the text, one random."""
    pats = []
    for m in lengths:
        if m <= len(text):
            s = rng.randint(0, len(text) - m + 1)
            pats.append(text[s : s + m].copy())
        pats.append(rng.randint(0, 5, size=m).astype(np.uint8))
    return pats


@functools.partial(jax.jit, static_argnames=("k",))
def _ref_counts(window, length, plans, end_min, *, k):
    """The reference's megascan oracle (count_many with end_min) for a window
    whose first ``length`` bytes are valid, jitted so seam phases share one
    compile."""
    return R.count_many(R.build_index(window, length[None]), plans, k=k, end_min=end_min)[0]


def _check(window, pats, *, k=0, length=None, prev_ov=0, ref_spec=True):
    """Port op (plain version on the CPU) == reference engine oracle."""
    rp = R.compile_patterns(pats, k=k)
    pp = E.compile_patterns(pats, k=k, device=CPU)
    spec = build_mega_spec(pp, k=k or None)
    assert spec is not None
    n = len(window)
    got = megascan_count_window(torch.from_numpy(window), pp, spec, length=length, prev_ov=prev_ov)
    want = np.asarray(_ref_counts(window, np.int32(n if length is None else length), rp,
                                  np.int32(prev_ov), k=k or None))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n={n} L={length} ov={prev_ov} k={k}")
    np.testing.assert_array_equal(
        megascan_count_window_ref(window, pp, k=k or None, length=length, prev_ov=prev_ov).numpy(), want)
    if ref_spec:  # the groups are the reference's (its VMEM rule aside)
        rspec = RM.build_mega_spec(rp, k=k or None)
        assert [(g.kind, g.m, g.n_patterns, g.kbits, g.col, g.k, g.use_lut, g.stride, g.noff_used)
                for g in rspec.groups] == [
            (g.kind, g.m, g.n_patterns, g.kbits, g.col, g.k, g.use_lut, g.stride, g.noff_used)
            for g in spec.groups]
    return got, pp


@pytest.mark.parametrize("n", [1, 200, 4095, 4096, 4097, 8192, 9000])
def test_op_matches_reference_every_grid_shape(rng, n):
    """Windows of 1 to 3 tiles of 4096, exact and partial, over an a/b/c mix;
    extracted patterns really hit."""
    text = make_text(rng, n, 4)
    pats = _patterns(rng, text, LENGTHS if n > 1 else (1, 2))
    got, pp = _check(text, pats)
    for row, pid in enumerate(E.plan_order(pp)):
        m = len(pats[pid])
        want = np.lib.stride_tricks.sliding_window_view(text, m) if m <= n else np.zeros((0, m))
        assert int(got[row]) == int((want == pats[pid]).all(-1).sum())


@pytest.mark.parametrize("prev_ov", [0, 1, 13, 31, 100])
def test_seam_phases_and_short_windows(rng, prev_ov):
    """The seam gate start + m - 1 >= prev_ov at aligned and unaligned
    phases, with the window's valid length L below its size (a last chunk,
    bytes past L nonzero garbage) and at it."""
    text = make_text(rng, 5000, 4)
    pats = _patterns(rng, text, LENGTHS)
    for length in (None, 4500, 4096, 40):
        _check(text, pats, length=length, prev_ov=min(prev_ov, length or 5000))


@pytest.mark.parametrize("k", [1, 2])
def test_k_mismatch_groups(rng, k):
    """k > 0 routes every group through the 'x' matcher, relaxed-LUT gated
    where the plan carries one; identity holds with the seam gate."""
    text = make_text(rng, 3000, 4)
    pats = _patterns(rng, text, (2, 5, 8, 13, 16))
    for ov in (0, 13):
        _check(text, pats, k=k, prev_ov=ov)
    pp = E.compile_patterns(pats, k=k, device=CPU)
    spec = build_mega_spec(pp)
    assert all(g.kind == "x" and g.k == k for g in spec.groups)
    assert any(g.use_lut for g in spec.groups) == (k == 1)


def test_plain_version_takes_no_kernel_route(rng, monkeypatch):
    """The plain version counts 'x' groups with the dense mismatch count in
    plain PyTorch, never through the engine's k-mismatch mask route (which
    runs the approx kernel on the card), and still equals the reference."""
    from repro_torch.approx import counting as PC

    def refuse(*a, **kw):
        raise AssertionError("the plain version reached match_group_approx")

    monkeypatch.setattr(PC, "match_group_approx", refuse)
    text = make_text(rng, 3000, 4)
    pats = _patterns(rng, text, (2, 5, 8, 13, 16))
    _check(text, pats, k=1, length=2900, prev_ov=13)
    _check(text, pats, k=0, prev_ov=13)  # exact groups: count_many's plain routes


def test_trailing_zero_pattern_and_flood(rng):
    """Patterns ending in 0x00 count at the window's end with L = n and not
    where only the zero padding past L completes them; a flood counts every
    start."""
    text = (make_text(rng, 3000, 255) + 1).astype(np.uint8)
    text[-1] = 0
    pats = [text[-m:].copy() for m in (3, 8, 24)]
    full, _ = _check(text, pats)
    trap, _ = _check(text, pats, length=len(text) - 1)
    assert (full - trap).tolist() == [1, 1, 1]
    _check(text, pats, k=1, length=len(text) - 1)
    flood = np.full(9000, ord("A"), np.uint8)
    got, pp = _check(flood, [b"AAA", b"A" * 8, b"A" * 24, b"AAAAAAAB"])
    assert sorted(got.tolist()) == [0, 9000 - 23, 9000 - 7, 9000 - 2]


def test_pallas_kernel_agrees_in_interpret_mode(rng):
    """The reference's Pallas megakernel (interpret mode, one small case)
    gives the port op's counts."""
    text = make_text(rng, 700, 4)
    pats = _patterns(rng, text, (2, 8, 16))
    rp = R.compile_patterns(pats)
    rspec = RM.build_mega_spec(rp, tile=256)
    want = np.asarray(RM.megascan_count_window(text, rp, rspec, prev_ov=13, interpret=True))
    pp = E.compile_patterns(pats, device=CPU)
    got = megascan_count_window(torch.from_numpy(text), pp, build_mega_spec(pp), prev_ov=13)
    np.testing.assert_array_equal(got.numpy(), want)


def test_spec_eligibility_rules(rng):
    """build_mega_spec is None for every ineligibility of the card's rule:
    m past 4096 - 3, EPSMc stride + m past 4096 (m = 2055 gives 4095 and is
    eligible; no m gives exactly 4096, m = 2056 gives 4104), more than 512
    patterns a group, a bucketed EPSMc plan, k past 127, too many counters
    for shared memory, and an empty set."""
    text = make_text(rng, 9000, 4)

    def spec(lengths, k=0, **kw):
        pats = [text[:m].copy() for m in lengths]
        return build_mega_spec(E.compile_patterns(pats, k=k, device=CPU, **kw), k=k or None)

    assert spec((4093,), k=1) is not None and spec((4094,), k=1) is None
    assert spec((2055,)) is not None and spec((2056,)) is None
    assert RM.build_mega_spec(R.compile_patterns([text[:2056]])) is None  # the reference agrees
    assert spec((8,), k=127) is not None and spec((8,), k=128) is None
    assert build_mega_spec([]) is None
    many = [bytes(p) for p in np.unique(rng.randint(0, 256, (1200, 20)).astype(np.uint8), axis=0)]
    assert build_mega_spec(E.compile_patterns(many[:512], bucket=False, device=CPU)) is not None
    assert build_mega_spec(E.compile_patterns(many[:513], bucket=False, device=CPU)) is None
    assert build_mega_spec(E.compile_patterns(many[:200], bucket=True, device=CPU)) is None
    # counters: the staged bytes (the tile, a 16-byte back halo for the 'c'
    # stride 8 of m = 20, a 32-byte forward halo for m - 1 + 3, 16 bytes of
    # slack) plus 4 per pattern within 227 KB, that is 56,000 counters: 111
    # groups of 512 fit, 112 do not (three staged tiles let only 107 fit)
    assert MO.SMEM_BUDGET == 227 * 1024 and MK.staged_bytes(16, 32) == 4160
    (g512,) = E.compile_patterns(many[:512], bucket=False, device=CPU)
    s = build_mega_spec([g512] * 111)
    assert (s.halo_back, s.halo_fwd) == (16, 32)
    assert s is not None and s.smem_bytes == 4160 + 4 * 512 * 111 <= MO.SMEM_BUDGET
    assert build_mega_spec([g512] * 112) is None


def _old_rule_accepts(plans, k=None) -> bool:
    """Eligibility as it stood with three staged tiles: the same group
    rules, 3 * 4096 + 16 staged bytes plus 4 per pattern within 227 KB."""
    p_total = 0
    for p in plans:
        kk = E._effective_k(p, k)
        if p.m > 4093 or p.n_patterns > 512 or kk > 127:
            return False
        if kk == 0 and p.regime == "c" and (p.lut_bits is None or E._epsmc_stride(p.m, 8) + p.m > 4096):
            return False
        p_total += p.n_patterns
    return 3 * 4096 + 16 + 4 * p_total <= MO.SMEM_BUDGET


def test_spec_keeps_eligibility_and_states_its_shared_memory(rng):
    """Every set the three-tile rule accepted is still accepted; the halos
    are the largest 'c' stride - 1 and the largest m - 1 + 3, each rounded
    up to 16; smem_bytes is the launcher's formula (staged bytes and
    counters); the 'a' tables, read from global memory, take none of it."""
    text = make_text(rng, 9000, 16)
    cases = [(LENGTHS, 0), ((2, 3, 40), 0), ((5, 2055), 0), ((4093,), 1), ((3, 17, 100), 2),
             ((1, 2, 3), 0), ((200, 2055, 24), 0), ((5, 9), 1)]
    for lengths, k in cases:
        for per in (1, 33, 300):
            pats = [text[s : s + m].copy() for m in lengths for s in rng.randint(0, 9000 - m, per)]
            pp = E.compile_patterns(pats, k=k, bucket=False, device=CPU)
            spec = build_mega_spec(pp, k=k or None)
            assert _old_rule_accepts(pp, k or None) <= (spec is not None), (lengths, k, per)
            if spec is None:
                continue
            strides = [g.stride for g in spec.groups if g.kind == "c"]
            assert spec.halo_back == MK.round16(max(strides, default=1) - 1)
            assert spec.halo_fwd == MK.round16(max(g.m for g in spec.groups) + 2)
            assert spec.smem_bytes == MK.smem_bytes(spec.halo_back, spec.halo_fwd,
                                                    spec.p_total) <= MO.SMEM_BUDGET
            for g in spec.groups:
                if g.kind == "a":
                    assert 4 * (-(-g.n_patterns // 32) << g.abits) <= MK.A_TABLE_BYTES
    # 110 'a' groups of 512 patterns, 880 KB of private tables: the block
    # holds only the staged text and the counters
    (g512,) = E.compile_patterns([bytes(p) for p in np.unique(rng.randint(0, 256, (600, 3)).astype(
        np.uint8), axis=0)[:512]], device=CPU)
    s = build_mega_spec([g512] * 110)
    assert s is not None and s.smem_bytes == MK.smem_bytes(0, 16, 512 * 110)


def test_group_table_layout(rng):
    """The ctypes Group record matches the CUDA struct (12 ints, 5 pointers,
    88 bytes) and a table holds one record per group, pointing at the
    private tables ('a' always, 'b' without lut_pid) and at lut_pid; the
    launch wrapper refuses a CPU window."""
    assert ctypes.sizeof(MK._Group) == 88 and ctypes.sizeof(MK._Weights) == 32
    text = make_text(rng, 3000, 4)
    pats = _patterns(rng, text, LENGTHS)
    pp = E.compile_patterns(pats, device=CPU)
    spec = build_mega_spec(pp)
    table = MK.group_table(pp, spec)
    assert table.dtype == torch.uint8 and table.numel() == 88 * len(spec.groups)
    assert MK.group_table(pp, spec) is table  # cached per (spec, plans)
    recs = (MK._Group * len(spec.groups)).from_buffer_copy(table.numpy().tobytes())
    assert [r.kind for r in recs] == [MK.KINDS[g.kind] for g in spec.groups]
    assert [r.col for r in recs] == [g.col for g in spec.groups]
    assert [r.abits for r in recs] == [g.abits for g in spec.groups]
    for r, plan, g in zip(recs, pp, spec.groups):
        assert bool(r.pid) == (g.kind == "b" and plan.lut_pid is not None)
        assert bool(r.bits) == (g.kind in "ac" or (g.kind == "b" and plan.lut_pid is None))
        assert r.W == (0 if g.kind in "bx" and plan.lut_pid is not None or g.kind == "x"
                       else -(-g.n_patterns // 32))
    nd = E.compile_patterns([text[s : s + 5] for s in rng.randint(0, 2990, 20)], kbits=6,
                            device=CPU)  # 20 patterns in 64 fingerprints: they collide
    assert any(p.regime == "b" and not p.distinct for p in nd)
    recs = (MK._Group * len(nd)).from_buffer_copy(MK.group_table(nd, build_mega_spec(nd)).numpy().tobytes())
    assert all(r.bits and not r.pid for r, p in zip(recs, nd) if p.regime == "b" and not p.distinct)
    with pytest.raises(ValueError, match="CUDA"):
        MK.megascan_cuda(torch.from_numpy(text), pp, spec, length=3000, prev_ov=0,
                         out=torch.zeros(spec.p_total, dtype=torch.int32))


def _assert_candidates_cover(text, pp, spec, want, *, prev_ov=0, length=None):
    """The kernel's candidate step (its plain version) flags every
    occurrence of every 'a' and 'b' pattern, and counting the flagged
    occurrences gives ``want``'s columns of those groups."""
    n = len(text)
    L = n if length is None else length
    cands = megascan_candidates_ref(text, pp, spec, length=length, prev_ov=prev_ov)
    checked = 0
    for plan, g, cand in zip(pp, spec.groups, cands):
        if cand is None:
            assert g.kind in "cx"
            continue
        win = np.lib.stride_tricks.sliding_window_view(np.concatenate([text, np.zeros(g.m, np.uint8)]), g.m)[:n]
        occ = (win[None] == plan.patterns.numpy()[:, None, :]).all(-1)
        pos = np.arange(n)
        occ &= (pos <= L - g.m) & (pos + g.m - 1 >= prev_ov)
        flagged = cand.numpy()
        assert flagged.shape == occ.shape and not (occ & ~flagged).any(), f"{g.kind} m={g.m}: missed"
        np.testing.assert_array_equal((occ & flagged).sum(-1), want[g.col : g.col + g.n_patterns])
        checked += 1
    return checked


@pytest.mark.parametrize("case", ["duplicates", "nondistinct_b", "P33"])
def test_candidate_step_flags_every_pallas_occurrence(rng, case):
    """The private tables' candidate step ('a' gram table, 'b' lut_pid or
    private fingerprint table) flags every occurrence the reference's
    Pallas megakernel counts (interpret mode): duplicate patterns, a 'b'
    plan whose fingerprints collide (kbits = 5), and W = 2 (P = 33)."""
    text = make_text(rng, 700, 4)
    kw = {}
    if case == "duplicates":
        pats = _patterns(rng, text, (2, 3, 6, 9, 16))
        pats += [pats[0].copy(), pats[2].copy(), pats[2].copy(), pats[4].copy()]
    elif case == "nondistinct_b":
        pats = [text[s : s + m].copy() for m in (5, 7) for s in rng.randint(0, 690, 16)]
        kw = {"kbits": 5}
    else:
        pats = [text[s : s + m].copy() for m in (3, 7) for s in rng.randint(0, 690, 33)]
    rp = R.compile_patterns(pats, **kw)
    pp = E.compile_patterns(pats, device=CPU, **kw)
    if case == "nondistinct_b":
        assert not any(p.distinct for p in pp)
    spec = build_mega_spec(pp)
    if case == "P33":
        assert {(g.kind, -(-g.n_patterns // 32)) for g in spec.groups} == {("a", 2), ("b", 2)}
    want = np.asarray(RM.megascan_count_window(text, rp, RM.build_mega_spec(rp, tile=256), prev_ov=13,
                                               interpret=True))
    np.testing.assert_array_equal(megascan_count_window(torch.from_numpy(text), pp, spec, prev_ov=13).numpy(),
                                  want)
    assert _assert_candidates_cover(text, pp, spec, want, prev_ov=13) == (
        4 if case == "duplicates" else 2)


def test_candidate_step_with_512_patterns_a_group(rng):
    """P = 512 in one 'a' group (W = 16, the table at 128 rows) and one 'b'
    group: the candidate step flags every occurrence of the reference's
    engine counts, at an unaligned seam and a short valid length."""
    text = make_text(rng, 6000, 16)
    grams = np.unique(np.lib.stride_tricks.sliding_window_view(text, 3), axis=0)
    words = np.unique(np.lib.stride_tricks.sliding_window_view(text, 6), axis=0)
    pats = list(grams[rng.permutation(len(grams))[:512]]) + list(words[rng.permutation(len(words))[:512]])
    rp = R.compile_patterns(pats, bucket=False)
    pp = E.compile_patterns(pats, bucket=False, device=CPU)
    spec = build_mega_spec(pp)
    assert [(g.kind, g.n_patterns) for g in spec.groups] == [("a", 512), ("b", 512)]
    assert spec.groups[0].abits == 7
    want = np.asarray(_ref_counts(text, np.int32(5900), rp, np.int32(31), k=None))
    got = megascan_count_window(torch.from_numpy(text), pp, spec, length=5900, prev_ov=31)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _assert_candidates_cover(text, pp, spec, want, prev_ov=31, length=5900) == 2
    assert want.sum() > 1000


def test_stream_scanner_use_kernel_bit_identity(rng):
    """StreamScanner(use_kernel=True) counts through the op, one dispatch per
    chunk, equal to the reference's two-pass scanner and the resident engine."""
    text = make_text(rng, 20_000, 4)
    pats = _patterns(rng, text, LENGTHS)
    want = RScanner(R.compile_patterns(pats), 2048, fused=False).count_many(text)
    pp = E.compile_patterns(pats, device=CPU)
    sc = StreamScanner(pp, 2048, use_kernel=True)
    assert sc.spec is not None
    n_windows = sum(1 for _ in sc._windows(text))
    before = MK.megascan_cuda.launches
    got = sc.count_many(text)
    assert sc.dispatch_count == n_windows
    assert MK.megascan_cuda.launches == before  # the plain version ran on the CPU
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, E.count_many(E.build_index(text, device=CPU), pp)[0].numpy())


def test_stream_scanner_default_path_follows_the_device(rng):
    """use_kernel=None (the default) takes megascan on a CUDA device only: on
    the CPU the scanner keeps the fused PyTorch steps with no fallback
    event, and True takes the op (its plain version here)."""
    text = make_text(rng, 6_000, 4)
    pp = E.compile_patterns(_patterns(rng, text, LENGTHS), device=CPU)
    rec = Recorder(enabled=True)
    sc = StreamScanner(pp, 2048, recorder=rec)
    assert sc.spec is None and not rec.events_named("kernel_fallback")
    on = StreamScanner(pp, 2048, use_kernel=True)
    assert on.spec is not None
    np.testing.assert_array_equal(sc.count_many(text), on.count_many(text))


def test_stream_scanner_use_kernel_falls_back(rng):
    """An ineligible plan set is a static, logged decision: spec is None, a
    kernel_fallback event is recorded, and the fused path stays exact."""
    text = make_text(rng, 8_000, 4)
    pats = [text[100:164].copy()]
    rec = Recorder(enabled=True)
    pp = E.compile_patterns(pats, k=200, device=CPU)  # k > 127: past the int8 clamp
    sc = StreamScanner(pp, 2048, k=200, use_kernel=True, recorder=rec)
    assert sc.spec is None and len(rec.events_named("kernel_fallback")) == 1
    want = RScanner(R.compile_patterns(pats, k=200), 2048, k=200, fused=False).count_many(text)
    np.testing.assert_array_equal(sc.count_many(text), want)
