"""repro_torch.core.automaton and the engine's automaton route against
repro.core.automaton / repro.core.engine, bit for bit.

Mirrors the automaton cases of tests/test_dictionary.py at small sizes:
the compiled arrays and caps, the segmented scan against the sequential
oracle (a pattern holding byte 0x00 included), counts with ragged lengths
and the streaming seam gate, the adversarial flood that reroutes the
shared pass to the automaton (a spy shows the port's route was reached),
reference plans carried across, replication, and a streamed dictionary;
and the kernel's counts mode by its plain version (acscan_counts_ref) and
the private tables it reads (renumbered, uint16 where the ids fit, built
once per plan).  The port runs on the CPU, where the acscan ops run their
plain versions; the
reference's Pallas acscan kernel runs once, in interpret mode, on a tiny
input.  No tolerance anywhere.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import automaton as RA
from repro.core import engine as R
from repro.core import stream as RS
from repro.kernels.acscan.ref import ac_states_ref as ref_ac_states_ref
from repro_torch.core import automaton as A
from repro_torch.core import engine as E
from repro_torch.core import stream as S
from repro_torch.kernels.acscan import ops as acscan_ops
from repro_torch.kernels.acscan.acscan import acscan_counts_cuda, acscan_cuda, kernel_seg
from repro_torch.kernels.acscan.ref import (ac_states_ref, acscan_counts_ref, acscan_states_ref,
                                            count_ref)

from conftest import make_text

CPU = "cpu"


@pytest.fixture
def rng():
    return np.random.RandomState(0xAC5CA)


def _np(x):
    return np.asarray(jax.device_get(x))


def _ref_auto_fields(auto) -> dict:
    """A reference automaton's fields as host values (the device_get side)."""
    d = {f: getattr(auto, f) for f in A.STATIC_FIELDS}
    d.update({f: _np(getattr(auto, f)) for f in A.ARRAY_FIELDS})
    return d


def _dict_patterns(rng, P, m, sigma=256):
    pats = np.unique(rng.randint(0, sigma, size=(P * 2, m)).astype(np.uint8), axis=0)
    assert pats.shape[0] >= P
    return [p for p in pats[:P]]


def _zero_byte_patterns(rng):
    """Mixed lengths over a 3-letter alphabet plus 0x00, a duplicate and an
    embedded substring: class 0 (absent bytes and the boundary) must not be
    confused with byte 0x00's own class."""
    pats = [rng.randint(0, 3, size=m).astype(np.uint8) for m in (2, 3, 5, 8, 8, 11)]
    pats[1][1] = 0
    pats[3][0] = 0
    pats.append(pats[0].copy())
    pats.append(pats[3][2:7].copy())
    return pats


def test_constants_match_reference():
    assert (A.AC_SEG, A.AC_MAX_STATES, A.AC_MAX_CELLS, A.AC_MAX_OUT) == (
        RA.AC_SEG, RA.AC_MAX_STATES, RA.AC_MAX_CELLS, RA.AC_MAX_OUT)
    assert kernel_seg(14) == 132 and kernel_seg(1999) == 2004 and kernel_seg(2000) == 2004
    assert all((kernel_seg(ov) // 4) % 2 == 1 and kernel_seg(ov) >= ov for ov in range(0, 600))


@pytest.mark.parametrize("case", ["zero_byte", "dict", "caps"])
def test_compile_automaton_equals_reference(rng, case):
    if case == "caps":
        pats = [np.arange(64, dtype=np.uint8) + i for i in range(4)]
        for kw in ({"max_states": 8}, {"max_cells": 100}, {"max_out": 0}):
            assert RA.compile_automaton(pats, **kw) is None
            assert A.compile_automaton(pats, device=CPU, **kw) is None
        assert A.compile_automaton([], device=CPU) is None
        return
    pats = _zero_byte_patterns(rng) if case == "zero_byte" else _dict_patterns(rng, 300, 6, 8)
    want = RA.compile_automaton(pats)
    got = A.compile_automaton(pats, device=CPU)
    for f in A.STATIC_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for f in A.ARRAY_FIELDS:
        t = getattr(got, f)
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), _np(getattr(want, f)), err_msg=f)
    if case == "zero_byte":
        assert int(got.classes[0]) != 0  # byte 0x00 has a class of its own


@pytest.mark.parametrize("seg", [64, 128])
def test_automaton_states_equal_reference_and_sequential(rng, seg):
    pats = _zero_byte_patterns(rng)
    auto, rauto = A.compile_automaton(pats, device=CPU), RA.compile_automaton(pats)
    text = make_text(rng, 2 * 700, 3).reshape(2, 700)
    text[0, :9] = 0  # a run of 0x00 right at the row's start
    got = A.automaton_states(torch.from_numpy(text), auto, seg=seg)
    assert got.dtype == torch.int32 and got.shape == (2, 700)
    want = _np(RA.automaton_states(text, rauto, seg=seg))
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(2):
        seq = ac_states_ref(text[b], auto.classes.numpy(), auto.delta.numpy(), auto.n_classes)
        np.testing.assert_array_equal(got[b].numpy(), seq)
        np.testing.assert_array_equal(
            seq, ref_ac_states_ref(text[b], _np(rauto.classes), _np(rauto.delta), rauto.n_classes))
    # any segment width gives the same states, the kernel's own included
    for s in (1, 7, kernel_seg(auto.max_m - 1), 1000):
        np.testing.assert_array_equal(
            A.automaton_states(torch.from_numpy(text), auto, seg=s).numpy(), want)


def test_automaton_states_edges_and_reference_kernel_once(rng):
    """n = 0, n < seg, n = seg +- 1; and the reference's Pallas kernel
    (interpret mode, once, on a tiny input) against the port's scan."""
    pats = _zero_byte_patterns(rng)
    auto, rauto = A.compile_automaton(pats, device=CPU), RA.compile_automaton(pats)
    assert A.automaton_states(torch.zeros((3, 0), dtype=torch.uint8), auto).shape == (3, 0)
    for n in (1, 63, 64, 65):
        text = make_text(rng, n, 3)[None, :]
        got = A.automaton_states(torch.from_numpy(text), auto, seg=64).numpy()
        np.testing.assert_array_equal(
            got[0], ac_states_ref(text[0], auto.classes.numpy(), auto.delta.numpy(),
                                  auto.n_classes))
    text = make_text(rng, 90, 3)[None, :]
    want = _np(RA.automaton_states(text, rauto, seg=32, use_kernel=True))
    np.testing.assert_array_equal(A.automaton_states(torch.from_numpy(text), auto, seg=32).numpy(),
                                  want)


def test_acscan_op_dispatch_on_cpu(rng):
    """On a CPU tensor the op runs the plain version; the kernel wrapper
    refuses it (the kernel runs only on the card)."""
    pats = _zero_byte_patterns(rng)
    auto = A.compile_automaton(pats, device=CPU)
    text = torch.from_numpy(make_text(rng, 300, 3)[None, :])
    before = acscan_cuda.launches
    got = acscan_ops.acscan_states(text, auto.classes, auto.delta, auto.n_classes, auto.max_m)
    np.testing.assert_array_equal(got.numpy(), A.automaton_states(text, auto, use_kernel=False).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        A.automaton_states(text, auto, use_kernel=True)
    assert acscan_cuda.launches == before


def test_count_automaton_lengths_end_min_vs_reference(rng):
    pats = _zero_byte_patterns(rng)
    auto, rauto = A.compile_automaton(pats, device=CPU), RA.compile_automaton(pats)
    text = make_text(rng, 3 * 777, 3).reshape(3, 777)
    lengths = np.array([777, 640, 0])
    for end_min in (None, 0, 100, 776):
        got = A.count_automaton(torch.from_numpy(text), lengths, auto, end_min=end_min)
        assert got.dtype == torch.int32 and got.shape == (3, len(pats))
        want = _np(RA.count_automaton(text, lengths, rauto, end_min=end_min))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"end_min={end_min}")
        if end_min is None:
            for b in range(3):
                np.testing.assert_array_equal(got[b].numpy(), count_ref(text[b], lengths[b], pats))


def test_flood_routes_to_automaton_and_counts_equal_reference(rng, monkeypatch):
    """The shrunk flood of test_adversarial_flood_routes_and_counts: average
    text stays sparse, the dictionary tiled end to end overflows the union
    budget and reroutes to the automaton, with the reference's counts."""
    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 0)
    monkeypatch.setattr(R, "SPARSE_B_MIN_ELEMS", 0)
    P, m, n = 1100, 8, 1 << 18
    pats = _dict_patterns(rng, P, m)
    plans = E.compile_patterns(pats, bucket=True, automaton=True, device=CPU)
    rplans = R.compile_patterns(pats, bucket=True, automaton=True)
    assert all(p.automaton is plans[0].automaton is not None for p in plans)
    avg = make_text(rng, n, 256)
    for i in range(0, P, 7):
        avg[(i * 131) % (n - m):][:m] = pats[i]
    flood = np.concatenate([pats[i % P] for i in range(n // m + 1)])[:n]
    calls = []
    orig = E._automaton_counts
    monkeypatch.setattr(E, "_automaton_counts", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    info_a = E.route_probe(E.build_index(avg, device=CPU), plans)
    assert info_a == R.route_probe(R.build_index(avg), rplans) and info_a["route"] == "sparse"
    idx = E.build_index(flood, device=CPU)
    info_f = E.route_probe(idx, plans)
    assert info_f == R.route_probe(R.build_index(flood), rplans)
    assert info_f["route"] == "automaton" and info_f["blocks"] > info_f["budget"]
    got = E.count_many(idx, plans)
    assert calls == [1]
    np.testing.assert_array_equal(got.numpy(), _np(R.count_many(R.build_index(flood), rplans)))
    flat = E.compile_patterns(pats, bucket=False, automaton=False, device=CPU)
    assert torch.equal(got, E.count_many(idx, flat))


def test_slot_cap_hit_routes_statically_to_automaton(rng):
    """A pattern set whose slot overflows SLOT_VERIFY_CAP (70 copies of one
    pattern) skips the sparse pass statically when it has an automaton,
    and keeps the slot-dense route without one (the reference's
    slot_cap_hit term)."""
    pats = _dict_patterns(rng, 1000, 6) + [b"qwerty"] * 70
    text = make_text(rng, 1 << 12, 256)
    text[100:106] = np.frombuffer(b"qwerty", np.uint8)
    for automaton in ("auto", False):
        plans = E.compile_patterns(pats, automaton=automaton, device=CPU)
        rplans = R.compile_patterns(pats, automaton=automaton)
        idx, ridx = E.build_index(text, device=CPU), R.build_index(text)
        got, want = E._shared_b_route(idx, plans), R._shared_b_route(ridx, rplans)
        assert (got.static_fallback, got.kind) == (want.static_fallback, want.kind)
        assert got.kind == ("automaton" if automaton else "slot_dense")
        assert got.static_fallback == bool(automaton)
        counts = E.count_many(idx, plans)
        np.testing.assert_array_equal(counts.numpy(), _np(R.count_many(ridx, rplans)))
        assert int(counts[0, -70:].min()) == 1


def test_compile_patterns_dictionary_builds_automaton(rng, monkeypatch):
    """compile_patterns at >= 1024 patterns with a bucketed group builds the
    automaton (span and events as the reference's), no longer raising."""
    from repro_torch.obs import Recorder

    rec = Recorder(enabled=True, fence=False)
    pats = [bytes([i % 256, i // 256]) * 4 for i in range(1100)]
    plans = E.compile_patterns(pats, recorder=rec, device=CPU)
    (plan,) = plans
    assert plan.slot_off is not None and plan.automaton is not None
    assert plan.automaton.n_patterns == 1100
    (built,) = rec.events_named("automaton_built")
    assert built["states"] == plan.automaton.n_states
    assert "automaton_compile" in rec.span_totals_ms()
    # EPSMc-only sets get none; automaton=False and small sets get none
    assert E.compile_patterns([p * 2 for p in pats], device=CPU)[0].automaton is None
    assert E.compile_patterns(pats, automaton=False, device=CPU)[0].automaton is None
    assert E.compile_patterns(pats[:200], device=CPU)[0].automaton is None
    # a dictionary past the automaton's caps is skipped with an event
    rec = Recorder(enabled=True, fence=False)
    monkeypatch.setattr(E, "compile_automaton", lambda *a, **kw: None)
    assert E.compile_patterns(pats, recorder=rec, device=CPU)[0].automaton is None
    assert [e["p_total"] for e in rec.events_named("automaton_skipped")] == [1100]
    assert E.AUTOMATON_MIN_P == R.AUTOMATON_MIN_P


def test_reference_plans_carried_across(rng):
    """plan_from_numpy of a reference dictionary plan (automaton included)
    and automaton_from_numpy of its automaton give the reference's counts."""
    pats = _dict_patterns(rng, 1100, 5, 16)
    rplans = R.compile_patterns(pats)
    assert rplans[0].automaton is not None
    ported = []
    for p in rplans:
        fields = {f: getattr(p, f) for f in ("m", "kbits", "ids", "distinct", "k", "relaxed_bits",
                                             "bbits", "lut_pop", "slot_max")}
        for f in E.TENSOR_FIELDS:
            v = getattr(p, f)
            fields[f] = None if v is None else _np(v)
        fields["automaton"] = _ref_auto_fields(p.automaton)
        ported.append(E.plan_from_numpy(fields, device=CPU))
    auto = A.automaton_from_numpy(_ref_auto_fields(rplans[0].automaton), device=CPU)
    text = make_text(rng, 3000, 16)
    lengths = np.array([3000])
    np.testing.assert_array_equal(
        A.count_automaton(torch.from_numpy(text[None, :]), lengths, auto).numpy(),
        _np(RA.count_automaton(text[None, :], lengths, rplans[0].automaton)))
    idx = E.build_index(text, device=CPU)
    assert ported[0].automaton.n_states == rplans[0].automaton.n_states
    np.testing.assert_array_equal(
        E._automaton_counts(idx, ported[0].automaton).numpy(),
        _np(R._automaton_counts(R.build_index(text), rplans[0].automaton)))
    np.testing.assert_array_equal(E.count_many(idx, ported).numpy(),
                                  _np(R.count_many(R.build_index(text), rplans)))


def test_replicate_plans_keeps_automaton(rng):
    pats = _dict_patterns(rng, 200, 8)
    plans = E.compile_patterns(pats, bucket=True, automaton=True, device=CPU)
    rep = E.replicate_plans(plans, CPU)
    assert rep[0].automaton is not None and rep[0].automaton.n_states == plans[0].automaton.n_states
    assert torch.equal(rep[0].automaton.delta, plans[0].automaton.delta)
    text = make_text(rng, 2048, 256)
    text[500:508] = pats[3]
    idx = E.build_index(text, device=CPU)
    assert torch.equal(E._automaton_counts(idx, rep[0].automaton),
                       E._automaton_counts(idx, plans[0].automaton))
    assert torch.equal(E.count_many(idx, rep), E.count_many(idx, plans))


def test_stream_count_dictionary_vs_reference(rng, monkeypatch):
    """stream_count over 1100 patterns (70 copies of one: the slot cap
    sends every window's shared pass to the automaton) across window
    seams equals the reference's stream_count."""
    pats = _dict_patterns(rng, 1030, 6, 4) + [np.frombuffer(b"\x01\x02\x03\x00\x01\x02", np.uint8)] * 70
    text = make_text(rng, 40_000, 4)
    for s in range(1000, 40_000, 5003):  # plant copies across the window seams
        text[s : s + 6] = pats[-1]
    calls = []
    orig = E._automaton_counts
    monkeypatch.setattr(E, "_automaton_counts", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    got = S.stream_count(text, pats, chunk_bytes=8192, device=CPU)
    want = RS.stream_count(text, pats, chunk_bytes=8192)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and len(calls) >= 4
    assert int(got[-1]) >= 8 and len(set(got[-70:].tolist())) == 1


@pytest.mark.parametrize("case", ["zero_byte", "dict"])
def test_acscan_counts_ref_vs_reference(rng, case):
    """The counts mode's plain version, multiplied out over the CSR, equals
    the reference's count_automaton: B > 1 ragged rows, end_min, and a
    dictionary holding byte 0x00."""
    if case == "zero_byte":
        pats, sigma = _zero_byte_patterns(rng), 3
    else:
        pats, sigma = _dict_patterns(rng, 300, 6, 8), 8
    auto, rauto = A.compile_automaton(pats, device=CPU), RA.compile_automaton(pats)
    kt = A.kernel_tables(auto)
    text = make_text(rng, 4 * 777, sigma).reshape(4, 777)
    text[1, :9] = 0
    lengths = np.array([777, 640, 0, 5])
    for end_min in (None, 0, 100, 776):
        hist = acscan_counts_ref(torch.from_numpy(text), auto.classes, kt.counts, auto.n_classes,
                                 kt.n_term, auto.max_m, torch.from_numpy(lengths), end_min=end_min)
        assert hist.dtype == torch.int32 and hist.shape == (4, kt.n_term)
        want = _np(RA.count_automaton(text, lengths, rauto, end_min=end_min))
        np.testing.assert_array_equal(A._counts_from_hist(hist, auto).numpy(), want,
                                      err_msg=f"end_min={end_min}")
        # any segment width, the kernel's own included, gives the same histogram
        for s in (7, kernel_seg(auto.max_m - 1)):
            assert torch.equal(hist, acscan_counts_ref(
                torch.from_numpy(text), auto.classes, kt.counts, auto.n_classes, kt.n_term,
                auto.max_m, lengths, end_min=end_min, seg=s))


def _plan_ids(priv_tab: np.ndarray, plan_tab: np.ndarray) -> np.ndarray:
    """The plan id of each private id, found by walking the private and the
    plan's (n_states, n_classes) tables from the root together; asserts
    that every transition agrees, so the private table is the plan's with
    its states relabelled."""
    order = np.full(plan_tab.shape[0], -1, np.int64)
    order[0] = 0
    frontier = np.array([0])
    while frontier.size:
        p, q = priv_tab[frontier].ravel(), plan_tab[order[frontier]].ravel()
        fresh = order[p] < 0
        new, first = np.unique(p[fresh], return_index=True)
        order[new] = q[fresh][first]
        np.testing.assert_array_equal(order[p], q)
        frontier = new
    assert sorted(order.tolist()) == list(range(plan_tab.shape[0]))
    return order


def test_kernel_tables_renumbered_and_narrow(rng):
    """The private tables: root 0, the terminal states (those with an output
    list) 1..n_term in plan order; a plain scan over the renumbered uint16
    table, mapped back, is the sequential scan; uint16 exactly when the ids
    fit."""
    pats = _zero_byte_patterns(rng)
    auto, rauto = A.compile_automaton(pats, device=CPU), RA.compile_automaton(pats)
    kt = A.kernel_tables(auto)
    S, C = auto.n_states, auto.n_classes
    assert kt.counts.dtype == kt.states.dtype == torch.uint16
    tot = (auto.out_off[1:] - auto.out_off[:-1]).numpy()
    assert kt.n_term == int((tot > 0).sum())
    order = _plan_ids(kt.counts.long().numpy().reshape(S, C), auto.delta.numpy().reshape(S, C))
    np.testing.assert_array_equal(order[1 : kt.n_term + 1], np.flatnonzero(tot > 0))
    # the emission's columns follow the renumbering: entry e of state s is column priv[s] - 1
    entry_state = np.repeat(np.arange(S), tot)
    np.testing.assert_array_equal(order[kt.entry_t.numpy() + 1], entry_state)
    np.testing.assert_array_equal(kt.states.long().numpy(), auto.delta.numpy())
    np.testing.assert_array_equal(  # the renumbered table is the plan's, relabelled
        order[kt.counts.long().numpy().reshape(S, C)], auto.delta.numpy().reshape(S, C)[order])
    text = make_text(rng, 2 * 700, 3).reshape(2, 700)
    text[0, :9] = 0
    priv = acscan_states_ref(torch.from_numpy(text), auto.classes, kt.counts, C, auto.max_m)
    got = order[priv.numpy()]
    np.testing.assert_array_equal(got, _np(RA.automaton_states(text, rauto)))
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], ac_states_ref(text[b], auto.classes.numpy(), auto.delta.numpy(), C))
    # the dtype switches exactly past 65536 states (ids 0..65535 fit in uint16)
    assert A.table_dtype(1 << 16) == torch.uint16 and A.table_dtype((1 << 16) + 1) == torch.int32
    big = A.compile_automaton([rng.randint(0, 4, size=40).astype(np.uint8) for _ in range(1900)],
                              device=CPU)
    assert big.n_states > 1 << 16
    kb = A.kernel_tables(big)
    assert kb.counts.dtype == torch.int32 and kb.states is big.delta
    Sb = big.n_states
    ob = _plan_ids(kb.counts.numpy().reshape(Sb, -1), big.delta.numpy().reshape(Sb, -1))
    tb = (big.out_off[1:] - big.out_off[:-1]).numpy()
    np.testing.assert_array_equal(ob[1 : kb.n_term + 1], np.flatnonzero(tb > 0))


def test_acscan_counts_op_dispatch_on_cpu(rng):
    """On a CPU tensor the counts op and count_automaton take the plain
    version; the counts kernel's wrapper refuses a CPU tensor."""
    pats = _zero_byte_patterns(rng)
    auto = A.compile_automaton(pats, device=CPU)
    kt = A.kernel_tables(auto)
    text = torch.from_numpy(make_text(rng, 2 * 300, 3).reshape(2, 300))
    lengths = torch.tensor([300, 123])
    args = (text, auto.classes, kt.counts, auto.n_classes, kt.n_term, auto.max_m, lengths)
    before = (acscan_counts_cuda.launches, acscan_cuda.launches)
    got = acscan_ops.acscan_counts(*args, end_min=17)
    assert torch.equal(got, acscan_counts_ref(*args, end_min=17))
    assert torch.equal(A.count_automaton(text, lengths, auto, end_min=17),
                       A._counts_from_hist(got, auto))
    with pytest.raises(ValueError, match="CUDA"):
        acscan_counts_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        A.count_automaton(text, lengths, auto, use_kernel=True)
    assert (acscan_counts_cuda.launches, acscan_cuda.launches) == before


def test_kernel_tables_built_once_per_plan(rng, monkeypatch):
    """The private tables and the emission's columns are built at a plan's
    first call and reused by every later call (a spy counts the builds); a
    copy of the plan builds its own."""
    pats = _zero_byte_patterns(rng)
    auto = A.compile_automaton(pats, device=CPU)
    builds = []
    orig = A._build_kernel_tables
    monkeypatch.setattr(A, "_build_kernel_tables", lambda a: builds.append(a) or orig(a))
    text = torch.from_numpy(make_text(rng, 3 * 200, 3).reshape(3, 200))
    first = A.count_automaton(text, [200, 100, 50], auto)
    for end_min in (None, 10, 150):
        A.count_automaton(text, [200, 100, 50], auto, end_min=end_min)
    A.automaton_states(text, auto)
    assert builds == [auto]
    copy = auto.to(CPU)
    assert torch.equal(A.count_automaton(text, [200, 100, 50], copy), first)
    assert len(builds) == 2 and builds[1] is copy
    assert A.kernel_tables(copy) is A.kernel_tables(copy)
