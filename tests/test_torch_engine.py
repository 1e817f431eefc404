"""repro_torch.core.engine against repro.core.engine, bit for bit.

Mirrors tests/test_match_many.py (the engine cases) and the plan, routing
and bit-identity cases of tests/test_dictionary.py.  The port runs on the
CPU; the reference side runs ``match_many_jit`` / ``count_many_jit`` (each
distinct plan shape costs it a compile, so its calls are few and shared
through module fixtures).  Route cases also hold the port against a numpy
sliding-window oracle, and a spy on the port's route functions shows that
every route the reference pins is reached: per-group sparse pid, sparse
all-pattern, shared sparse, static and overflow dense, slot-dense, CSR, and
EPSMc sparse / dense / CSR.  No tolerance anywhere.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as R
from repro_torch.core import engine as E

from conftest import make_text

CPU = "cpu"


@pytest.fixture
def rng():
    """A fresh generator per test, so no test's data depends on which tests
    ran before it in the same process (pytest-xdist distributes files)."""
    return np.random.RandomState(0xC0FFEE)


def _oracle(text: np.ndarray, pat) -> np.ndarray:
    """bool[n]: pattern starts at i (numpy sliding window)."""
    pat = np.frombuffer(pat, np.uint8) if isinstance(pat, bytes) else np.asarray(pat)
    n, m = len(text), len(pat)
    out = np.zeros(n, bool)
    if n >= m:
        out[: n - m + 1] = (np.lib.stride_tricks.sliding_window_view(text, m) == pat).all(-1)
    return out


def _oracle_counts(docs, pats, order, lengths=None):
    """(B, P) int32 oracle counts in plan order."""
    out = np.zeros((len(docs), len(order)), np.int32)
    for b, d in enumerate(docs):
        d = d if lengths is None else d[: lengths[b]]
        for row, pid in enumerate(order):
            out[b, row] = _oracle(d, pats[pid]).sum()
    return out


def _np(x):
    return x.numpy()


def _ref_fields(plan) -> dict:
    """A reference plan's fields as host values (the device_get side)."""
    d = {f: getattr(plan, f) for f in (
        "m", "kbits", "ids", "distinct", "k", "relaxed_bits", "bbits", "lut_pop", "slot_max",
        "automaton")}
    for f in E.TENSOR_FIELDS + ("relaxed_lut",):
        v = getattr(plan, f)
        d[f] = None if v is None else np.asarray(jax.device_get(v))
    return d


def _same_plan_arrays(ref_plans, port_plans):
    assert len(ref_plans) == len(port_plans)
    for a, b in zip(ref_plans, port_plans):
        for f in ("m", "kbits", "ids", "distinct", "bbits", "lut_pop", "slot_max"):
            assert getattr(a, f) == getattr(b, f), f
        fields = _ref_fields(a)
        for f in E.TENSOR_FIELDS:
            want, got = fields[f], getattr(b, f)
            assert (want is None) == (got is None), f
            if want is not None:
                if want.dtype == np.uint32:
                    want = want.view(np.int32)
                np.testing.assert_array_equal(_np(got), want, err_msg=f"m={a.m} {f}")


class Spy:
    """Counts calls of engine functions (module globals, looked up per call)."""

    def __init__(self, monkeypatch, *names):
        self.calls = {n: 0 for n in names}
        for n in names:
            orig = getattr(E, n)

            def wrap(*a, _n=n, _orig=orig, **kw):
                self.calls[_n] += 1
                return _orig(*a, **kw)

            monkeypatch.setattr(E, n, wrap)


ROUTES = ("_count_b_sparse_pid", "_count_b_sparse_all", "_count_groups_b_shared",
          "_gather_candidate_rows", "_dense_count", "_count_b_slot_dense",
          "_b_count_rows_csr", "_c_verify", "_c_verify_csr", "_dense_c", "_dense_b",
          "_match_b_kernel")


def _mixed_patterns(rng, text, lengths):
    """Half extracted from the text (guaranteed hits), half random."""
    pats = []
    for m in lengths:
        s = rng.randint(0, len(text) - m + 1)
        pats.append(text[s : s + m].copy())
        pats.append(rng.randint(0, 5, size=m).astype(np.uint8))
    return pats


def _dict_patterns(rng, P, m, sigma=256):
    pats = np.unique(rng.randint(0, sigma, size=(P * 2, m)).astype(np.uint8), axis=0)
    assert pats.shape[0] >= P
    return [p for p in pats[:P]]


def _planted_text(rng, pats, n, sigma=256, every=7):
    t = make_text(rng, n, sigma)
    for i in range(0, len(pats), every):
        m = len(pats[i])
        pos = (i * 131) % (n - m)
        t[pos : pos + m] = pats[i]
    return t


# ---------------------------------------------------------------------------
# TextIndex and fingerprints
# ---------------------------------------------------------------------------

def test_build_index_matches_reference(rng):
    docs = [make_text(rng, n, 256) for n in (513, 100, 7, 256, 1)]
    for texts, lengths in ((docs, None), (np.stack([make_text(rng, 77, 4)] * 3), [77, 50, 0])):
        want = R.build_index(texts, lengths)
        got = E.build_index(texts, lengths, device=CPU)
        assert got.text.dtype == torch.uint8 and got.packed.dtype == torch.int32
        np.testing.assert_array_equal(_np(got.text), np.asarray(want.text))
        np.testing.assert_array_equal(_np(got.packed).view(np.uint32), np.asarray(want.packed))
        np.testing.assert_array_equal(_np(got.block_fp), np.asarray(want.block_fp))
        np.testing.assert_array_equal(_np(got.lengths), np.asarray(want.lengths))
        assert (got.batch, got.n) == (want.batch, want.n)


def test_fingerprint_bank_matches_reference(rng):
    t = make_text(rng, 300, 256)
    ridx, pidx = R.build_index(t), E.build_index(t, device=CPU)
    rbank, pbank = R.FingerprintBank(ridx.packed), E.FingerprintBank(pidx.packed)
    for m, kbits in ((4, 17), (7, 17), (15, 18), (12, 22), (5, 17)):
        want = np.asarray(rbank.window_fp(m, kbits))
        np.testing.assert_array_equal(_np(pbank.window_fp(m, kbits)), want)
        direct = E._window_fingerprint(pidx.packed, E._word_offsets(m), kbits)
        np.testing.assert_array_equal(_np(direct), want)


# ---------------------------------------------------------------------------
# Plans: compile_patterns field by field, and plans carried across
# ---------------------------------------------------------------------------

def _plan_sets(rng):
    t = make_text(rng, 1500, 4)
    mixed = _mixed_patterns(rng, t, (2, 5, 8, 12, 16, 24))
    return {
        "mixed": (t, mixed),
        # one group per regime: each group costs the reference a compile
        "regimes": (t, [p for p in mixed if len(p) in (2, 5, 16)]),
        # every aligned block is "aaaaaaaa": an EPSMc slot deeper than P
        "slot_overflow": (
            np.frombuffer(b"x" + b"a" * 60 + b"y" + b"a" * 15 + b"b" + b"a" * 20, np.uint8).copy(),
            [b"a" * 16, b"a" * 15 + b"b"],
        ),
    }


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("case", ["mixed", "slot_overflow"])
def test_compile_patterns_arrays_equal_reference(rng, case, bucket, canonical):
    _, pats = _plan_sets(rng)[case]
    kw = dict(bucket=bucket, automaton=False, canonical=canonical)
    _same_plan_arrays(R.compile_patterns(pats, **kw), E.compile_patterns(pats, device=CPU, **kw))


def test_compile_patterns_dictionary_scale_equal_reference(rng):
    """Auto-bucketed groups (P >= 128) and a widened fingerprint (P > 2048
    at m = 8, kbits 18) compile to the reference's arrays."""
    pats = _dict_patterns(rng, 2100, 8) + _dict_patterns(rng, 200, 20) + _dict_patterns(rng, 130, 3)
    kw = dict(automaton=False)
    ref, port = R.compile_patterns(pats, **kw), E.compile_patterns(pats, device=CPU, **kw)
    assert [p.kbits for p in port] == [17, 18, 17] and port[1].slot_off is not None
    _same_plan_arrays(ref, port)


@pytest.mark.parametrize("case,bucket,canonical",
                         [("regimes", False, False), ("regimes", True, True),
                          ("regimes", True, False), ("slot_overflow", False, True),
                          ("slot_overflow", True, True)])
def test_plans_from_reference_give_reference_results(rng, case, bucket, canonical):
    """A plan compiled by the reference and carried over with plan_from_numpy
    answers match_many / count_many as the reference does on the same plan."""
    t, pats = _plan_sets(rng)[case]
    ref_plans = R.compile_patterns(pats, bucket=bucket, automaton=False, canonical=canonical)
    port_plans = tuple(E.plan_from_numpy(_ref_fields(p), device=CPU) for p in ref_plans)
    _same_plan_arrays(ref_plans, port_plans)
    ridx, pidx = R.build_index(t), E.build_index(t, device=CPU)
    np.testing.assert_array_equal(
        _np(E.match_many(pidx, port_plans)), np.asarray(R.match_many_jit(ridx, ref_plans)))
    counts = E.count_many(pidx, port_plans)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(_np(counts), np.asarray(R.count_many_jit(ridx, ref_plans)))


def test_plan_from_numpy_refuses_unported_routes(rng):
    """Every reference plan field carries across now: a plan holding the
    automaton converts (the automaton route is ported), and a k-mismatch
    plan carries its relaxed LUT over; both answer as the reference."""
    ref_auto = R.compile_patterns([b"abcdefgh"] * 4, bucket=True, automaton=True)
    assert ref_auto[0].automaton is not None
    (plan,) = (E.plan_from_numpy(_ref_fields(p), device=CPU) for p in ref_auto)
    assert plan.automaton is not None and plan.automaton.n_states == ref_auto[0].automaton.n_states
    t = np.frombuffer(b"xxabcdefghabcdefghyy", np.uint8)
    np.testing.assert_array_equal(E._automaton_counts(E.build_index(t, device=CPU), plan.automaton),
                                  np.asarray(R._automaton_counts(R.build_index(t),
                                                                 ref_auto[0].automaton)))
    # a k-mismatch plan carries its relaxed LUT over and answers as the reference
    ref_plans = R.compile_patterns([b"abcdefgh", b"abcdxfgh"], k=1)
    (plan,) = (E.plan_from_numpy(_ref_fields(p), device=CPU) for p in ref_plans)
    assert plan.k == 1 and plan.relaxed_bits == ref_plans[0].relaxed_bits
    np.testing.assert_array_equal(plan.relaxed_lut.numpy(), np.asarray(ref_plans[0].relaxed_lut))
    t = np.frombuffer(b"xxabcdefghyyabcdzfghzzabzdefgh", np.uint8)
    np.testing.assert_array_equal(E.count_many(E.build_index(t, device=CPU), (plan,)).numpy(),
                                  np.asarray(R.count_many_jit(R.build_index(t), ref_plans)))


def test_unported_routes_raise():
    """No route raises any more: k > 0 plans and the automaton fallback are
    both ported, and compile_patterns attaches the automaton exactly where
    the reference does."""
    (fuzzy,) = E.compile_patterns([b"abcd"], k=1, device=CPU)
    assert fuzzy.k == 1 and fuzzy.relaxed_lut is not None
    (plan,) = E.compile_patterns([b"abcdefgh"] * 4, bucket=True, automaton=True, device=CPU)
    assert plan.automaton is not None
    # "auto" builds the automaton only with a bucketed EPSMb group
    pats = [bytes([i % 256, i // 256]) * 8 for i in range(1100)]
    (c_plan,) = E.compile_patterns(pats, device=CPU)  # m = 16: EPSMc, no automaton
    assert c_plan.automaton is None
    (b_plan,) = E.compile_patterns([p[:8] for p in pats], device=CPU)
    (ref_b,) = R.compile_patterns([p[:8] for p in pats])
    assert b_plan.automaton is not None and ref_b.automaton is not None
    assert b_plan.automaton.n_states == ref_b.automaton.n_states
    (plan,) = E.compile_patterns([b"abcd"], device=CPU)
    idx = E.build_index(b"xxabcd", device=CPU)
    (ref,) = R.compile_patterns([b"abcd"])
    np.testing.assert_array_equal(E.count_many(idx, (plan,), k=1).numpy(),
                                  np.asarray(R.count_many_jit(R.build_index(b"xxabcd"), (ref,), k=1)))


def test_plan_order_and_replicate(rng):
    pats = [b"abc", b"abcdefgh", b"zz", b"abcdefghijklmnopq", b"xyz"]
    ref, port = R.compile_patterns(pats), E.compile_patterns(pats, device=CPU)
    np.testing.assert_array_equal(E.plan_order(port), R.plan_order(ref))
    same = E.replicate_plans(port, CPU)
    assert [p.ids for p in same] == [p.ids for p in port]
    assert all(torch.equal(a.lut_any, b.lut_any) for a, b in zip(same, port))
    assert E.replicate_plans(port, None) == tuple(port)


def test_compile_patterns_cached_key_and_stats(rng):
    pats = [bytes(p) for p in _dict_patterns(rng, 150, 8)]
    before = E.plan_cache_stats()
    a = E.compile_patterns_cached(pats, device=CPU)
    b = E.compile_patterns_cached(pats, bucket=False, device=CPU)
    assert a is not b
    assert any(p.slot_off is not None for p in a) and all(p.slot_off is None for p in b)
    assert E.compile_patterns_cached(pats, device=CPU) is a
    # a tensor pattern is read to the host once, then served from the memo
    tp = [torch.from_numpy(np.frombuffer(p, np.uint8).copy()) for p in pats[:3]]
    c = E.compile_patterns_cached(tp, device=CPU)
    assert E.compile_patterns_cached(tp, device=CPU) is c
    after = E.plan_cache_stats()
    assert after["hits"] - before["hits"] == 2 and after["misses"] - before["misses"] == 3


# ---------------------------------------------------------------------------
# Joins against the reference (test_match_many.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed_case():
    rng = np.random.RandomState(11)
    t = make_text(rng, 2000, 4)
    pats = _mixed_patterns(rng, t, (1, 2, 3, 5, 8, 12, 15, 16, 24, 40))
    ridx = R.build_index(t)
    rplans = R.compile_patterns(pats)
    want = (np.asarray(R.match_many_jit(ridx, rplans)), np.asarray(R.count_many_jit(ridx, rplans)))
    return t, pats, want


def test_match_many_mixed_lengths_vs_reference(mixed_case, monkeypatch):
    """All three regimes in one plan set; on the CPU the EPSMb mask route is
    the plain _dense_b, never the kernel wrapper."""
    t, pats, (want_mask, want_counts) = mixed_case
    spy = Spy(monkeypatch, *ROUTES)
    plans = E.compile_patterns(pats, device=CPU)
    idx = E.build_index(t, device=CPU)
    mask = E.match_many(idx, plans)
    assert mask.shape == (1, len(pats), len(t)) and mask.dtype == torch.bool
    np.testing.assert_array_equal(_np(mask), want_mask)
    np.testing.assert_array_equal(_np(E.count_many(idx, plans)), want_counts)
    assert spy.calls["_dense_b"] >= 1 and spy.calls["_match_b_kernel"] == 0
    np.testing.assert_array_equal(
        want_counts, _oracle_counts([t], pats, E.plan_order(plans)))


def test_match_many_end_min_vs_reference(rng):
    """The streaming seam gate keeps occurrences ending at or past end_min,
    in every regime (one reference compile, end_min traced)."""
    t = make_text(rng, 1500, 4)
    pats = _mixed_patterns(rng, t, (3, 8, 20))
    rplans, pplans = R.compile_patterns(pats), E.compile_patterns(pats, device=CPU)
    ridx, pidx = R.build_index(t), E.build_index(t, device=CPU)
    ref_count = jax.jit(lambda idx, e: R.count_many(idx, rplans, end_min=e))
    order = E.plan_order(pplans)
    for end_min in (700, 1499):
        mask = _np(E.match_many(pidx, pplans, end_min=end_min))
        for row, pid in enumerate(order):
            want = _oracle(t, pats[pid])
            want[: max(0, end_min - len(pats[pid]) + 1)] = False
            np.testing.assert_array_equal(mask[0, row], want)
        np.testing.assert_array_equal(_np(E.count_many(pidx, pplans, end_min=end_min)),
                                      np.asarray(ref_count(ridx, end_min)))
        np.testing.assert_array_equal(_np(E.count_many(pidx, pplans, end_min=end_min)),
                                      mask.sum(-1))


def test_match_many_batched_ragged_padding(rng):
    docs = [make_text(rng, n, 4) for n in (513, 100, 7, 256, 1)]
    pats = _mixed_patterns(rng, docs[0], (2, 6, 8, 20))
    rplans, plans = R.compile_patterns(pats), E.compile_patterns(pats, device=CPU)
    idx = E.build_index(docs, device=CPU)
    assert idx.n == 513
    mask = _np(E.match_many(idx, plans))
    np.testing.assert_array_equal(mask, np.asarray(R.match_many_jit(R.build_index(docs), rplans)))
    order = E.plan_order(plans)
    for bi, doc in enumerate(docs):
        assert not mask[bi, :, len(doc):].any(), "match inside padding"
        for row, pid in enumerate(order):
            np.testing.assert_array_equal(mask[bi, row, : len(doc)], _oracle(doc, pats[pid]))


def test_no_match_across_document_boundary(rng):
    a, b = make_text(rng, 64, 4), make_text(rng, 64, 4)
    straddle = np.concatenate([a[-4:], b[:4]])
    assert not (_oracle(a, straddle).any() or _oracle(b, straddle).any())
    plans = E.compile_patterns([straddle], device=CPU)
    assert not E.match_many(E.build_index([a, b], device=CPU), plans).any()
    mask = E.match_many(E.build_index(np.concatenate([a, b]), device=CPU), plans)[0, 0]
    assert bool(mask[60])


def test_any_many_any_hit_blocked(rng):
    # bytes 4..7: neither pattern can occur except where it is planted
    docs = [make_text(rng, 300, 4) + 4 for _ in range(8)]
    bad = b"\x01\x02\x03\x01\x02\x03\x00"
    for i in (2, 5):
        docs[i][100:107] = np.frombuffer(bad, np.uint8)
    pats = [bad, b"\x09\x09"]
    plans = E.compile_patterns(pats, device=CPU)
    idx = E.build_index(docs, device=CPU)
    ridx, rplans = R.build_index(docs), R.compile_patterns(pats)
    np.testing.assert_array_equal(_np(E.any_many(idx, plans)), np.asarray(R.any_many(ridx, rplans)))
    hits = E.any_hit(idx, plans)
    assert set(np.nonzero(_np(hits))[0].tolist()) == {2, 5}
    mat = np.stack(docs)
    lengths = np.full(8, 300, np.int32)
    lengths[5] = 100  # the planted copy now lies in padding
    np.testing.assert_array_equal(_np(E.blocked(mat, lengths, plans, device=CPU)),
                                  np.asarray(R.blocked(mat, lengths, rplans)))


def test_empty_plans_and_device_mismatch(rng):
    idx = E.build_index(b"abcdef", device=CPU)
    assert E.match_many(idx, ()).shape == (1, 0, 6)
    assert E.count_many(idx, ()).dtype == torch.int32
    (plan,) = E.compile_patterns([b"cde"], device=CPU)
    meta = E.replicate_plans((plan,), "meta")
    with pytest.raises(ValueError, match="replicate_plans"):
        E.count_many(idx, meta)


# ---------------------------------------------------------------------------
# Routes: each reached, each exact
# ---------------------------------------------------------------------------

def _shared_case(rng):
    t = make_text(rng, 4096, 4)
    pats = []
    for m in (5, 8, 12, 15):
        for _ in range(4):
            s = rng.randint(0, len(t) - m + 1)
            pats.append(t[s : s + m].copy())
    pats.append(pats[4].copy())  # duplicate: the m = 8 group loses `distinct`
    return t, pats


def test_count_many_shared_b_groups(rng, monkeypatch):
    """>= 2 eligible EPSMb groups take ONE shared candidate pass, with a
    non-distinct group among them; equal to the reference and the oracle."""
    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 0)
    monkeypatch.setattr(R, "SPARSE_B_MIN_ELEMS", 0)
    t, pats = _shared_case(rng)
    plans = E.compile_patterns(pats, device=CPU)
    idx = E.build_index(t, device=CPU)
    assert sum(p.regime == "b" and E._sparse_b_eligible(idx, p) for p in plans) >= 2
    assert not all(p.distinct for p in plans)
    info = E.route_probe(idx, plans)
    assert info == R.route_probe(R.build_index(t), R.compile_patterns(pats))
    assert info["route"] == "sparse"
    spy = Spy(monkeypatch, *ROUTES)
    counts = _np(E.count_many(idx, plans))
    assert spy.calls["_count_groups_b_shared"] == 1 and spy.calls["_gather_candidate_rows"] == 1
    assert spy.calls["_dense_count"] == 0
    np.testing.assert_array_equal(counts, _oracle_counts([t], pats, E.plan_order(plans)))
    np.testing.assert_array_equal(
        counts, np.asarray(R.count_many(R.build_index(t), R.compile_patterns(pats))))


@pytest.mark.parametrize("duplicate", [False, True], ids=["pid", "all_patterns"])
def test_count_group_b_per_group_sparse(rng, monkeypatch, duplicate):
    """shared=False: a distinct group takes the per-group pid fast path, a
    group with a duplicated pattern the sparse all-pattern verify."""
    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 0)
    t, pats = _shared_case(rng)
    pats = pats[4:8] + ([pats[4].copy()] if duplicate else [])
    plans = E.compile_patterns(pats, device=CPU)
    assert plans[0].distinct is (not duplicate)
    spy = Spy(monkeypatch, *ROUTES)
    idx = E.build_index(t, device=CPU)
    counts = _np(E.count_many(idx, plans, shared=False))
    route = "_count_b_sparse_all" if duplicate else "_count_b_sparse_pid"
    assert spy.calls[route] == 1 and spy.calls["_dense_count"] == 0
    np.testing.assert_array_equal(counts, _oracle_counts([t], pats, E.plan_order(plans)))


def test_single_eligible_b_group_uses_shared_and_overflows_dense(rng, monkeypatch):
    """One sparse-eligible EPSMb group in a mixed set still takes the shared
    pass; on a saturating text long enough for the union to pass its budget
    (at least 4096 blocks) every shared group falls back to the dense count."""
    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 0)
    t = make_text(rng, 4096, 4)
    pats = [t[7:9].copy(), t[90:114].copy()] + [t[s : s + 8].copy() for s in (50, 200, 600, 1100)]
    plans = E.compile_patterns(pats, device=CPU)
    spy = Spy(monkeypatch, *ROUTES)
    counts = _np(E.count_many(E.build_index(t, device=CPU), plans))
    assert spy.calls["_count_groups_b_shared"] == 1 and spy.calls["_gather_candidate_rows"] == 1
    np.testing.assert_array_equal(counts, _oracle_counts([t], pats, E.plan_order(plans)))
    tz = np.zeros(200_000, np.uint8)
    pz = [np.zeros(8, np.uint8)] * 4 + [np.zeros(12, np.uint8)] * 4
    plans_z = E.compile_patterns(pz, device=CPU)
    idx_z = E.build_index(tz, device=CPU)
    monkeypatch.setattr(R, "SPARSE_B_MIN_ELEMS", 0)
    info = E.route_probe(idx_z, plans_z)
    assert info == R.route_probe(R.build_index(tz), R.compile_patterns(pz))
    assert info["route"] == "dense" and info["blocks"] > info["budget"]
    spy = Spy(monkeypatch, *ROUTES)
    counts = _np(E.count_many(idx_z, plans_z))
    assert spy.calls["_count_groups_b_shared"] == 1 and spy.calls["_dense_count"] == 2
    assert spy.calls["_gather_candidate_rows"] == 0
    np.testing.assert_array_equal(counts, _oracle_counts([tz], pz, E.plan_order(plans_z)))


def test_dense_routes_static_and_overflow(rng, monkeypatch):
    """A small group is statically dense; all-zero text overflows the
    per-group budget and the dense count stays exact (reference cases)."""
    t = np.zeros(8192, np.uint8)
    pats = [np.zeros(8, np.uint8), np.zeros(24, np.uint8)]
    spy = Spy(monkeypatch, *ROUTES)
    plans = E.compile_patterns(pats, device=CPU)
    idx = E.build_index(t, device=CPU)
    mask, counts = _np(E.match_many(idx, plans)), _np(E.count_many(idx, plans))
    assert spy.calls["_dense_count"] == 2 and spy.calls["_dense_c"] == 2  # EPSMc overflow
    ridx, rplans = R.build_index(t), R.compile_patterns(pats)
    np.testing.assert_array_equal(mask, np.asarray(R.match_many_jit(ridx, rplans)))
    np.testing.assert_array_equal(counts, np.asarray(R.count_many_jit(ridx, rplans)))
    # per-group overflow: eligible but saturated, on a text long enough
    # (over 1024 blocks) for the candidates to pass the budget
    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 0)
    spy = Spy(monkeypatch, *ROUTES)
    pz = [np.zeros(8, np.uint8)] * 4
    plans_z = E.compile_patterns(pz, device=CPU)
    t = np.zeros(40_000, np.uint8)
    counts = _np(E.count_many(E.build_index(t, device=CPU), plans_z, shared=False))
    assert spy.calls["_dense_count"] == 1 and spy.calls["_gather_candidate_rows"] == 0
    np.testing.assert_array_equal(counts, _oracle_counts([t], pz, E.plan_order(plans_z)))


def test_dense_count_slices_patterns(rng, monkeypatch):
    """The dense count fallback materializes at most DENSE_STEP_ELEMS mask
    elements a step, a slice of patterns at a time, with the reference's
    counts (EPSMb and EPSMc groups, ragged rows, end_min)."""
    docs = [make_text(rng, 3000, 3) for _ in range(3)]
    pats = [docs[0][s : s + m].copy() for m in (5, 20) for s in (3, 50, 700, 1200, 2000)]
    pats += [rng.randint(0, 3, size=m).astype(np.uint8) for m in (5, 20)]
    lengths = np.array([3000, 2100, 7])
    plans = E.compile_patterns(pats, device=CPU)
    idx = E.build_index(np.stack(docs), lengths, device=CPU)
    whole = [E._dense_count(idx, p, E._dense_b if p.regime == "b" else E._dense_c, 40)
             for p in plans]
    monkeypatch.setattr(E, "DENSE_STEP_ELEMS", 2 * 3 * 3000)  # two patterns a step
    spy = Spy(monkeypatch, "_dense_b", "_dense_c")
    sliced = [E._dense_count(idx, p, E._dense_b if p.regime == "b" else E._dense_c, 40)
              for p in plans]
    assert spy.calls == {"_dense_b": 3, "_dense_c": 3}  # 6 patterns a group, 2 a step
    ridx = R.build_index(np.stack(docs), lengths)
    rplans = R.compile_patterns(pats)
    want = np.asarray(R.count_many(ridx, rplans, end_min=40))
    np.testing.assert_array_equal(torch.cat(sliced, 1).numpy(), want)
    assert all(torch.equal(a, b) for a, b in zip(whole, sliced))


def test_epsmc_sparse_route(rng, monkeypatch):
    """Flat EPSMc groups verify their candidate blocks (no dense pass)."""
    t = make_text(rng, 6000, 8)
    pats = [t[s : s + m].copy() for m in (16, 24, 40) for s in (10, 777, 3001)]
    plans = E.compile_patterns(pats, device=CPU)
    spy = Spy(monkeypatch, *ROUTES)
    idx = E.build_index(t, device=CPU)
    mask, counts = _np(E.match_many(idx, plans)), _np(E.count_many(idx, plans))
    assert spy.calls["_c_verify"] == 6 and spy.calls["_dense_c"] == 0
    order = E.plan_order(plans)
    np.testing.assert_array_equal(counts, _oracle_counts([t], pats, order))
    for row, pid in enumerate(order):
        np.testing.assert_array_equal(mask[0, row], _oracle(t, pats[pid]))


# ---------------------------------------------------------------------------
# Dictionary scale: bucketed == flat (test_dictionary.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 3, 5, 8, 15, 16, 17])
def test_bucketed_equals_flat_small_p(rng, m):
    pats = _dict_patterns(rng, 32, m, sigma=8)
    text = _planted_text(rng, pats, 2048, sigma=8, every=3)
    idx = E.build_index(text, device=CPU)
    flat = E.compile_patterns(pats, bucket=False, automaton=False, device=CPU)
    buck = E.compile_patterns(pats, bucket=True, automaton=False, device=CPU)
    cf = _np(E.count_many(idx, flat))
    np.testing.assert_array_equal(cf, _np(E.count_many(idx, buck)))
    np.testing.assert_array_equal(_np(E.match_many(idx, flat)), _np(E.match_many(idx, buck)))
    np.testing.assert_array_equal(cf, _oracle_counts([text], pats, E.plan_order(flat)))


@pytest.mark.parametrize("m", [5, 8, 15, 20])
def test_bucketed_routes_p1000(rng, monkeypatch, m):
    """P = 1000 auto-buckets: EPSMb counts take the CSR verify on average
    text (sparse-eligible) and the slot-dense scan when not eligible; EPSMc
    the CSR verify.  Every count equals the flat plans' and the oracle's."""
    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 0)
    pats = _dict_patterns(rng, 1000, m)
    text = _planted_text(rng, pats, 4096)
    idx = E.build_index(text, device=CPU)
    flat = E.compile_patterns(pats, bucket=False, device=CPU)
    buck = E.compile_patterns(pats, device=CPU)
    assert buck[0].slot_off is not None or buck[0].c_slot_off is not None
    spy = Spy(monkeypatch, *ROUTES)
    cb = _np(E.count_many(idx, buck))
    if m < 16:
        assert spy.calls["_b_count_rows_csr"] == 1 and spy.calls["_count_b_slot_dense"] == 0
    else:
        assert spy.calls["_c_verify_csr"] == 1
    np.testing.assert_array_equal(cb, _np(E.count_many(idx, flat)))
    order = E.plan_order(buck)
    for row in range(0, 1000, 97):
        assert cb[0, row] == _oracle(text, pats[order[row]]).sum()
    if m < 16:
        monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 10**12)
        spy = Spy(monkeypatch, *ROUTES)
        np.testing.assert_array_equal(_np(E.count_many(idx, buck)), cb)
        assert spy.calls["_count_b_slot_dense"] == 1


def test_bucketed_overflow_routes(rng, monkeypatch):
    """A fingerprint flood overflows the per-group CSR budget (EPSMb ->
    slot-dense; the text passes 1024 blocks) and the EPSMc candidate budget
    (CSR over every block); counts and masks equal the flat plans'."""
    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 0)
    pb = [b"a" * 8, b"a" * 7 + b"b", b"b" + b"a" * 7, b"ab" * 4]
    pc = [b"a" * 16, b"a" * 15 + b"b"]
    text = np.frombuffer(b"a" * 30000 + b"b" + b"a" * 10000, np.uint8).copy()
    idx = E.build_index(text, device=CPU)
    for pats in (pb, pc):
        flat = E.compile_patterns(pats, bucket=False, automaton=False, device=CPU)
        buck = E.compile_patterns(pats, bucket=True, automaton=False, device=CPU)
        spy = Spy(monkeypatch, *ROUTES)
        cb = _np(E.count_many(idx, buck, shared=False))
        mb = _np(E.match_many(idx, buck))
        if pats is pb:
            assert spy.calls["_count_b_slot_dense"] == 1 and spy.calls["_b_count_rows_csr"] == 0
        else:
            assert spy.calls["_c_verify_csr"] == 2  # count + match, over every block
        np.testing.assert_array_equal(cb, _np(E.count_many(idx, flat)))
        np.testing.assert_array_equal(mb, _np(E.match_many(idx, flat)))
        np.testing.assert_array_equal(cb, _oracle_counts([text], pats, E.plan_order(buck)))


def test_canonical_epsmc_slot_overflow_bit_identity():
    pats = [b"a" * 16, b"a" * 15 + b"b"]
    raw = b"x" + b"a" * 60 + b"y" + b"a" * 15 + b"b" + b"a" * 20
    text = np.frombuffer(raw, np.uint8).copy()
    idx = E.build_index(text, device=CPU)
    flat = E.compile_patterns(pats, bucket=False, automaton=False, device=CPU)
    (plan,) = canon = E.compile_patterns(pats, bucket=True, automaton=False, canonical=True,
                                         device=CPU)
    assert plan.c_slot_off is not None and plan.slot_max > len(pats)
    cc = _np(E.count_many(idx, canon))
    np.testing.assert_array_equal(_np(E.count_many(idx, flat)), cc)
    np.testing.assert_array_equal(_np(E.match_many(idx, flat)), _np(E.match_many(idx, canon)))
    np.testing.assert_array_equal(cc, _oracle_counts([text], pats, E.plan_order(canon)))


def test_bucketed_duplicate_patterns(rng):
    base = _dict_patterns(rng, 64, 8)
    pats = base + base[:16]
    text = _planted_text(rng, pats, 2048, every=2)
    idx = E.build_index(text, device=CPU)
    cf = _np(E.count_many(idx, E.compile_patterns(pats, bucket=False, device=CPU)))
    buck = E.compile_patterns(pats, bucket=True, automaton=False, device=CPU)
    cb = _np(E.count_many(idx, buck))
    np.testing.assert_array_equal(cf, cb)
    order = E.plan_order(buck).tolist()
    for i in range(16):
        assert cb[0, order.index(64 + i)] == cb[0, order.index(i)]


def test_expected_union_blocks_and_shared_route_match_reference(rng):
    pats = _dict_patterns(rng, 900, 8)
    rplans = R.compile_patterns(pats)
    pplans = E.compile_patterns(pats, device=CPU)
    for B, n in ((4, 1 << 20), (1, 4096)):
        assert E._expected_union_blocks(B, n, pplans) == R._expected_union_blocks(B, n, rplans)
    text = make_text(np.random.RandomState(7), 1 << 14, 256)
    ridx, pidx = R.build_index(text), E.build_index(text, device=CPU)
    want = R._shared_b_route(ridx, rplans)
    got = E._shared_b_route(pidx, pplans)
    assert (got.budget, got.exp_blocks, got.rho, got.static_fallback, got.kind) == (
        want.budget, want.exp_blocks, want.rho, want.static_fallback, want.kind)


def test_route_probe_matches_reference(rng, monkeypatch):
    """route_probe reports the reference's route, counts and budget on
    average text (sparse), a flood (slot-dense on bucketed plans) and an
    ineligible set (per_group), and emits one fallback_route event each."""
    from repro_torch.obs import Recorder

    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 0)
    monkeypatch.setattr(R, "SPARSE_B_MIN_ELEMS", 0)
    pats = _dict_patterns(rng, 300, 8)
    n = 1 << 18  # past 4096 blocks, the shared budget's floor
    avg = _planted_text(rng, pats, n)
    flood = np.concatenate([pats[i % 300] for i in range(n // 8)])
    events = []
    rec = Recorder(sinks=((lambda name, args: events.append(name)),))
    routes = []
    for text in (avg, flood):
        for bucket in (True, False):
            kw = dict(bucket=bucket, automaton=False)
            got = E.route_probe(E.build_index(text, device=CPU),
                                E.compile_patterns(pats, device=CPU, **kw), recorder=rec)
            want = R.route_probe(R.build_index(text), R.compile_patterns(pats, **kw))
            assert got == want
            routes.append(got["route"])
    assert routes == ["sparse", "sparse", "slot_dense", "dense"]
    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 10**12)
    got = E.route_probe(E.build_index(avg, device=CPU), E.compile_patterns(pats[:3], device=CPU),
                        recorder=rec)
    assert got["route"] == "per_group"
    assert events.count("fallback_route") == 5
