"""repro_torch.approx and the approx kernel's plain version against
repro.approx, bit for bit.

Mirrors tests/test_approx.py: k = 0 through fuzzy plans, the regime x
alphabet x budget grid on ragged batches, planted typos, the adversarial
flood, relaxed-LUT soundness and equality, the sparse gated count path and
its overflow, the op against the Pallas kernel (interpret mode, one small
case) and its pure-jnp oracle, and the k-mismatch entry points.  The port
runs on the CPU; the reference side runs ``match_many`` / ``count_many``
(jitted where a shape repeats, eagerly across the grid).  A spy on the port's route functions shows each route is
reached.  No tolerance anywhere.
"""

import numpy as np
import pytest
import torch

from repro import approx as RA
from repro.approx import counting as RC, relaxed as RR
from repro.core import engine as R, epsm as Repsm, multipattern as Rmp
from repro.kernels.approx import approx_batched as r_approx_batched
from repro.kernels.approx import approx_batched_ref as r_approx_batched_ref
from repro_torch import approx as PA
from repro_torch.approx import counting as PC, relaxed as PR
from repro_torch.core import engine as E, epsm as Pepsm, multipattern as Pmp
from repro_torch.kernels.approx import approx_batched, approx_batched_ref, approx_multipattern
from repro_torch.kernels.approx import approx as AXK
from repro_torch.kernels.approx import ops as AXO
from repro_torch.kernels.approx.approx import approx_cuda
from repro_torch.kernels.approx.ref import approx_piece_candidates_ref

from conftest import make_text

CPU = "cpu"
ROUTES = ("_dense_count_approx", "_approx_candidates", "_approx_verify_counts",
          "_dense_match_approx", "_match_approx_kernel")


@pytest.fixture
def rng():
    """A fresh generator per test, so no test's data depends on which tests
    ran before it in the same process."""
    return np.random.RandomState(0xA99)


class Spy:
    """Counts calls of approx.counting functions (module globals)."""

    def __init__(self, monkeypatch, *names):
        self.calls = {n: 0 for n in names}
        for n in names:
            orig = getattr(PC, n)

            def wrap(*a, _n=n, _orig=orig, **kw):
                self.calls[_n] += 1
                return _orig(*a, **kw)

            monkeypatch.setattr(PC, n, wrap)


def _mixed_patterns(rng, text, lengths):
    pats = []
    for m in lengths:
        s = rng.randint(0, len(text) - m + 1)
        pats.append(text[s : s + m].copy())
        pats.append(rng.randint(0, 5, size=m).astype(np.uint8))
    return pats


def _both(docs, pats, k, **kw):
    """(reference plans, reference index, port plans, port index)."""
    rp = R.compile_patterns(pats, k=k, **kw)
    pp = E.compile_patterns(pats, k=k, device=CPU, **kw)
    return rp, R.build_index(docs), pp, E.build_index(docs, device=CPU)


def test_constants_equal_reference():
    assert PC.APPROX_CAND_BLOCK == RC.APPROX_CAND_BLOCK
    assert PC.BLOCK_FRAC_MAX == RC.BLOCK_FRAC_MAX
    assert PR.DENSITY_MAX == RR.DENSITY_MAX and PR.EXPAND_CAP == RR.EXPAND_CAP
    from repro.kernels.approx import ops as RAXO

    assert AXO.MAX_M == RAXO.MAX_M


def test_k0_bit_identical_to_exact(rng):
    """k = 0 through plans compiled for k = 2 equals the exact path."""
    docs = [make_text(rng, n, 4) for n in (513, 100, 7, 256)]
    pats = _mixed_patterns(rng, docs[0], (2, 3, 5, 8, 12, 16, 24))
    idx = E.build_index(docs, device=CPU)
    exact = E.compile_patterns(pats, device=CPU)
    fuzzy = E.compile_patterns(pats, k=2, device=CPU)
    assert all(p.k == 2 for p in fuzzy)
    want = E.match_many(idx, exact)
    assert torch.equal(E.match_many(idx, fuzzy, k=0), want)
    assert torch.equal(E.count_many(idx, fuzzy, k=0), E.count_many(idx, exact))
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(R.match_many_jit(R.build_index(docs), R.compile_patterns(pats, k=2), k=0)))


@pytest.mark.parametrize("sigma", [2, 4, 256])
def test_count_many_matches_reference_grid(rng, sigma):
    """Regimes x budgets on batched ragged texts: masks and counts equal the
    reference engine's and the naive oracle's."""
    docs = [make_text(rng, n, sigma) for n in (400, 37, 3)]
    for m in (2, 4, 5, 8, 12, 16):
        pats = [docs[0][:m].copy(), rng.randint(0, sigma, size=m).astype(np.uint8)]
        for k in (1, 2, 3):
            rp, ridx, pp, pidx = _both(docs, pats, k)
            mask = E.match_many(pidx, pp, k=k)
            counts = E.count_many(pidx, pp, k=k)
            assert mask.dtype == torch.bool and counts.dtype == torch.int32
            # the reference runs eagerly here: one jit compile per shape would
            # cost more than the whole grid
            np.testing.assert_array_equal(mask.numpy(), np.asarray(R.match_many(ridx, rp, k=k)))
            np.testing.assert_array_equal(counts.numpy(), np.asarray(R.count_many(ridx, rp, k=k)))
            for bi, doc in enumerate(docs):
                assert not mask[bi, :, len(doc):].any(), "match in padding"
                for row, pid in enumerate(E.plan_order(pp)):
                    want = RA.kmismatch_naive(doc, pats[pid], k)
                    np.testing.assert_array_equal(mask[bi, row, : len(doc)].numpy(), want)
                    np.testing.assert_array_equal(PA.kmismatch_naive(doc, pats[pid], k), want)


def test_end_min_seam_gate_vs_reference(rng):
    """The streaming seam gate on the k-mismatch routes (dense and gated)."""
    t = make_text(rng, 3000, 4)
    pats = _mixed_patterns(rng, t, (3, 6, 9, 17))
    rp, ridx, pp, pidx = _both([t], pats, 1)
    for end_min in (0, 5, 1000, 2999):
        np.testing.assert_array_equal(
            E.match_many(pidx, pp, end_min=end_min).numpy(),
            np.asarray(R.match_many(ridx, rp, end_min=end_min)))
        np.testing.assert_array_equal(
            E.count_many(pidx, pp, end_min=end_min).numpy(),
            np.asarray(R.count_many(ridx, rp, end_min=end_min)))


def test_planted_fuzzy_occurrence_found(rng):
    """A corrupted copy is invisible to the exact path and found by k >= #typos."""
    t = make_text(rng, 5000, 64)
    p = t[1000:1012].copy()
    site = 3000
    t[site : site + 12] = p
    t[site + 4] ^= 3
    t[site + 9] ^= 7  # two typos
    got = {k: PA.find_kmismatch(t, p, k, device=CPU).numpy() for k in (1, 2)}
    for k in (1, 2):
        np.testing.assert_array_equal(got[k], np.asarray(RA.find_kmismatch(t, p, k)))
        assert int(PA.count_kmismatch(t, p, k, device=CPU)) == int(RA.count_kmismatch(t, p, k))
    exact = Pepsm.find(t, p, device=CPU).numpy()
    assert not exact[site] and not got[1][site] and got[2][site]
    assert (exact <= got[1]).all() and (got[1] <= got[2]).all()  # budgets are monotone


def test_relaxed_gate_sound_on_adversarial_density(rng, monkeypatch):
    """All-zero text: every position is a candidate, the gated path's budget
    overflows and the dense fallback keeps counts exact (spy: both routes)."""
    monkeypatch.setattr(PC, "APPROX_SPARSE_MIN_ELEMS", 0)
    t = np.zeros(16384, np.uint8)
    pats = [np.zeros(4, np.uint8), np.full(4, 7, np.uint8), np.arange(4, dtype=np.uint8),
            np.ones(4, np.uint8), np.zeros(8, np.uint8), np.zeros(16, np.uint8)]
    for k in (1, 2):
        rp, ridx, pp, pidx = _both([t], pats, k)
        spy = Spy(monkeypatch, *ROUTES)
        got = E.count_many(pidx, pp, k=k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(R.count_many_jit(ridx, rp, k=k)))
        if k == 1:  # the m = 4 group carries a k = 1 gate: tried, overflowed
            assert spy.calls["_approx_candidates"] == 1 and spy.calls["_approx_verify_counts"] == 0
        assert spy.calls["_dense_count_approx"] == len(pp)
        for row, pid in enumerate(E.plan_order(pp)):
            assert int(got[0, row]) == RA.kmismatch_naive(t, pats[pid], k).sum()


@pytest.mark.parametrize("m", [4, 7, 8, 13])
def test_relaxed_lut_equal_reference(rng, m):
    """The relaxed LUT equals the reference's, and covers the fingerprint of
    every window within one substitution of the pattern."""
    assert PR.expansion_count(m, 2) == RR.expansion_count(m, 2)
    np.testing.assert_array_equal(PR.byte_coefs(m), RR.byte_coefs(m))
    pats = rng.randint(0, 256, size=(3, m)).astype(np.uint8)
    for k in (0, 1, 2):
        got = PR.relaxed_window_lut(pats, kbits=E.ENGINE_KBITS, k=k)
        want = RR.relaxed_window_lut(pats, kbits=R.ENGINE_KBITS, k=k)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    lut = PR.relaxed_window_lut(pats[:1], kbits=E.ENGINE_KBITS, k=1)
    for _ in range(200):
        w = pats[0].copy()
        w[rng.randint(0, m)] = rng.randint(0, 256)
        fp = E._np_window_fingerprint(E._np_pack_words(w[None, :], E._word_offsets(m)), E.ENGINE_KBITS)[0]
        assert lut[fp]
    assert PR.byte_coefs(3) is None and PR.byte_coefs(40) is None
    assert PR.relaxed_window_lut(pats, kbits=17, k=3) is None


def test_compile_patterns_k_fields_equal_reference(rng):
    """relaxed_lut / relaxed_bits / k of every plan, canonical rounding included."""
    t = make_text(rng, 2000, 64)
    pats = _mixed_patterns(rng, t, (3, 4, 6, 8, 16, 20))
    for k in (1, 2):
        for canonical in (False, True):
            rp = R.compile_patterns(pats, k=k, canonical=canonical)
            pp = E.compile_patterns(pats, k=k, canonical=canonical, device=CPU)
            for a, b in zip(rp, pp):
                assert (a.m, a.k, a.relaxed_bits, a.lut_pop) == (b.m, b.k, b.relaxed_bits, b.lut_pop)
                assert (a.relaxed_lut is None) == (b.relaxed_lut is None)
                if a.relaxed_lut is not None:
                    np.testing.assert_array_equal(b.relaxed_lut.numpy(), np.asarray(a.relaxed_lut))


def test_sparse_gated_count_path(rng, monkeypatch):
    """The relaxed-LUT sparse path (P >= 4, low union density) on ragged rows,
    with its elements floor lowered so a small batch takes it: equal to the
    reference (which counts this batch densely) and to the naive oracle."""
    monkeypatch.setattr(PC, "APPROX_SPARSE_MIN_ELEMS", 0)
    docs = [make_text(rng, n, 256) for n in (20_000, 3_000)]
    pats = [docs[0][s : s + 4].copy() for s in (100, 5000, 12_000, 17_777)]
    rp, ridx, pp, pidx = _both(docs, pats, 1)
    assert pp[0].relaxed_lut is not None and PC._block_frac(pp[0]) <= PC.BLOCK_FRAC_MAX
    spy = Spy(monkeypatch, *ROUTES)
    got = E.count_many(pidx, pp, k=1)
    assert spy.calls["_approx_verify_counts"] == 1 and spy.calls["_dense_count_approx"] == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(R.count_many_jit(ridx, rp, k=1)))
    for end_min in (0, 4000):
        np.testing.assert_array_equal(
            E.count_many(pidx, pp, k=1, end_min=end_min).numpy(),
            np.asarray(R.count_many(ridx, rp, k=1, end_min=end_min)))
    for bi, doc in enumerate(docs):
        for row, pid in enumerate(E.plan_order(pp)):
            assert int(got[bi, row]) == RA.kmismatch_naive(doc, pats[pid], 1).sum()


def test_full_mask_route_is_the_kernel_route(rng, monkeypatch):
    """match_many(k > 0) goes through match_group_approx, whose plain version
    runs on a CPU index (the kernel route needs a CUDA index)."""
    t = make_text(rng, 500, 4)
    pp = E.compile_patterns([t[10:18], t[40:43]], k=1, device=CPU)
    spy = Spy(monkeypatch, *ROUTES)
    E.match_many(E.build_index(t, device=CPU), pp)
    assert spy.calls["_dense_match_approx"] == 2 and spy.calls["_match_approx_kernel"] == 0


def test_op_matches_reference_kernel_and_oracle(rng):
    """The op (plain version on the CPU) equals the reference's Pallas
    kernel in interpret mode in one small case, and its pure-jnp oracle
    across regimes, budgets and ragged rows."""
    texts = np.stack([make_text(rng, 300, 4) for _ in range(2)])
    lengths = np.asarray([300, 117], np.int32)
    ps = np.stack([texts[0][40:48], rng.randint(0, 4, size=8).astype(np.uint8)])
    got = approx_batched(texts, ps, 1, lengths, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(r_approx_batched(texts, ps, 1, lengths, tile=128)))
    for sigma in (4, 256):
        texts = np.stack([make_text(rng, 300, sigma) for _ in range(2)])
        for m in (1, 2, 5, 8, 16):
            ps = np.stack([texts[0][40 : 40 + m], rng.randint(0, sigma, size=m).astype(np.uint8)])
            for k in (0, 1, 2, m):
                want = np.asarray(r_approx_batched_ref(texts, ps, k, lengths))
                got = approx_batched(texts, ps, k, lengths, device=CPU)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"m={m} k={k}")
                np.testing.assert_array_equal(
                    approx_batched_ref(torch.from_numpy(texts), torch.from_numpy(ps), k,
                                       torch.from_numpy(lengths)).numpy(), want)
            np.testing.assert_array_equal(
                approx_multipattern(texts[0], ps, 1, device=CPU).numpy(),
                np.asarray(r_approx_batched_ref(texts[:1], ps, 1))[0])


def test_op_checks_and_wrapper_needs_the_card():
    t = np.zeros(10, np.uint8)
    for bad, kw in ((np.zeros((1, 128), np.uint8), {}), (np.zeros((1, 4), np.uint8), {"k": -1})):
        with pytest.raises(ValueError):
            approx_batched(t, bad, kw.get("k", 1), device=CPU)
        with pytest.raises(ValueError):
            r_approx_batched(t, bad, kw.get("k", 1))
    with pytest.raises(ValueError):
        approx_batched(t, np.zeros(4, np.uint8), 1, device=CPU)
    assert approx_batched(np.zeros((2, 0), np.uint8), np.zeros((1, 3), np.uint8), 1, device=CPU).shape == (2, 1, 0)
    (plan,) = E.compile_patterns([b"abcd"], k=1, device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        approx_cuda(torch.zeros((1, 10), dtype=torch.uint8), plan.patterns, plan.anchors, 1)


def test_epsm_find_k_kwarg(rng):
    """epsm.find/count/positions expose the budget as a kwarg."""
    t = make_text(rng, 800, 4)
    p = rng.randint(0, 4, size=6).astype(np.uint8)
    want = RA.kmismatch_naive(t, p, 1)
    got = Pepsm.find(t, p, k=1, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(Repsm.find(t, p, k=1)))
    np.testing.assert_array_equal(got.numpy(), want)
    c = Pepsm.count(t, p, k=1, device=CPU)
    assert c.dtype == torch.int32 and int(c) == int(Repsm.count(t, p, k=1)) == want.sum()
    np.testing.assert_array_equal(Pepsm.positions(t, p, k=1, device=CPU), np.nonzero(want)[0])


def test_patternset_k_matches_reference(rng):
    """A k = 1 PatternSet (typo-tolerant blocklist) answers as the reference's."""
    docs = [make_text(rng, 600, 26) + 97 for _ in range(5)]
    bad = b"forbiddenterm"
    corrupted = np.frombuffer(bad, np.uint8).copy()
    corrupted[5] ^= 2
    for i in (1, 4):
        docs[i][300 : 300 + len(bad)] = corrupted
    pats = [bad, b"\x01\x02\x03\x04\x05", b"\x01\x02\x03"]  # outside the documents' alphabet
    got, want = Pmp.PatternSet(pats, k=1, device=CPU), Rmp.PatternSet(pats, k=1)
    mat = np.stack(docs)
    np.testing.assert_array_equal(got.blocked(mat).numpy(), np.asarray(want.blocked(mat)))
    assert got.blocked(mat).numpy().tolist() == [i in (1, 4) for i in range(5)]
    for d in docs:
        assert bool(got.contains_any(d)) == bool(want.contains_any(d))
        np.testing.assert_array_equal(got.count_each(d).numpy(), np.asarray(want.count_each(d)))
    assert not Pmp.PatternSet(pats, device=CPU).blocked(mat).numpy().any()


def test_piece_split_is_disjoint_and_covers():
    """k + 1 pieces of lengths m // (k + 1) or one more, in order, disjoint,
    covering [0, m); the longer ones last (16 at k = 2: 5, 5, 6)."""
    assert AXK.pieces(16, 2) == [(0, 5), (5, 5), (10, 6)]
    for m in range(1, 70):
        for k in range(0, m + 2):
            ps = AXK.pieces(m, k)
            assert len(ps) == k + 1
            assert [o for o, _ in ps] == [sum(ln for _, ln in ps[:j]) for j in range(k + 1)]
            assert sum(ln for _, ln in ps) == m
            lens = [ln for _, ln in ps]
            assert set(lens) <= {m // (k + 1), m // (k + 1) + 1} and lens == sorted(lens)


def test_piece_rule_sends_short_pieces_to_the_first_word_path():
    """One static rule: pieces of a packed word or more, within the table
    cap and the block's shared memory; shorter pieces (m < 4 (k + 1)),
    budgets of m or more, oversized tables and, past 32 patterns, too many
    pieces keep the first-word path."""
    assert AXO.use_pieces is AXK.use_pieces and AXO.PIECE_TABLE_CAP == 64 << 20
    assert AXK.use_pieces(16, 2, 32) and AXK.use_pieces(16, 3, 32) and AXK.use_pieces(32, 2, 1)
    assert AXK.use_pieces(8, 1, 8) and AXK.use_pieces(4, 0, 1)
    assert not AXK.use_pieces(8, 2, 32) and not AXK.use_pieces(15, 3, 32)  # pieces under 4 bytes
    assert not any(AXK.use_pieces(m, k, 4) for m in range(1, 40) for k in range(m, m + 3))
    for m in range(1, 130):
        for k in range(0, 8):
            assert AXK.use_pieces(m, k, 32) == (m >= 4 * (k + 1))
    big = 32 * (AXK.PIECE_TABLE_CAP // (3 * (4 << AXK.PIECE_BITS)))
    assert AXK.use_pieces(16, 2, big) and not AXK.use_pieces(16, 2, big + 1)
    # past 32 patterns each piece's rows take 8 KB of the block's shared memory
    assert AXK.pieces_smem_bytes(16, 2, 32) == 4096 + 16 + 16
    assert AXK.pieces_smem_bytes(127, 2, 33) == 4096 + 128 + 16 + 3 * 8192
    assert AXK.SMEM_BUDGET == 227 * 1024
    assert AXK.use_pieces(127, 26, 33) and not AXK.use_pieces(127, 27, 33)
    assert AXK.use_pieces(127, 30, 32) and not AXK.use_pieces(127, 30, 33)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_piece_filter_flags_every_reference_match(rng, k):
    """The pigeonhole filter's plain version flags every (pattern, start)
    the reference's Pallas kernel reports within k (interpret mode, one
    length in four) and its jnp oracle (every m in 4..33 the filter
    takes), on rows of alphabet 2, 4, 20 and 256, with planted 1- and
    k-mismatch copies."""
    texts = np.stack([make_text(rng, 300, sigma) for sigma in (2, 4, 20, 256)])
    lengths = np.asarray([300, 277, 300, 150], np.int32)
    tt = torch.from_numpy(texts)
    for m in range(4 * (k + 1), 34):
        ps = np.stack([texts[r][s : s + m] for r, s in ((0, 7), (1, 40), (2, 100), (3, 3))]
                      + [rng.randint(0, 4, size=m).astype(np.uint8)])
        ps[1, m // 2] ^= 1
        ps[2, [j * m // (k + 1) for j in range(k)]] ^= 2  # one change in k of the pieces
        if m % 4 == k:
            want = np.asarray(r_approx_batched(texts, ps, k, lengths, tile=128))
        else:
            want = np.asarray(r_approx_batched_ref(texts, ps, k, lengths))
        cand = approx_piece_candidates_ref(tt, torch.from_numpy(ps), k).numpy()
        assert not (want & ~cand).any(), f"m={m} k={k}: a match is not flagged"
        got = approx_batched_ref(tt, torch.from_numpy(ps), k, torch.from_numpy(lengths)).numpy()
        np.testing.assert_array_equal(got & cand, want)
        assert want[0, 0].any() and want[2, 2].any() and want[3, 3].any()
        assert want[1, 1].any() == (k >= 1)


def test_piece_tables_cached_and_rebuilt_on_change(rng):
    """The tables are built once per (patterns tensor, k), hold each
    piece's pattern bits at its hash, and are rebuilt when the tensor is
    changed in place or another tensor or budget comes."""
    pats = torch.from_numpy(rng.randint(0, 4, size=(40, 16)).astype(np.uint8))
    t2 = AXK.piece_tables(pats, 2)
    assert t2.shape == (3, 1 << AXK.PIECE_BITS, 2) and t2.dtype == torch.int32
    assert AXK.piece_tables(pats, 2) is t2
    rows = AXK.piece_hashes(pats.numpy(), 2)
    for j in range(3):
        for p in range(40):
            assert (int(t2[j, rows[j, p], p // 32]) >> (p % 32)) & 1
    assert int(torch.stack([t2[j].view(-1) for j in range(3)]).ne(0).sum()) <= 3 * 40
    t1 = AXK.piece_tables(pats, 1)
    assert t1.shape[0] == 2 and AXK.piece_tables(pats, 2) is t2
    pats[0, 0] ^= 1
    t2b = AXK.piece_tables(pats, 2)
    assert t2b is not t2
    np.testing.assert_array_equal(t2b.numpy(), AXK.piece_tables_np(pats.numpy(), 2).view(np.int32))
    other = pats.clone()
    assert AXK.piece_tables(other, 2) is not t2b
