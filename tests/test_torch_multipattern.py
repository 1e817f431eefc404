"""repro_torch's multi-pattern layer against the reference, bit for bit.

Mirrors tests/test_multipattern_kernel.py and the find_multi / PatternSet
cases of tests/test_match_many.py and tests/test_dictionary.py.  The port's
ops run on the CPU, that is through the kernel's plain version; the
reference side is its oracle ``multipattern_batched_ref`` and, in two cases,
the Pallas op in interpret mode.  The CUDA kernel itself is held against
the plain version on the card by chip_smoke.py; here its wrapper's argument
checks and LUT bitset are tested.  No tolerance anywhere.
"""

import importlib

import numpy as np
import pytest
import torch

from repro.core import engine as R_engine
from repro.core import multipattern as R_mp
from repro.kernels import multipattern as R_k
from repro_torch.core import engine as E
from repro_torch.core import multipattern as MP
from repro_torch.kernels import multipattern as K

# the launch wrapper's module (the package re-exports the op under its name)
K_cuda = importlib.import_module("repro_torch.kernels.multipattern.multipattern")

from conftest import make_text

CPU = "cpu"


@pytest.fixture
def rng():
    """A fresh generator per test, so no test's data depends on which tests
    ran before it in the same process (pytest-xdist distributes files)."""
    return np.random.RandomState(0xC0FFEE)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _oracle(text, pat) -> np.ndarray:
    n, m = len(text), len(pat)
    out = np.zeros(n, bool)
    if n >= m:
        out[: n - m + 1] = (np.lib.stride_tricks.sliding_window_view(text, m) == pat).all(-1)
    return out


def _stack(rng, t, P, m):
    return np.stack([t[s : s + m] for s in rng.randint(0, len(t) - m + 1, P)])


# ---------------------------------------------------------------------------
# The kernel's op (plain version on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [2, 4, 256])
@pytest.mark.parametrize("n", [100, 4095, 4097, 9000])
def test_multipattern_op_sweep(rng, sigma, n):
    """The reference sweep: P in (1, 3, 8) x m in (4, 7, 8, 12), against the
    numpy oracle everywhere and the reference oracle at P = 3 (at two sizes:
    each size costs the reference a compile)."""
    t = make_text(rng, n, sigma)
    for n_pat in (1, 3, 8):
        for m in (4, 7, 8, 12):
            ps = _stack(rng, t, n_pat, m)
            got = K.multipattern(_t(t), _t(ps))
            assert got.dtype == torch.bool and got.shape == (n_pat, n)
            want = np.stack([_oracle(t, p) for p in ps])
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"P={n_pat} m={m}")
            if n_pat == 3 and n in (4095, 4097):
                np.testing.assert_array_equal(got.numpy(), np.asarray(R_k.multipattern_ref(t, ps)))


@pytest.mark.parametrize("m,n_pat", [(8, 8), (20, 2)])
def test_multipattern_op_vs_pallas_interpret(rng, m, n_pat):
    """The Pallas op itself (interpret mode): gate on (m = 8) and off (m = 20)."""
    t = make_text(rng, 4097, 4)
    ps = _stack(rng, t, n_pat, m)
    ps[-1, -1] = 0  # a pattern ending in 0x00, which the zero padding must not complete
    np.testing.assert_array_equal(K.multipattern(_t(t), _t(ps)).numpy(),
                                  np.asarray(R_k.multipattern(t, ps)))


def test_multipattern_batched_ragged_vs_reference(rng):
    B, n = 3, 1500
    texts = np.stack([make_text(rng, n, 4) for _ in range(B)])
    lengths = np.array([1500, 1001, 13], np.int32)
    for m, P in ((9, 7), (16, 3)):
        ps = _stack(rng, texts[0], P, m)
        got = K.multipattern_batched(_t(texts), _t(ps), _t(lengths))
        assert got.shape == (B, P, n)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(R_k.multipattern_batched_ref(texts, ps, lengths)))


def test_multipattern_long_patterns_and_tile_edge(rng):
    """m >= 16 (no gate) and m = 4096, the longest the kernel takes."""
    t = make_text(rng, 9000, 2)
    for m in (16, 24, 36, 4096):
        ps = np.stack([t[50 : 50 + m], t[4000 : 4000 + m]])
        got = K.multipattern(_t(t), _t(ps)).numpy()
        for i in range(2):
            np.testing.assert_array_equal(got[i], _oracle(t, ps[i]), err_msg=f"m={m}")


def test_multipattern_errors(rng):
    t = _t(make_text(rng, 100, 4))
    with pytest.raises(ValueError):
        K.multipattern(t, torch.zeros((2, 3), dtype=torch.uint8))  # m < 4
    with pytest.raises(ValueError):
        K.multipattern(t, torch.zeros(8, dtype=torch.uint8))  # not (P, m)
    with pytest.raises(ValueError, match="tile"):
        K.multipattern(_t(make_text(rng, 5000, 4)), torch.zeros((1, 4097), dtype=torch.uint8))
    assert K.multipattern(torch.zeros(0, dtype=torch.uint8), torch.zeros((2, 4), dtype=torch.uint8)).shape == (2, 0)


def test_kernel_wrapper_takes_only_cuda_tensors(rng):
    """No CPU fallback inside the launch wrapper: a CPU tensor is refused."""
    plan, = E.compile_patterns([b"abcdefgh"], device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        K_cuda.multipattern_cuda(_t(make_text(rng, 100, 4))[None, :], plan.anchors, 8,
                                 plan.lut_any, kbits=plan.kbits, use_lut=True)
    assert K_cuda.multipattern_cuda.launches == 0


@pytest.mark.parametrize("nbits", [1, 31, 32, 1 << 17])
def test_lut_bitset_layout(rng, nbits):
    """The kernel's LUT bitset: bit j of word w is lut[32 w + j]."""
    lut = rng.rand(nbits) < 0.3
    lut[-1] = True  # the top bit of a full word is the int32 sign bit
    words = K_cuda._lut_bitset(_t(lut))
    assert words.dtype == torch.int32 and words.numel() == -(-nbits // 32)
    bits = np.unpackbits(words.numpy().view(np.uint8), bitorder="little")[:nbits]
    np.testing.assert_array_equal(bits.astype(bool), lut)


def test_lut_bitset_cached_per_lut():
    """A plan's LUT is packed once; an edited LUT is packed again."""
    lut = torch.zeros(1 << 10, dtype=torch.bool)
    lut[5] = True
    first = K_cuda._cached_bitset(lut)
    assert K_cuda._cached_bitset(lut) is first and int(first[0]) == 1 << 5
    lut[33] = True
    again = K_cuda._cached_bitset(lut)
    assert again is not first and int(again[1]) == 1 << 1
    other = lut.clone()
    assert K_cuda._cached_bitset(other) is not again


def test_kernel_salts_are_the_engine_salts():
    from repro.core.packing import FP_MULT, WORD_SALTS

    assert list(K_cuda._Salts((K_cuda.ctypes.c_uint32 * 8)(*map(int, WORD_SALTS))).s) == list(
        map(int, WORD_SALTS))
    assert int(K_cuda.FP_MULT) == int(FP_MULT)


# ---------------------------------------------------------------------------
# find_multi / count_multi / contains_any and the per-pattern baseline
# ---------------------------------------------------------------------------

def test_engine_equals_per_pattern_baseline(rng):
    t = make_text(rng, 4096, 8)
    for m in (3, 4, 8, 13, 20):
        ps = _stack(rng, t, 6, m)
        got = MP.find_multi(t, ps, device=CPU)
        base = MP.find_multi_vmap(t, ps, device=CPU)
        np.testing.assert_array_equal(got.numpy(), base.numpy())
        np.testing.assert_array_equal(got.numpy(), np.stack([_oracle(t, p) for p in ps]))
        counts = MP.count_multi(t, ps, device=CPU)
        assert counts.dtype == torch.int32
        np.testing.assert_array_equal(counts.numpy(), MP.count_multi_vmap(t, ps, device=CPU).numpy())
        np.testing.assert_array_equal(counts.numpy(), got.numpy().sum(-1))


def test_find_multi_matches_reference(rng):
    t = make_text(rng, 3000, 4)
    ps = _stack(rng, t, 5, 8)
    np.testing.assert_array_equal(MP.find_multi(t, ps, device=CPU).numpy(),
                                  np.asarray(R_mp.find_multi(t, ps)))
    np.testing.assert_array_equal(MP.count_multi(t, ps, device=CPU).numpy(),
                                  np.asarray(R_mp.count_multi(t, ps)))
    assert bool(MP.contains_any(t, ps, device=CPU)) is bool(R_mp.contains_any(t, ps))
    absent = np.full((2, 8), 200, np.uint8)
    assert not bool(MP.contains_any(t, absent, device=CPU))


# ---------------------------------------------------------------------------
# PatternSet
# ---------------------------------------------------------------------------

def test_patternset_blocked_batch(rng):
    # bytes 4..7: neither pattern can occur except where it is planted
    docs = [make_text(rng, 300, 4) + 4 for _ in range(8)]
    bad = b"\x01\x02\x03\x01\x02\x03\x00"
    for i in (2, 5):
        docs[i][100:107] = np.frombuffer(bad, np.uint8)
    ps = MP.PatternSet([bad, b"\x09\x09"], device=CPU)
    idx = ps.index(docs)
    assert set(np.nonzero(E.any_hit(idx, ps.plans).numpy())[0].tolist()) == {2, 5}
    assert ps.count_each(docs[2]).shape == (2,)
    mat = np.stack(docs)
    np.testing.assert_array_equal(ps.blocked(mat).numpy(), [i in (2, 5) for i in range(8)])
    lengths = np.full(8, 300, np.int32)
    lengths[5] = 100
    np.testing.assert_array_equal(ps.blocked(mat, lengths).numpy(), [i == 2 for i in range(8)])
    assert bool(ps.contains_any(docs[5])) and not bool(ps.contains_any(docs[0]))


def test_patternset_count_each_matches_reference(rng):
    t = make_text(rng, 2500, 4)
    pats = [bytes(t[s : s + m]) for m, s in ((2, 5), (6, 40), (6, 700), (9, 80), (17, 1200))]
    pats.append(b"\x07" * 5)
    got = MP.PatternSet(pats, device=CPU)
    want = R_mp.PatternSet(pats)
    np.testing.assert_array_equal(got.order, want.order)
    counts = got.count_each(t)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want.count_each(t)))
    assert sorted(got.groups) == sorted(want.groups)


def test_patternset_dictionary_passthrough(rng):
    pats = [bytes(p) for p in np.unique(rng.randint(0, 256, (600, 8)).astype(np.uint8), axis=0)[:300]]
    flat = MP.PatternSet(pats, bucket=False, automaton=False, device=CPU)
    buck = MP.PatternSet(pats, bucket=True, automaton=False, device=CPU)
    assert any(p.slot_off is not None for p in buck.plans)
    doc = make_text(rng, 4096, 256)
    for i in range(0, 300, 7):
        doc[(i * 131) % 4000 :][:8] = np.frombuffer(pats[i], np.uint8)
    assert bool(flat.contains_any(doc)) == bool(buck.contains_any(doc))
    np.testing.assert_array_equal(flat.count_each(doc).numpy(), buck.count_each(doc).numpy())


def test_patternset_unported_parts_raise():
    """k > 0 sets and contains_any_stream, once deferred, answer as the
    reference; an empty set still raises."""
    fuzzy = MP.PatternSet([b"abcd"], k=1, device=CPU)
    assert fuzzy.k == 1 and bool(fuzzy.contains_any(b"xxabzd"))
    assert bool(fuzzy.contains_any(b"xxabzd")) == bool(R_mp.PatternSet([b"abcd"], k=1).contains_any(b"xxabzd"))
    ps = MP.PatternSet([b"abcd"], device=CPU)
    for src in ([b"xxab", b"cd"], [b"xxabzd"]):
        assert ps.contains_any_stream(src) == R_mp.PatternSet([b"abcd"]).contains_any_stream(src)
    assert fuzzy.contains_any_stream([b"xxab", b"zd"])
    with pytest.raises(ValueError):
        MP.PatternSet([], device=CPU)


def test_cached_plans_serve_the_op(rng):
    """The op compiles its plan through compile_patterns_cached: a repeat
    call with the same patterns is a cache hit, and the plan equals the
    reference's for the same stack."""
    t = make_text(rng, 500, 4)
    ps = _stack(rng, t, 4, 8)
    K.multipattern(_t(t), _t(ps))
    before = E.plan_cache_stats()["hits"]
    K.multipattern(_t(t), _t(ps))
    assert E.plan_cache_stats()["hits"] == before + 1
    (ref,) = R_engine.compile_patterns_cached(list(ps))
    (port,) = E.compile_patterns_cached(list(ps), automaton=False, device=CPU)
    np.testing.assert_array_equal(port.lut_any.numpy(), np.asarray(ref.lut_any))
    np.testing.assert_array_equal(port.anchors.numpy().view(np.uint32), np.asarray(ref.anchors))
