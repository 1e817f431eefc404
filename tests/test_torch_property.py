"""Hypothesis property tests on the port's invariants: a mirror of
tests/test_property.py over repro_torch (epsm.find / count, find_multi,
PatternSet), held against the port's naive_np oracle and, where it costs no
compile, the reference's (``repro.core.baselines.naive_np``).  Tolerance:
equal.  Every port call runs on the CPU (``device="cpu"``)."""

import functools

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import baselines as R  # noqa: E402
from repro_torch.core import baselines, epsm  # noqa: E402
from repro_torch.core.multipattern import PatternSet, find_multi  # noqa: E402

CPU = "cpu"
SETTINGS = dict(max_examples=30, deadline=None)

small_alphabet_text = st.lists(
    st.integers(0, 3), min_size=0, max_size=600
).map(lambda xs: np.array(xs, dtype=np.uint8))


def _find(t, p, **kw):
    return epsm.find(t, p, device=CPU, **kw).numpy()


def _count(t, p) -> int:
    return int(epsm.count(t, p, device=CPU)) if len(t) else 0


@given(t=small_alphabet_text, m=st.integers(1, 40), seed=st.integers(0, 2**31 - 1))
@settings(**SETTINGS)
def test_find_equals_oracle_random(t, m, seed):
    rng = np.random.RandomState(seed)
    p = rng.randint(0, 4, size=m).astype(np.uint8)
    got = _find(t, p)
    oracle = baselines.naive_np(t, p)
    np.testing.assert_array_equal(oracle, R.naive_np(t, p))
    np.testing.assert_array_equal(got, oracle)


@given(t=small_alphabet_text, m=st.integers(1, 40), start=st.integers(0, 10**6))
@settings(**SETTINGS)
def test_extracted_pattern_always_found(t, m, start):
    if len(t) < m:
        return
    s = start % (len(t) - m + 1)
    p = t[s : s + m].copy()
    mask = _find(t, p)
    assert mask[s], "extracted occurrence must be reported"
    # soundness: every reported position is a true occurrence
    for i in np.nonzero(mask)[0]:
        assert np.array_equal(t[i : i + m], p)


@given(
    a=small_alphabet_text,
    b=small_alphabet_text,
    m=st.integers(1, 16),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_concat_superadditive_counts(a, b, m, seed):
    """occ(a ++ b) >= occ(a) + occ(b): concatenation can only add matches."""
    rng = np.random.RandomState(seed)
    p = rng.randint(0, 4, size=m).astype(np.uint8)
    cab = _count(np.concatenate([a, b]), p)
    assert cab >= _count(a, p) + _count(b, p)
    assert cab == int(baselines.naive_np(np.concatenate([a, b]), p).sum())


@given(t=small_alphabet_text, seed=st.integers(0, 2**31 - 1))
@settings(**SETTINGS)
def test_prefix_shift_invariance(t, seed):
    """Prepending k bytes shifts every match position by exactly k."""
    rng = np.random.RandomState(seed)
    m = int(rng.randint(1, 20))
    p = rng.randint(0, 4, size=m).astype(np.uint8)
    k = int(rng.randint(1, 8))
    prefix = rng.randint(4, 8, size=k).astype(np.uint8)  # disjoint alphabet
    base = _find(t, p)
    shifted = _find(np.concatenate([prefix, t]), p)
    np.testing.assert_array_equal(shifted[k:], base)


@given(
    t=small_alphabet_text,
    m=st.integers(2, 12),
    n_pat=st.integers(1, 5),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_multipattern_matches_individual(t, m, n_pat, seed):
    rng = np.random.RandomState(seed)
    pats = rng.randint(0, 4, size=(n_pat, m)).astype(np.uint8)
    if len(t) == 0:
        return
    stacked = find_multi(t, pats, device=CPU).numpy()
    for i in range(n_pat):
        np.testing.assert_array_equal(stacked[i], _find(t, pats[i]))
        np.testing.assert_array_equal(stacked[i], baselines.naive_np(t, pats[i]))


@given(seed=st.integers(0, 2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_patternset_contains_any(seed):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, 4, size=400).astype(np.uint8)
    present = t[13 : 13 + 6].copy()
    absent = np.full(6, 200, dtype=np.uint8)
    ps = PatternSet([absent, present], device=CPU)
    assert bool(ps.contains_any(t))
    ps2 = PatternSet([absent], device=CPU)
    assert not bool(ps2.contains_any(t))


@given(t=small_alphabet_text, algo=st.sampled_from(["epsma", "epsmb", "epsmc"]))
@settings(**SETTINGS)
def test_algorithms_agree(t, algo):
    """All three regimes produce identical masks on any input."""
    if len(t) < 20:
        return
    p = t[3:23].copy()  # m=20 valid for every regime (a/b generalize upward)
    np.testing.assert_array_equal(_find(t, p, algo=algo), _find(t, p, algo="auto"))


@given(t=small_alphabet_text, m=st.integers(1, 32), seed=st.integers(0, 2**31 - 1),
       seg=st.integers(1, 700))
@settings(**SETTINGS)
def test_baselines_equal_oracle_at_any_segment_width(t, m, seed, seg):
    """The port's baselines (the four device loops at any segment width)
    against the oracle: the property the CUDA loops' seam rule rests on."""
    rng = np.random.RandomState(seed)
    p = rng.randint(0, 4, size=m).astype(np.uint8)
    if len(t) >= m and rng.rand() < 0.5:
        s = rng.randint(0, len(t) - m + 1)
        p = t[s : s + m].copy()
    oracle = baselines.naive_np(t, p)
    for name, fn in baselines.BASELINES.items():
        if name == "bndm" and m > 31:
            continue
        if name in baselines.SEG:
            fn = functools.partial(baselines._loop, name, seg=seg)
        np.testing.assert_array_equal(fn(t, p, device=CPU).numpy(), oracle, err_msg=name)
