"""Hypothesis property tests for the port's k-mismatch subsystem: a mirror
of tests/test_approx_property.py.  The port's engine.count_many /
match_many under any budget against the port's approx.kmismatch_naive, over
random alphabets {2, 4, 256} and pattern lengths 2..16; the port's oracle is
held equal to the reference's on the same inputs.  Every call runs on the
CPU.  Tolerance: equal."""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.approx import kmismatch_naive as ref_kmismatch_naive  # noqa: E402
from repro_torch.approx import kmismatch_naive  # noqa: E402
from repro_torch.core import engine  # noqa: E402

CPU = "cpu"
SETTINGS = dict(max_examples=25, deadline=None)

sigma_st = st.sampled_from([2, 4, 256])


def _count(t, p, k: int) -> int:
    plans = engine.compile_patterns([p], k=k, device=CPU)
    idx = engine.build_index(t, device=CPU)
    return int(engine.count_many(idx, plans, k=k)[0, 0])


@given(
    sigma=sigma_st,
    n=st.integers(0, 400),
    m=st.integers(2, 16),
    k=st.integers(0, 2),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_count_many_equals_naive(sigma, n, m, k, seed):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, sigma, size=n).astype(np.uint8)
    p = rng.randint(0, sigma, size=m).astype(np.uint8)
    want = kmismatch_naive(t, p, k)
    np.testing.assert_array_equal(want, ref_kmismatch_naive(t, p, k))
    assert _count(t, p, k) == want.sum()


@given(
    sigma=sigma_st,
    m=st.integers(2, 16),
    k=st.integers(0, 2),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_extracted_window_with_k_typos_found(sigma, m, k, seed):
    """Completeness: corrupt an extracted window at exactly k positions —
    the budget-k scan must still report that start position."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, sigma, size=200).astype(np.uint8)
    s = rng.randint(0, len(t) - m + 1)
    p = t[s : s + m].copy()
    for j in rng.choice(m, size=k, replace=False):
        t[s + j] = rng.randint(0, 256)
    plans = engine.compile_patterns([p], k=k, device=CPU)
    mask = engine.match_many(engine.build_index(t, device=CPU), plans, k=k)[0, 0].numpy()
    assert mask[s]
    # soundness: every reported position really is within distance k
    for i in np.nonzero(mask)[0]:
        assert np.count_nonzero(t[i : i + m] != p) <= k
    np.testing.assert_array_equal(mask, kmismatch_naive(t, p, k))


@given(
    sigma=sigma_st,
    m=st.integers(2, 16),
    seed=st.integers(0, 2**31 - 1),
)
@settings(**SETTINGS)
def test_budget_monotone(sigma, m, seed):
    """occ_k(t, p) is nondecreasing in k, and occ_0 equals the exact path."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, sigma, size=300).astype(np.uint8)
    p = rng.randint(0, sigma, size=m).astype(np.uint8)
    idx = engine.build_index(t, device=CPU)
    prev = None
    for k in (0, 1, 2, 3):
        plans = engine.compile_patterns([p], k=min(k, 2), device=CPU)
        c = int(engine.count_many(idx, plans, k=k)[0, 0])
        if prev is not None:
            assert c >= prev
        prev = c
    exact = engine.count_many(idx, engine.compile_patterns([p], device=CPU))
    assert int(exact[0, 0]) == int(kmismatch_naive(t, p, 0).sum())
