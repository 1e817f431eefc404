"""repro_torch.core.baselines against repro.core.baselines, bit for bit.

Mirrors tests/test_baselines.py: every baseline at sigma in {2, 4, 20, 256}
and m in {1, 2, 3, 4, 8, 16, 24, 31}, shift_or at m = 32 and its raise past
it, bndm's raise, periodic patterns; each output equal to the reference
function's and to both packages' naive_np oracles (tolerance: equal).  The
four device loops (shift_or, kmp_dfa, hash3, bndm) run here as their plain
segmented versions; each is held against the reference at segment widths
1, 2, m - 1, m, 7, 64 and n, so that every seam case of the CUDA kernel's
rule (an occurrence across a seam, segments narrower than the warm-up, a
single segment) is reached.  Also: the host tables equal the reference's
arrays, rabin_karp's mod-2^32 wraparound, the dispatch by device, and the
device rule for host inputs.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core import baselines as R
from repro_torch.core import baselines as P
from repro_torch.kernels.baselines import baselines as K
from repro_torch.kernels.baselines import ops, ref

CPU = "cpu"
N = 1500
LENGTHS = (1, 2, 3, 4, 8, 16, 24, 31)
SIGMAS = (2, 4, 20, 256)
LOOPS = ("bndm", "hash3", "kmp_dfa", "shift_or")
SEGS = ("1", "2", "m-1", "m", "7", "64", "n")


@functools.lru_cache(maxsize=None)
def _case(sigma: int):
    """The text of one alphabet and one extracted pattern per length, from
    a seed of their own, so no test depends on which ran before it."""
    rng = np.random.RandomState(1000 + sigma)
    t = rng.randint(0, sigma, size=N).astype(np.uint8)
    pats = {}
    for m in LENGTHS:
        s = rng.randint(0, N - m + 1)
        pats[m] = t[s : s + m].copy()
    return t, pats


@functools.lru_cache(maxsize=None)
def _reference(name: str, sigma: int, m: int) -> np.ndarray:
    t, pats = _case(sigma)
    return np.asarray(R.BASELINES[name](t, pats[m]))


def _seg(kind: str, m: int, n: int) -> int:
    return {"1": 1, "2": 2, "m-1": max(1, m - 1), "m": m, "7": 7, "64": 64, "n": n}[kind]


@pytest.mark.parametrize("name", sorted(R.BASELINES))
@pytest.mark.parametrize("sigma", SIGMAS)
def test_baseline_matches_reference_and_oracle(name, sigma):
    t, pats = _case(sigma)
    for m in LENGTHS:
        p = pats[m]
        oracle = P.naive_np(t, p)
        np.testing.assert_array_equal(oracle, R.naive_np(t, p))
        got = P.BASELINES[name](t, p, device=CPU)
        assert got.dtype == torch.bool and got.shape == (N,)
        np.testing.assert_array_equal(got.numpy(), _reference(name, sigma, m),
                                      err_msg=f"{name} m={m}")
        np.testing.assert_array_equal(got.numpy(), oracle, err_msg=f"{name} m={m}")


@pytest.mark.parametrize("name", LOOPS)
@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("seg", SEGS)
def test_segmented_loop_equals_reference(name, sigma, seg):
    t, pats = _case(sigma)
    for m in LENGTHS:
        got = P._loop(name, t, pats[m], _seg(seg, m, N), device=CPU)
        np.testing.assert_array_equal(got.numpy(), _reference(name, sigma, m),
                                      err_msg=f"{name} m={m} seg={seg}")


@pytest.mark.parametrize("seg", [1, 5, 32, 800])
def test_shift_or_m32(rng, seg):
    t = rng.randint(0, 4, size=800).astype(np.uint8)
    p = t[100:132].copy()
    want = np.asarray(R.shift_or(t, p))
    np.testing.assert_array_equal(P._loop("shift_or", t, p, seg, device=CPU).numpy(), want)
    np.testing.assert_array_equal(want, P.naive_np(t, p))
    with pytest.raises(ValueError):
        P.shift_or(t, rng.randint(0, 4, size=33).astype(np.uint8), device=CPU)
    with pytest.raises(ValueError):  # the limit is checked before n < m, as the reference does
        P.shift_or(t[:10], rng.randint(0, 4, size=33).astype(np.uint8), device=CPU)


def test_bndm_limit(rng):
    t = rng.randint(0, 4, size=100).astype(np.uint8)
    with pytest.raises(ValueError):
        R.bndm(t, rng.randint(0, 4, size=32).astype(np.uint8))
    with pytest.raises(ValueError):
        P.bndm(t, rng.randint(0, 4, size=32).astype(np.uint8), device=CPU)
    p = t[10:41].copy()  # m = 31, the limit itself
    for seg in (1, 30, 31, 100):
        np.testing.assert_array_equal(P._loop("bndm", t, p, seg, device=CPU).numpy(),
                                      np.asarray(R.bndm(t, p)))


PERIODIC = np.tile(np.array([7, 7, 9], dtype=np.uint8), 100)


@functools.lru_cache(maxsize=None)
def _periodic_reference(name: str, m: int) -> np.ndarray:
    return np.asarray(R.BASELINES[name](PERIODIC, PERIODIC[:m].copy()))


@pytest.mark.parametrize("seg", [1, 2, 3, 4, 64, 300])
def test_periodic_patterns_all_baselines(seg):
    t = PERIODIC
    for name, fn in P.BASELINES.items():
        if name in LOOPS:
            fn = functools.partial(P._loop, name, seg=seg)
        for m in (3, 6, 9):
            p = t[:m].copy()
            want = _periodic_reference(name, m)
            np.testing.assert_array_equal(want, P.naive_np(t, p))
            np.testing.assert_array_equal(fn(t, p, device=CPU).numpy(), want,
                                          err_msg=f"{name} m={m} seg={seg}")


@pytest.mark.parametrize("name", LOOPS)
def test_edges_short_texts_and_narrow_segments(rng, name):
    """n < m, n == m, texts shorter than a segment, one byte, m = 1, and
    segments narrower than the pattern, against the oracle."""
    lim = {"shift_or": 32, "bndm": 31}.get(name, 40)
    for n, m, seg in ((5, 8, 4), (8, 8, 3), (8, 8, 256), (1, 1, 1), (1, 1, 256), (257, 1, 256),
                      (257, 3, 256), (100, lim, 7), (100, lim, 1), (64, 20, 19), (64, 20, 21)):
        t = rng.randint(0, 2, size=n).astype(np.uint8)
        p = t[:m].copy() if m <= n else rng.randint(0, 2, size=m).astype(np.uint8)
        got = P._loop(name, t, p, seg, device=CPU)
        assert got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), P.naive_np(t, p), err_msg=f"n={n} m={m} seg={seg}")


def test_tables_equal_reference(rng):
    for m in (1, 2, 3, 5, 8, 16, 31, 40):
        for p in (rng.randint(0, 4, size=m).astype(np.uint8),
                  np.tile(np.array([7, 7, 9], np.uint8), 14)[:m]):
            np.testing.assert_array_equal(P._kmp_table(p), R._kmp_table(p))
            if m >= 3:
                np.testing.assert_array_equal(P._hash3_tables(p), R._hash3_tables(p))
            if m <= 32:  # the reference builds B inline: bit j set <=> p[j] != c
                want = sum(((p[j] != np.arange(256)).astype(np.uint64) << j) for j in range(m))
                np.testing.assert_array_equal(P._so_table(p), want.astype(np.uint32))
            if m <= 31:
                want = np.zeros(256, np.uint32)
                for j in range(m):
                    want[p[j]] |= np.uint32(1) << np.uint32(m - 1 - j)
                np.testing.assert_array_equal(P._bndm_table(p), want)
    assert P._kmp_table(p).dtype == np.int32 and P._hash3_tables(p).dtype == np.int32


@pytest.mark.parametrize("m", [5, 40])
def test_rabin_karp_wraparound(rng, m):
    """sigma = 256 and long m: the rolling hash wraps mod 2^32 many times
    (base^39 alone is ~2^777)."""
    t = rng.randint(0, 256, size=2000).astype(np.uint8)
    t[700 : 700 + m] = t[50 : 50 + m]
    p = t[50 : 50 + m].copy()
    want = np.asarray(R.rabin_karp(t, p))
    assert want[50] and want[700]
    np.testing.assert_array_equal(P.rabin_karp(t, p, device=CPU).numpy(), want)
    if m == 5:
        np.testing.assert_array_equal(P.rabin_karp(t, p, base=7, device=CPU).numpy(),
                                      np.asarray(R.rabin_karp(t, p, base=7)))


def test_cpu_tensor_dispatches_to_the_plain_version(rng, monkeypatch):
    t = torch.from_numpy(rng.randint(0, 4, size=300).astype(np.uint8))
    p = t[40:48].clone()
    calls = []
    for name in LOOPS:
        plain = getattr(ref, f"{name}_ref")
        monkeypatch.setattr(ops, f"{name}_ref",
                            lambda *a, _f=plain, _n=name: calls.append(_n) or _f(*a))
    before = {name: getattr(K, f"{name}_cuda").launches for name in LOOPS}
    for name in LOOPS:
        got = P.BASELINES[name](t, p)  # a CPU tensor stays on the CPU
        np.testing.assert_array_equal(got.numpy(), P.naive_np(t, p))
    assert calls == list(LOOPS)
    assert {name: getattr(K, f"{name}_cuda").launches for name in LOOPS} == before
    # the kernel wrappers take CUDA tensors only, and count no launch otherwise
    table = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.shift_or_cuda(t, p, table, 64)
    assert K.shift_or_cuda.launches == before["shift_or"]


def test_no_card_means_no_silent_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, fn in P.BASELINES.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(b"abcab", b"abc")
        assert fn(b"abcab", b"abc", device="cpu").tolist() == [True, False, False, False, False]


def test_naive_np_takes_bytes_numpy_and_tensors():
    want = np.array([True, False, False, True, False])
    for text in (b"abcab", "abcab", np.frombuffer(b"abcab", np.uint8),
                 torch.tensor(list(b"abcab"), dtype=torch.uint8)):
        got = P.naive_np(text, b"ab")
        assert isinstance(got, np.ndarray) and got.dtype == bool
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", LOOPS)
def test_lane_steps_count_the_loops_work(rng, name):
    """The scans read seg + m - 1 bytes a segment (clamped at the text's
    start and end); a HASH3 lane advances at least one position a step
    inside its own range, a BNDM lane reads at most m bytes a window it
    owns; every lane that owns a position takes a step."""
    t = torch.from_numpy(rng.randint(0, 4, size=1000).astype(np.uint8))
    p = t[100:108].clone()
    steps = ref.lane_steps(name, t, p, P.loop_table(name, p, CPU), 64)
    assert steps.shape == (16,) and bool((steps >= 1).all())
    if name in ("shift_or", "kmp_dfa"):
        assert steps.tolist() == [64] + [71] * 14 + [1000 - 960 + 7]
    elif name == "hash3":
        assert int(steps[0]) <= 64 - 7 and bool((steps <= 64).all())
    else:
        assert bool((steps <= 64 * 8).all())


def test_kernel_is_registered_with_the_build():
    from repro_torch.kernels import _build

    assert "baselines" in _build.KERNELS
    src = (_build.CSRC / "baselines.cu").read_text()
    assert "torch/" not in src  # a plain C interface, no PyTorch headers
    enum = {"shift_or": "SHIFT_OR", "kmp_dfa": "KMP", "hash3": "HASH3", "bndm": "BNDM"}
    for name, algo in K._ALGO.items():
        assert f"{enum[name]} = {algo}" in src
