"""find / count / positions of repro_torch.core.epsm against repro.core.epsm.

The port runs on the CPU here (``device="cpu"``), through each kernel's plain
PyTorch version.  The reference runs through ``find_jit``; ``auto`` and
``tuned`` resolve through the reference's own ``select_algo`` /
``select_algo_tuned`` exactly as its ``find`` does, so each (shape, regime)
compiles once.  Masks, counts and positions must be bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import epsm as R
from repro_torch.core import epsm as P

ALGOS = ["auto", "tuned", "epsma", "epsmb", "epsmc"]
LENGTHS = [1, 3, 4, 15, 16, 17, 32, 300]
SIGMAS = [2, 4, 256]


def _text(n, sigma, seed):
    return np.random.RandomState(seed).randint(0, sigma, size=n).astype(np.uint8)


def _ref_mask(t, p, algo="auto"):
    m = len(p)
    name = {"auto": R.select_algo(m), "tuned": R.select_algo_tuned(m)}.get(algo, algo)
    return np.asarray(R.find_jit(jnp.asarray(t), jnp.asarray(p), algo=name))


def _check(t, p, algo="auto"):
    want = _ref_mask(t, p, algo)
    got = P.find(t, p, algo=algo, device="cpu")
    assert got.dtype == torch.bool and got.device.type == "cpu" and got.shape == (len(t),)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(P.count(t, p, algo=algo, device="cpu")) == int(want.sum())
    pos = P.positions(t, p, algo=algo, device="cpu")
    assert pos.dtype == np.int64
    np.testing.assert_array_equal(pos, np.nonzero(want)[0])
    return got


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("m", LENGTHS)
@pytest.mark.parametrize("algo", ALGOS)
def test_find_matches_reference(algo, m, sigma):
    t = _text(4097, sigma, seed=m * 7 + sigma)
    s = np.random.RandomState(m).randint(0, len(t) - m + 1)
    _check(t, t[s : s + m].copy(), algo)


def _size_cases():
    # n in {0, m - 1, m, 4095, 12289} (4097 is in the test above).  m = 300 is
    # held at n < m here: each reference shape of it compiles for ~8 s.
    for m in LENGTHS:
        for n in (0, m - 1, m, 4095, 12289):
            if m < 300 or n < m:
                yield m, n


@pytest.mark.parametrize("m,n", sorted(set(_size_cases())))
def test_find_sizes_match_reference(m, n):
    t = _text(n, 4, seed=n + m)
    p = t[:m].copy() if n >= m else _text(m, 4, seed=m)
    _check(t, p)


@pytest.mark.parametrize("m", [1, 4, 16, 32])
def test_flood(m):
    # every start matches; every EPSMc block is a candidate
    t = np.full(4097, ord("A"), dtype=np.uint8)
    got = _check(t, t[:m].copy())
    assert int(got.sum()) == 4097 - m + 1


@pytest.mark.parametrize("m", [3, 4, 17])
def test_pattern_ending_in_zero_bytes(m):
    t = _text(4097, 256, seed=m) | 1  # no zero byte inside the text
    t[-1] = 0
    p = t[-m:].copy()
    assert _check(t, p)[-m]  # the occurrence at the very end
    # one byte shorter: only the zero padding past n would complete p there
    assert not _check(t[:4095].copy(), p).any()


def test_str_with_non_ascii():
    text = "grüße — größer grüße \udcff"
    for pat in ["grüße", "ß", "e \udcff"]:
        want = np.asarray(R.find(text, pat))
        np.testing.assert_array_equal(P.find(text, pat, device="cpu").numpy(), want)


def test_readme_quickstart():
    from repro_torch.core import epsm

    text = b"the quick brown fox jumps over the lazy dog"
    assert list(epsm.positions(text, b"quick", device="cpu")) == [4]
    assert int(epsm.count(text, b"o", device="cpu")) == 4
    assert list(epsm.positions(text, b"quick", device="cpu")) == list(R.positions(text, b"quick"))
    assert int(epsm.count(text, b"o", device="cpu")) == int(R.count(text, b"o"))


@pytest.mark.parametrize("m", [2, 8])
def test_count_positions_match_reference_functions(m):
    t = _text(1000, 4, seed=m)
    p = t[100 : 100 + m].copy()
    got, want = P.count(t, p, device="cpu"), R.count(t, p)
    # a 0-d int32 count, as the reference returns
    assert got.dtype == torch.int32 and got.ndim == 0 and np.asarray(want).dtype == np.int32
    assert int(got) == int(want)
    np.testing.assert_array_equal(P.positions(t, p, device="cpu"), R.positions(t, p))


def test_errors_and_deferred_paths(monkeypatch):
    """Errors raise in both packages; the once-deferred paths (k > 0,
    stream=True, the auto-stream of host texts) give the reference's
    answers."""
    t = _text(100, 4, seed=0)
    for mod in (R, P):
        kw = {"device": "cpu"} if mod is P else {}
        with pytest.raises(ValueError, match="empty pattern"):
            mod.find(t, b"", **kw)
        with pytest.raises(ValueError, match="unknown algo"):
            mod.find(t, b"ab", algo="kmp", **kw)
    np.testing.assert_array_equal(P.find(t, b"ab", k=1, device="cpu").numpy(),
                                  np.asarray(R.find(t, b"ab", k=1)))
    np.testing.assert_array_equal(P.find(t, b"\x01\x02", stream=True, device="cpu"),
                                  np.asarray(R.find(t, b"\x01\x02", stream=True)))
    assert int(P.count(t, b"\x01\x02", stream=True, device="cpu")) == int(
        R.count(t, b"\x01\x02", stream=True))
    monkeypatch.setattr(P, "STREAM_AUTO_BYTES", 64)
    auto = P.find(t.tobytes(), b"\x00", device="cpu")  # the reference would auto-stream here
    assert isinstance(auto, np.ndarray)
    np.testing.assert_array_equal(auto, np.asarray(R.find(t, b"\x00")))
    # an explicit algo, or a tensor, never auto-streams
    big = bytes(128)
    assert int(P.count(big[:-1] + b"\x01", b"\x01", algo="epsma", device="cpu")) == 1
    tensor = torch.zeros(128, dtype=torch.uint8)
    assert int(P.count(tensor, b"\x00\x00\x00\x00\x00", device="cpu")) == 128 - 4


def test_constants_and_dispatch_match_reference():
    for name in ("EPSMA_MAX", "EPSMB_MAX", "EPSMC_BETA", "EPSMC_KBITS", "TUNED_EPSMC_MIN",
                 "STREAM_AUTO_BYTES"):
        assert getattr(P, name) == getattr(R, name), name
    for m in range(1, 70):
        assert P.select_algo(m) == R.select_algo(m)
        assert P.select_algo_tuned(m) == R.select_algo_tuned(m)
        if m >= 2 * R.EPSMC_BETA:
            assert P._epsmc_stride(m, R.EPSMC_BETA) == R._epsmc_stride(m, R.EPSMC_BETA)
