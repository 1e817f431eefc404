"""Each repro_torch kernel op on a CPU tensor (that is, its plain PyTorch
version) against the reference's Pallas op in interpret mode.

Mirrors tests/test_kernels.py: the same sizes, alphabets and pattern lengths,
the small-tile boundary cases, the EPSMc apron case and fuse_verify=False.
The CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py.  No tolerance: masks are compared exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.epsma import epsma as pallas_epsma
from repro.kernels.epsma import epsma_ref as jax_epsma_ref
from repro.kernels.epsmb import epsmb as pallas_epsmb
from repro.kernels.epsmb import epsmb_ref as jax_epsmb_ref
from repro.kernels.epsmc import epsmc as pallas_epsmc
from repro.kernels.epsmc import epsmc_ref as jax_epsmc_ref
from repro_torch.kernels.epsma import epsma, epsma_ref
from repro_torch.kernels.epsmb import epsmb, epsmb_ref
from repro_torch.kernels.epsmc import epsmc, epsmc_filter_ref, epsmc_ref

from conftest import extract_pattern, make_text

SIZES = [1, 100, 4095, 4096, 4097, 12289]
SIGMAS = [2, 4, 256]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got: torch.Tensor, want, msg=""):
    assert got.dtype == torch.bool and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("n", SIZES)
def test_epsma_op_sweep(rng, sigma, n):
    t = make_text(rng, n, sigma)
    for m in [1, 2, 3]:
        if m > n:
            continue
        p = extract_pattern(rng, t, m)
        _same(epsma(_t(t), _t(p)), pallas_epsma(t, p), f"n={n} m={m}")


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fuse_verify", [True, False])
def test_epsmb_op_sweep(rng, sigma, n, fuse_verify):
    t = make_text(rng, n, sigma)
    for m in [4, 5, 8, 15]:
        if m > n:
            continue
        p = extract_pattern(rng, t, m)
        got = epsmb(_t(t), _t(p), fuse_verify=fuse_verify)
        _same(got, pallas_epsmb(t, p, fuse_verify=fuse_verify), f"n={n} m={m}")


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("n", [100, 4097, 12289])
def test_epsmc_op_sweep(rng, sigma, n):
    t = make_text(rng, n, sigma)
    for m in [16, 17, 24, 32, 48, 64]:
        if m > n:
            continue
        p = extract_pattern(rng, t, m)
        _same(epsmc(_t(t), _t(p)), pallas_epsmc(t, p), f"n={n} m={m}")


def test_epsma_small_tile(rng):
    t = make_text(rng, 2000, 4)
    p = extract_pattern(rng, t, 3)
    _same(epsma(_t(t), _t(p)), pallas_epsma(t, p, tile=128))


def test_epsmb_small_tile_boundary_matches(rng):
    # occurrences that straddle the reference's tile boundaries
    t = make_text(rng, 1024, 4)
    m = 8
    for s in [120, 127, 128, 250, 255, 256]:
        p = t[s : s + m].copy()
        got = epsmb(_t(t), _t(p))
        assert bool(got[s]), f"missed straddling occurrence at {s}"
        _same(got, pallas_epsmb(t, p, tile=128))


def test_epsmc_apron_matches_previous_tile(rng):
    # matches that START in the reference's previous tile (apron writes)
    t = make_text(rng, 9000, 2)
    p = extract_pattern(rng, t, 20)
    _same(epsmc(_t(t), _t(p)), pallas_epsmc(t, p))


@pytest.mark.parametrize("fuse_verify", [True, False])
@pytest.mark.parametrize("n", [3, 5, 4097])
def test_epsmb_plain_version_matches_reference_ref(rng, n, fuse_verify):
    # with fuse_verify=False the plain version is the anchor-only mask, which
    # the CUDA kernel must reproduce before the op verifies
    t = make_text(rng, n, 4)
    for m in [4, 9]:
        p = make_text(rng, m, 4) if m > n else extract_pattern(rng, t, m)
        got = epsmb_ref(_t(t), _t(p), fuse_verify=fuse_verify)
        _same(got, jax_epsmb_ref(t, p, fuse_verify=fuse_verify), f"n={n} m={m}")


@pytest.mark.parametrize("sigma", [2, 256])
def test_epsma_epsmc_plain_versions_match_reference_refs(rng, sigma):
    t = make_text(rng, 3000, sigma)
    for m in [1, 3, 6]:
        p = extract_pattern(rng, t, m)
        _same(epsma_ref(_t(t), _t(p)), jax_epsma_ref(t, p), f"m={m}")
    for m in [16, 23]:
        p = extract_pattern(rng, t, m)
        dense = epsmc_ref(_t(t), _t(p))
        _same(dense, jax.jit(jax_epsmc_ref)(t, p), f"m={m}")
        # the filter (the op's plain version) against the dense definition
        _same(epsmc_filter_ref(_t(t), _t(p)), dense.numpy(), f"m={m}")


def test_epsmc_plain_version_flood():
    # every inspected block is a candidate and every start matches
    t = np.full(5000, ord("A"), dtype=np.uint8)
    p = t[:32].copy()
    got = epsmc_filter_ref(_t(t), _t(p))
    assert int(got.sum()) == 5000 - 32 + 1
    _same(got, pallas_epsmc(t, p))


def test_op_errors(rng):
    t = _t(make_text(rng, 100, 4))
    with pytest.raises(ValueError):
        epsmb(t, _t(make_text(rng, 3, 4)))
    with pytest.raises(ValueError):
        epsmc(t, _t(make_text(rng, 15, 4)))
    with pytest.raises(ValueError):
        epsma(t, torch.zeros(0, dtype=torch.uint8))
    with pytest.raises(ValueError):
        epsma(t.to(torch.int32), t[:2])
