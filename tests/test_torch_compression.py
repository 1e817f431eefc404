"""repro_torch.dist.compression against repro.dist.compression on the CPU.

int8 quantized psum with error feedback: one shared per-tensor grid (pmax
of the local amax), round half to even, an exact int32 sum, one
dequantization.  So the port's results equal the reference's bit for bit
(no tolerance) at one rank, in this process against the reference's own
setup (tests/test_substrate.py::test_gradient_compression_accuracy), and at
four gloo ranks against the reference on four fake XLA devices in a
subprocess, over two error-feedback steps; the port alone over 5.  The reference's bounds are held
too: max error under 1e-2 of the leaf's max after one step, and
residual + output equal to the input within 1e-6 (one rank).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as RP

from repro.dist.compat import make_mesh as ref_make_mesh
from repro.dist.compat import shard_map as ref_shard_map
from repro.dist.compression import quantized_psum as ref_quantized_psum
from repro.dist.compression import zeros_residuals as ref_zeros_residuals
from repro_torch.dist import compat
from repro_torch.dist.compression import quantized_psum, zeros_residuals
from torch_ranks import one_rank_group, run_ranks, run_reference

RANKS = 4
# error-feedback steps: the port alone, and against the reference (whose
# shard_map runs eagerly, as its own test runs it, ~1.3 s a leaf a step;
# jitted, XLA fuses x - q * scale and the residual moves by an ulp)
STEPS = 5
REF_STEPS = 2


def _grads(seed: int) -> dict:
    """float32 leaves of several magnitudes and one bfloat16 leaf, as float32
    numpy (the bfloat16 leaf rounded to bfloat16 values)."""
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(128, 8).astype(np.float32),
            "b": (rng.randn(64) * 1e-3).astype(np.float32),
            "e": rng.randn(32, 16).astype(np.float32)}


BF16 = ("e",)


def _port_tree(g: dict) -> dict:
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k in BF16 else torch.float32)
            for k, v in g.items()}


def _ref_tree(g: dict) -> dict:
    return {k: jnp.asarray(v).astype(jnp.bfloat16 if k in BF16 else jnp.float32)
            for k, v in g.items()}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.fixture(scope="module")
def one_rank():
    with one_rank_group():
        yield compat.make_mesh((1,), ("data",), device="cpu")


def _port_steps(mesh, g: dict, steps: int):
    run = compat.shard_map(lambda g, r: quantized_psum(g, r, "data"), mesh=mesh,
                           in_specs=(compat.P(), compat.P()), out_specs=(compat.P(), compat.P()))
    res, outs = zeros_residuals(g), []
    for _ in range(steps):
        out, res = run(g, res)
        out = {k: v.to_local() for k, v in out.items()}
        res = {k: v.to_local() for k, v in res.items()}
        outs.append((out, res))
    return outs


def _ref_steps(g: dict, steps: int):
    mesh = ref_make_mesh((1,), ("data",))
    run = ref_shard_map(lambda g, r: ref_quantized_psum(g, r, "data"), mesh=mesh,
                        in_specs=(RP(), RP()), out_specs=(RP(), RP()), check_vma=False)
    res, outs = ref_zeros_residuals(g), []
    for _ in range(steps):
        out, res = run(g, res)
        outs.append((out, res))
    return outs


def test_one_rank_equals_reference_bit_for_bit(one_rank):
    g = _grads(0)
    got = _port_steps(one_rank, _port_tree(g), REF_STEPS)
    want = _ref_steps(_ref_tree(g), REF_STEPS)
    for (go, gr), (wo, wr) in zip(got, want):
        for k in g:
            assert go[k].dtype == (torch.bfloat16 if k in BF16 else torch.float32)
            np.testing.assert_array_equal(_f32(go[k]), _f32(wo[k]))
            np.testing.assert_array_equal(gr[k].numpy(), np.asarray(wr[k]))


def test_one_step_bounds_of_the_reference(one_rank):
    """The reference test's own bounds, on its own input."""
    g = {"w": torch.from_numpy(np.random.RandomState(0).randn(128, 8).astype(np.float32))}
    (out, res), = _port_steps(one_rank, g, 1)
    w = g["w"].numpy()
    assert np.abs(out["w"].numpy() - w).max() / np.abs(w).max() < 1e-2
    np.testing.assert_allclose(out["w"].numpy() + res["w"].numpy(), w, rtol=0, atol=1e-6)


def test_error_feedback_bounds_the_bias_over_steps(one_rank):
    """Fed the same gradient 5 times, the outputs sum to 5 g less the last
    residual: the bias stays within half a quantization step while one
    step's error, repeated, would grow 5-fold."""
    g = {"w": torch.from_numpy(np.random.RandomState(3).randn(256, 4).astype(np.float32))}
    outs = _port_steps(one_rank, g, STEPS)
    w = g["w"].numpy()
    total = sum(o["w"].numpy().astype(np.float64) for o, _ in outs)
    scale = np.abs(w).max() / 127.0
    np.testing.assert_allclose(total, STEPS * w.astype(np.float64) - outs[-1][1]["w"].numpy(),
                               rtol=0, atol=1e-5)
    assert np.abs(total - STEPS * w).max() <= scale / 2 * (1 + 1e-5)
    assert np.abs(outs[0][0]["w"].numpy() - w).max() * STEPS > scale / 2


RANK_CHILD = r"""
import sys
import numpy as np, torch
from repro_torch.dist import compat
from repro_torch.dist.compression import quantized_psum, zeros_residuals

out_dir, steps = sys.argv[1], int(sys.argv[2])
rank, world = compat.init_process_group("cpu")
mesh = compat.make_mesh((world,), ("data",), device="cpu")
rng = np.random.RandomState(100 + rank)
g = {"w": torch.from_numpy(rng.randn(128, 8).astype(np.float32)),
     "e": torch.from_numpy(rng.randn(32, 16).astype(np.float32)).to(torch.bfloat16)}
run = compat.shard_map(lambda g, r: quantized_psum(g, r, "data"), mesh=mesh,
                       in_specs=(compat.P(), compat.P()), out_specs=(compat.P(), compat.P()))
res, keep = zeros_residuals(g), {}
for t in range(steps):
    out, res = run(g, res)
    res = {k: v.to_local() for k, v in res.items()}
    for k, v in out.items():
        keep[f"out{t}_{k}"] = v.to_local().float().numpy()
        keep[f"res{t}_{k}"] = res[k].numpy()
np.savez(f"{out_dir}/rank{rank}.npz", **keep)
torch.distributed.destroy_process_group()
"""

REF_PROBE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist.compat import make_mesh, shard_map
from repro.dist.compression import quantized_psum, zeros_residuals

out_dir, ranks, steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
mesh = make_mesh((ranks,), ("data",))
ws, es = [], []
for rank in range(ranks):
    rng = np.random.RandomState(100 + rank)
    ws.append(rng.randn(128, 8).astype(np.float32))
    es.append(rng.randn(32, 16).astype(np.float32))
g = {"w": jnp.asarray(np.concatenate(ws)),
     "e": jnp.asarray(np.concatenate(es)).astype(jnp.bfloat16)}
run = shard_map(lambda g, r: quantized_psum(g, r, "data"), mesh=mesh,
                in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")),
                check_vma=False)
res, keep = zeros_residuals(g), {}
for t in range(steps):
    out, res = run(g, res)
    for k in out:
        keep[f"out{t}_{k}"] = np.asarray(out[k].astype(jnp.float32))
        keep[f"res{t}_{k}"] = np.asarray(res[k])
np.savez(f"{out_dir}/reference.npz", **keep)
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("compression")
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(run_ranks, RANK_CHILD, RANKS, d, REF_STEPS)
        run_reference(REF_PROBE, RANKS, d, RANKS, REF_STEPS)
        ranks.result()
    ref = np.load(d / "reference.npz")
    return [np.load(d / f"rank{r}.npz") for r in range(RANKS)], ref


@pytest.mark.parametrize("leaf", ["w", "e"])
@pytest.mark.parametrize("step", range(REF_STEPS))
def test_four_ranks_equal_reference_bit_for_bit(four_ranks, leaf, step):
    ranks, ref = four_ranks
    for r, got in enumerate(ranks):
        for what in ("out", "res"):
            want = ref[f"{what}{step}_{leaf}"]
            rows = len(want) // RANKS
            np.testing.assert_array_equal(got[f"{what}{step}_{leaf}"],
                                          want[r * rows:(r + 1) * rows])
