"""Elastic restore and the mesh launcher of repro_torch, held against repro
on the CPU.

Elastic restore (tests/test_elastic.py's case): a checkpoint written by one
process restores onto four gloo ranks of a (2, 2) ("data", "model") mesh
with the reference test's specs, ("data", "model"), ("data", None) and ();
every rank's local shard equals its slice of the saved array bit for bit
(a restore copies).  The same holds for a checkpoint that
``repro.train.checkpoint.save`` wrote (a bfloat16 leaf among its leaves),
and for a reduced LM's parameters and AdamW state placed by
``lm_param_specs`` (tp_sp: the "model" axis of two ranks shards the
projections): the slice each rank holds is the one the reference's spec
names.  The four ranks then save the restored DTensors: rank 0 writes the
whole tensors, equal to the first checkpoint, and no ``.tmp_*`` remains.

The launcher (launch.train) on two gloo ranks, ``--reduced --steps 3
--batch 4 --seq 64 --device cpu``, against its one-rank run: smollm-135m
and phi3.5-moe (two whole MoE groups a rank), tp_sp, and smollm-135m under
zero_dp (parameters and moments sharded over "data"; ``make_step``'s
strategy, set by the child, since the launcher runs tp_sp): every step's loss
and every final parameter within LAUNCH_TOL of the leaf's max (float32;
the two-rank gradient is a mean of two row-halves, summed in another
order).  The two-rank run's checkpoint (rank 0 writes) resumes on one rank.
"""

import json
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import reduced_config as ref_reduced_config
from repro.dist import sharding as RS
from repro.train import checkpoint as RC
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init
from torch_ranks import run_ranks

LAUNCH_TOL = 1e-5
MESH = (2, 2)

RESTORE_CHILD = r"""
import json, sys
import numpy as np, torch
from repro_torch.configs import reduced_config
from repro_torch.dist import compat
from repro_torch.dist import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init

d = sys.argv[1]
rank, world = compat.init_process_group("cpu")
mesh = compat.make_mesh((2, 2), ("data", "model"), device="cpu")
P = compat.P
NS = lambda spec: sh.NamedSharding(mesh, spec)
keep = {}


def record(prefix, tree):
    for path, leaf in ckpt._flatten(tree):
        for i, x in enumerate(leaf if isinstance(leaf, list) else [leaf]):
            keep[f"{prefix}/{ckpt._name(path)}/{i}"] = x.to_local().float().numpy()


like = {"w": torch.zeros(64, 16), "opt": {"m": torch.zeros(64, 16),
                                         "step": torch.zeros((), dtype=torch.int32)}}
shs = {"w": NS(P("data", "model")), "opt": {"m": NS(P("data", None)), "step": NS(P())}}
got, step = ckpt.restore(like, f"{d}/port", shardings=shs)
assert step == 7
record("port", got)
like["e"] = torch.zeros(8, 16, dtype=torch.bfloat16)
shs["e"] = NS(P("model", None))
got, step = ckpt.restore(like, f"{d}/reference", shardings=shs)
assert step == 7 and got["e"].dtype == torch.bfloat16
record("reference", got)
cfg = reduced_config("smollm-135m")
pspecs = sh.lm_param_specs(cfg, mesh)
shapes = T.param_shapes(cfg)
lm_like = (shapes, adamw_init(shapes))
lm_sh = (sh.tree_to_shardings(mesh, pspecs), sh.tree_to_shardings(mesh, sh.opt_state_specs(pspecs)))
got, step = ckpt.restore(lm_like, f"{d}/lm", shardings=lm_sh)
record("lm", got)
ckpt.save(got, f"{d}/resaved", step)
np.savez(f"{d}/rank{rank}.npz", **keep)
print(json.dumps({"data": mesh.get_local_rank("data"), "model": mesh.get_local_rank("model")}))
torch.distributed.destroy_process_group()
"""


def _stub(shape, names):
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))


def _expected(arr: np.ndarray, spec, coord: dict) -> np.ndarray:
    """arr's block that the rank at ``coord`` holds under a reference spec."""
    sl = []
    for dim, entry in zip(arr.shape, tuple(spec) + (None,) * (arr.ndim - len(spec))):
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        k, i = 1, 0
        for a in names:
            k, i = k * MESH[("data", "model").index(a)], i * MESH[("data", "model").index(a)] + coord[a]
        sl.append(slice(i * dim // k, (i + 1) * dim // k))
    return arr[tuple(sl)]


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    w = np.arange(64.0 * 16, dtype=np.float32).reshape(64, 16)
    ckpt.save({"w": torch.from_numpy(w), "opt": {"m": torch.ones(64, 16),
               "step": torch.tensor(7, dtype=torch.int32)}}, d / "port", 7)
    e = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    RC.save({"w": jnp.asarray(w), "e": jnp.asarray(e).astype(jnp.bfloat16),
             "opt": {"m": jnp.ones((64, 16)), "step": jnp.int32(7)}}, d / "reference", 7)
    cfg = reduced_config("smollm-135m")
    params = T.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    state = adamw_init(params)
    state = state._replace(m=type(params)(params), step=torch.tensor(5, dtype=torch.int32))
    ckpt.save((params, state), d / "lm", 5)
    outs = run_ranks(RESTORE_CHILD, 4, d, timeout=120)
    coords = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    return d, coords, [np.load(d / f"rank{r}.npz") for r in range(4)]


def _saved(d, step: int) -> dict:
    man = json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())
    out = {}
    for m in man["leaves"]:
        a = np.load(d / f"step_{step:08d}" / m["file"])
        if m["dtype"] == "bfloat16":
            a = (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        out[m["name"]] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("which", ["port", "reference"])
def test_restore_onto_four_ranks_gives_each_its_slice(restored, which):
    d, coords, got = restored
    saved = _saved(d / which, 7)
    specs = {"w": ("data", "model"), "opt__m": ("data", None), "opt__step": (), "e": ("model", None)}
    for coord, g in zip(coords, got):
        for name, spec in specs.items():
            if name in saved:
                np.testing.assert_array_equal(g[f"{which}/{name}/0"],
                                              _expected(saved[name], spec, coord))
    assert not list((d / which).glob(".tmp_*"))


def test_lm_state_restores_by_the_reference_specs(restored):
    d, coords, got = restored
    saved = _saved(d / "lm", 5)
    cfg = ref_reduced_config("smollm-135m")
    pspecs = RS.lm_param_specs(cfg, _stub(MESH, ("data", "model")))
    items, _ = RC._flatten((pspecs, RS.opt_state_specs(pspecs)))
    # the reference's specs of a tuple of trees flatten like the state
    specs = {n: s for n, s in items}
    assert set(specs) == set(saved)
    checked = 0
    for coord, g in zip(coords, got):
        for name, arr in saved.items():
            spec = specs[name]
            if "layers" in name.split("__"):
                for i in range(arr.shape[0]):  # the port's per-layer tensors
                    np.testing.assert_array_equal(g[f"lm/{name}/{i}"],
                                                  _expected(arr, spec, coord)[i])
            else:
                np.testing.assert_array_equal(g[f"lm/{name}/0"], _expected(arr, spec, coord))
            checked += 1
    assert checked == 4 * len(saved)


def test_sharded_save_writes_whole_tensors_from_rank_0(restored):
    d, _, _ = restored
    assert _saved(d / "resaved", 5).keys() == _saved(d / "lm", 5).keys()
    for name, arr in _saved(d / "resaved", 5).items():
        np.testing.assert_array_equal(arr, _saved(d / "lm", 5)[name])
    assert not list((d / "resaved").glob(".tmp_*"))


LAUNCH_CHILD = r"""
import sys
import numpy as np, torch
from repro_torch.launch import train as lt
from repro_torch.train import checkpoint as ckpt

out_dir, tag, *argv = sys.argv[1:]
losses = []
make_step = lt.make_step


def recording(*a, **kw):
    # the launcher trains under tp_sp; a "zero" tag drives make_step's
    # zero_dp through the same launcher
    step, pspecs = make_step(*a, **kw, strategy="zero_dp" if tag.startswith("zero") else "tp_sp")

    def run(p, o, b):
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
        return p, o, m

    return run, pspecs


lt.make_step = recording
rank = int(__import__("os").environ["RANK"])
params, _ = lt.main(["--device", "cpu", "--reduced", "--steps", "3", "--batch", "4", "--seq", "64",
                     *argv])
np.savez(f"{out_dir}/{tag}_rank{rank}.npz", losses=np.asarray(losses),
         **{ckpt._name(p): (torch.stack(l) if isinstance(l, list) else l).numpy()
            for p, l in ckpt._flatten(params)})
"""

LAUNCHES = {  # tag -> (ranks, launcher arguments)
    "smollm_1": (1, ["--arch", "smollm-135m"]),
    "smollm_2": (2, ["--arch", "smollm-135m", "--ckpt-dir", "{d}/ck2", "--ckpt-every", "3"]),
    "moe_1": (1, ["--arch", "phi3.5-moe-42b-a6.6b"]),
    "moe_2": (2, ["--arch", "phi3.5-moe-42b-a6.6b"]),
    "zero_2": (2, ["--arch", "smollm-135m"]),
}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")

    def one(tag):
        ranks, argv = LAUNCHES[tag]
        return run_ranks(LAUNCH_CHILD, ranks, d, tag, *[a.format(d=d) for a in argv], timeout=180)

    with ThreadPoolExecutor(len(LAUNCHES)) as pool:
        outs = dict(zip(LAUNCHES, pool.map(one, LAUNCHES)))
    return d, outs


def _close(got, want):
    for k in want.files:
        err = np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30)
        assert err <= LAUNCH_TOL, (k, err)


@pytest.mark.parametrize("one,two", [("smollm_1", "smollm_2"), ("moe_1", "moe_2"),
                                     ("smollm_1", "zero_2")])
def test_two_ranks_match_one_rank(launched, one, two):
    d, outs = launched
    want = np.load(d / f"{one}_rank0.npz")
    assert len(want["losses"]) == 3
    for rank in range(2):
        _close(np.load(d / f"{two}_rank{rank}.npz"), want)
    assert "mesh: {'data': 2, 'model': 1} on cpu" in outs[two][0]
    assert "mesh: {'data': 1, 'model': 1} on cpu" in outs[one][0]


def test_two_rank_checkpoint_resumes_on_one_rank(launched, tmp_path):
    d, _ = launched
    assert ckpt.latest_step(d / "ck2") == 3 and not list((d / "ck2").glob(".tmp_*"))
    want = np.load(d / "smollm_1_rank0.npz")
    saved = _saved(d / "ck2", 3)
    for k in want.files:
        if k != "losses":
            err = np.abs(saved[f"0__{k}"] - want[k]).max() / np.abs(want[k]).max()
            assert err <= LAUNCH_TOL, (k, err)
    out = run_ranks(LAUNCH_CHILD, 1, tmp_path, "resume", "--ckpt-dir", d / "ck2", timeout=120)
    assert "resumed from step 3" in out[0]


@pytest.mark.parametrize("arch,dtype", [("smollm-135m", "float32"), ("smollm-135m", "bfloat16"),
                                        ("phi3.5-moe-42b-a6.6b", "float32")])
def test_one_rank_mesh_step_equals_make_train_step(arch, dtype):
    """The launcher's step on a (1, 1) mesh and train.loop.make_train_step,
    from the same parameters and batches: bit-equal losses, parameters and
    moments over two steps (the all-reduce of one rank is the identity)."""
    import dataclasses

    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as lt
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.loop import make_train_step, whole
    from repro_torch.train.optimizer import AdamWConfig
    from torch_ranks import one_rank_group

    cfg = dataclasses.replace(reduced_config(arch), dtype=dtype, param_dtype=dtype, q_chunk=64,
                              kv_chunk=64, ce_chunk=64)
    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=1, total_steps=2)
    rng = np.random.RandomState(5)
    batches = [{k: torch.from_numpy(rng.randint(0, cfg.vocab, (4, 64)).astype(np.int32))
                for k in ("tokens", "targets")} for _ in range(2)]
    with one_rank_group():
        mesh = lmesh.make_local_mesh(device="cpu")
        step, pspecs = lt.make_step(cfg, mesh, 4, 64, opt_cfg)
        params, state = lt.init_state(cfg, mesh, pspecs, torch.device("cpu"))
        p1, s1 = tree_map(whole, params), type(state)(*tree_map(whole, tuple(state)))
        plain = make_train_step(lambda p, b: T.train_loss(p, cfg, b), opt_cfg)
        for b in batches:
            params, state, m = step(params, state, b)
            p1, s1, m1 = plain(p1, s1, b)
            assert torch.equal(m["loss"], m1["loss"])
            assert torch.equal(m["grad_norm"], m1["grad_norm"])
        for got, want in zip(tree_leaves((params, state.m, state.v)), tree_leaves((p1, s1.m, s1.v))):
            assert got.to_local().dtype == want.dtype and torch.equal(got.to_local(), want)
        assert sh.axis_size(mesh, "data") == 1
