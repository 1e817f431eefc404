"""repro_torch.dist.sharding's spec tables against repro.dist.sharding's,
entry for entry, and the meshes and placements built on them.

Every arch of the registry, full and reduced (param shapes from meta
tensors on the port's side, ShapeDtypeStructs on the reference's), on the
meshes (1, 1), (2, 4), (16, 16) over ("data", "model") and (2, 16, 16) over
("pod", "data", "model"), under both strategies of its family (LM: tp_sp,
zero_dp; GNN: nodes_sharded, nodes_replicated): the param, AdamW state,
activation and batch specs equal (exact: they are tuples of axis names).
The reference's stacked layer axis maps to the port's per-layer specs
without their leading None.  The reference's tables read only
``mesh.axis_names`` and ``mesh.shape``, so a stub serves them; the port's
run on real ``DeviceMesh``es of one process through PyTorch's fake process
group (backend "fake", 512 ranks, this process rank 37), which also places
meta tensors by the tables on the 16x16 and 2x16x16 meshes: each local
shard's shape is the reference spec's block.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.shapes import pad_to
from repro.dist import sharding as RS
from repro.launch.cells import _rs_batch_sds
from repro.models import gnn as RG
from repro.models import recsys as RR
from repro_torch.configs import ARCH_IDS, get_arch, reduced_config
from repro_torch.dist import compat
from repro_torch.dist import sharding as sh
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWState

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STRATEGIES = {"lm": ("tp_sp", "zero_dp"), "gnn": ("nodes_sharded", "nodes_replicated"),
              "recsys": (None,)}
ME = 37  # this process's rank in the fake group


def test_production_mesh_raises_on_too_few_ranks():
    """Runs before the fake group of the tests below exists."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 256 devices, have 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 devices, have 1"):
        make_production_mesh(multi_pod=True, device="cpu")
    assert not dist.is_initialized()  # raising started no group


@pytest.fixture(scope="module")
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=ME, world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes(fake_group):
    from torch.distributed.device_mesh import DeviceMesh

    out = {}
    for key, (shape, names) in MESHES.items():
        n = math.prod(shape)
        first = 0 if ME < n else ME  # this rank in every mesh
        out[key] = DeviceMesh("cpu", torch.arange(first, first + n).reshape(shape),
                              mesh_dim_names=names)
    return out


def _stub(key):
    shape, names = MESHES[key]
    return types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))


def _same(port, ref, path="", stacked=False):
    """Port spec tree == reference spec tree, entry for entry."""
    if isinstance(port, compat.PartitionSpec):
        want = tuple(ref)
        if stacked and want:
            assert want[0] is None, (path, want)
            want = want[1:]
        assert tuple(port) == want, (path, tuple(port), want)
    elif isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            _same(port[k], ref[k], f"{path}/{k}", stacked)
    elif isinstance(port, list) and path.endswith("/layers") and all(
            isinstance(x, dict) for x in port):
        for x in port:  # each layer against the reference's stacked specs
            _same(x, ref, path, True)
    elif isinstance(port, tuple) and hasattr(port, "_fields"):
        for f in port._fields:
            _same(getattr(port, f), getattr(ref, f), f"{path}.{f}", stacked)
    else:
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, f"{path}/{i}", stacked)


def _cases():
    for arch in ARCH_IDS:
        fam = get_arch(arch).family
        for size in ("full", "reduced"):
            for key in MESHES:
                for strategy in STRATEGIES[fam]:
                    yield pytest.param(arch, fam, size, key, strategy,
                                       id=f"{arch}-{size}-{key}-{strategy or 'tables'}")


def _meta(sds_tree):
    return jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), sds_tree)


def _lm_case(arch, size, port_mesh, ref_mesh, strategy):
    cfg = reduced_config(arch) if size == "reduced" else get_arch(arch).make_config()
    rcfg = ref_reduced_config(arch) if size == "reduced" else ref_get_arch(arch).make_config()
    ps, rs = sh.lm_param_specs(cfg, port_mesh, strategy), RS.lm_param_specs(rcfg, ref_mesh,
                                                                            strategy)
    _same(ps, rs, "params")
    _same(sh.opt_state_specs(ps), RS.opt_state_specs(rs), "opt")
    assert isinstance(sh.opt_state_specs(ps), AdamWState)
    for cell in get_arch(arch).shapes.values():
        B = cell.meta["batch"]
        _same(sh.lm_activation_table(cfg, port_mesh, cell.kind, B, strategy),
              RS.lm_activation_table(rcfg, ref_mesh, cell.kind, B, strategy), cell.shape_id)
        for kind in ("lm_train", "lm_prefill", "lm_decode"):
            _same(sh.lm_batch_specs(kind, port_mesh, B, strategy),
                  RS.lm_batch_specs(kind, ref_mesh, B, strategy), f"{cell.shape_id}/{kind}")


def _gnn_batch_sds(meta, kind, ndev):
    SDS = jax.ShapeDtypeStruct
    if kind == "gnn_batched":
        N = pad_to(meta["n_graphs"] * meta["nodes_per_graph"], ndev)
        E = pad_to(meta["n_graphs"] * meta["edges_per_graph"], ndev)
        return {"nodes": SDS((N, meta["d_feat"]), jnp.float32), "edges": SDS((2, E), jnp.int32),
                "edge_feats": SDS((E, meta["d_edge_feat"]), jnp.float32),
                "graph_ids": SDS((N,), jnp.int32),
                "graph_targets": SDS((meta["n_graphs"],), jnp.float32)}
    N, E = ((meta["sub_nodes"], meta["sub_edges"]) if kind == "gnn_sampled"
            else (meta["n_nodes"], meta["n_edges"]))
    N, E = pad_to(N, ndev), pad_to(E, ndev)
    return {"nodes": SDS((N, meta["d_feat"]), jnp.float32), "edges": SDS((2, E), jnp.int32),
            "labels": SDS((N,), jnp.int32), "label_mask": SDS((N,), jnp.float32)}


def _gnn_case(size, port_mesh, ref_mesh, strategy):
    spec = get_arch("gatedgcn")
    ndev = sh.axis_size(port_mesh, sh.all_axes(port_mesh))
    for shape_id, cell in spec.shapes.items():
        cfg = reduced_config("gatedgcn") if size == "reduced" else spec.make_config(shape_id)
        rcfg = (ref_reduced_config("gatedgcn") if size == "reduced"
                else ref_get_arch("gatedgcn").make_config(shape_id))
        _same(sh.gnn_param_specs(G.param_shapes(cfg)), RS.gnn_param_specs(RG.param_shapes(rcfg)),
              f"{shape_id}/params")
        _same(sh.opt_state_specs(sh.gnn_param_specs(G.param_shapes(cfg))),
              RS.opt_state_specs(RS.gnn_param_specs(RG.param_shapes(rcfg))), f"{shape_id}/opt")
        bsds = _gnn_batch_sds(cell.meta, cell.kind, ndev)
        _same(sh.gnn_batch_specs(port_mesh, _meta(bsds)), RS.gnn_batch_specs(ref_mesh, bsds),
              f"{shape_id}/batch")
    _same(sh.gnn_activation_table(port_mesh, strategy), RS.gnn_activation_table(ref_mesh, strategy),
          "activations")


def _recsys_case(arch, size, port_mesh, ref_mesh):
    cfg = reduced_config(arch) if size == "reduced" else get_arch(arch).make_config()
    rcfg = ref_reduced_config(arch) if size == "reduced" else ref_get_arch(arch).make_config()
    ps = sh.recsys_param_specs(cfg, port_mesh, R.param_shapes(cfg))
    rs = RS.recsys_param_specs(rcfg, ref_mesh, RR.param_shapes(rcfg))
    _same(ps, rs, "params")
    _same(sh.opt_state_specs(ps), RS.opt_state_specs(rs), "opt")
    for cell in get_arch(arch).shapes.values():
        for label in (True, False):
            bsds = _rs_batch_sds(rcfg, cell.meta["batch"], with_label=label)
            _same(sh.recsys_batch_specs(port_mesh, _meta(bsds)),
                  RS.recsys_batch_specs(ref_mesh, bsds), f"{cell.shape_id}/batch")


@pytest.mark.parametrize("arch,family,size,mesh,strategy", list(_cases()))
def test_spec_tables_equal_the_reference(meshes, arch, family, size, mesh, strategy):
    port_mesh, ref_mesh = meshes[mesh], _stub(mesh)
    assert sh.all_axes(port_mesh) == RS.all_axes(ref_mesh)
    assert sh.dp_axes(port_mesh) == RS.dp_axes(ref_mesh)
    for axes in ("model", "data", ("pod", "data"), None):
        assert sh.axis_size(port_mesh, axes) == RS.axis_size(ref_mesh, axes)
    if family == "lm":
        _lm_case(arch, size, port_mesh, ref_mesh, strategy)
    elif family == "gnn":
        _gnn_case(size, port_mesh, ref_mesh, strategy)
    else:
        _recsys_case(arch, size, port_mesh, ref_mesh)


def _block(shape, spec, mesh):
    """The local shard shape a reference spec gives on a mesh."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = list(shape)
    for d, entry in enumerate(tuple(spec)):
        for a in compat.entry_axes(entry):
            out[d] //= sizes[a]
    return tuple(out)


def _leaves_with_specs(tree, specs, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree, specs
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves_with_specs(tree[k], specs[k], f"{path}/{k}")
    else:
        for i, (x, s) in enumerate(zip(tree, specs)):
            yield from _leaves_with_specs(x, s, f"{path}/{i}")


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,strategy", [("smollm-135m", "tp_sp"), ("smollm-135m", "zero_dp"),
                                           ("phi3.5-moe-42b-a6.6b", "tp_sp"),
                                           ("phi3.5-moe-42b-a6.6b", "zero_dp"),
                                           ("dcn-v2", None), ("gatedgcn", None)])
def test_local_shards_on_a_fake_production_mesh(meshes, mesh, arch, strategy):
    m = meshes[mesh]
    assert m.get_coordinate() is not None
    fam = get_arch(arch).family
    if fam == "lm":
        cfg = get_arch(arch).make_config()
        shapes, specs = T.param_shapes(cfg), sh.lm_param_specs(cfg, m, strategy)
    elif fam == "recsys":
        cfg = get_arch(arch).make_config()
        shapes = R.param_shapes(cfg)
        specs = sh.recsys_param_specs(cfg, m, shapes)
    else:
        shapes = G.param_shapes(get_arch(arch).make_config("full_graph_sm"))
        specs = sh.gnn_param_specs(shapes)
    placed = sh.distribute_tree(shapes, m, specs)
    shardings = sh.tree_to_shardings(m, specs)
    n_sharded = 0
    for (path, t, spec), (_, d, _), (_, _, ns) in zip(
            _leaves_with_specs(shapes, specs), _leaves_with_specs(placed, specs),
            _leaves_with_specs(shapes, shardings)):
        assert d.shape == t.shape and d.placements == ns.placements == compat.placements_of(m, spec)
        assert tuple(d.to_local().shape) == _block(t.shape, spec, m), path
        n_sharded += tuple(d.to_local().shape) != tuple(t.shape)
    assert n_sharded > 0 or fam == "gnn"


def test_placements_follow_mesh_order(meshes):
    from torch.distributed.tensor import Replicate, Shard

    m = meshes["2x16x16"]
    assert compat.placements_of(m, compat.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert compat.placements_of(m, compat.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        compat.placements_of(m, compat.P(("data", "pod")))
    with pytest.raises(ValueError, match="no mesh axis"):
        compat.placements_of(meshes["1x1"], compat.P("pod"))
    with pytest.raises(ValueError, match="twice"):
        compat.placements_of(m, compat.P("data", "data"))
    # a dp-sharded dim's block is JAX's major-to-minor one: pod, then data
    x = torch.arange(64.0).reshape(64, 1)
    d = compat.distribute(x, m, compat.P(("pod", "data"), None))
    pod, data, _ = m.get_coordinate()
    i = pod * 16 + data
    assert torch.equal(d.to_local(), x[2 * i:2 * i + 2])


def test_make_constrain_places_dtensors_and_passes_the_rest(meshes):
    from torch.distributed.tensor import Replicate, Shard

    m = meshes["1x1"]
    c = sh.make_constrain(m, {"residual": compat.P("data", None, None)})
    x = compat.distribute(torch.ones(2, 3, 4), m, compat.P())
    assert c(x, "residual").placements == (Shard(0), Replicate())
    assert c(x, "unknown") is x
    y = compat.distribute(torch.ones(2, 3), m, compat.P())
    assert c(y, "residual") is y  # rank mismatch
    plain = torch.ones(2, 3, 4)
    assert c(plain, "residual") is plain


def test_production_mesh(meshes):
    assert compat.mesh_axes(make_production_mesh(device="cpu")) == {"data": 16, "model": 16}
    assert compat.mesh_axes(make_production_mesh(multi_pod=True, device="cpu")) == {
        "pod": 2, "data": 16, "model": 16}
    assert compat.mesh_axes(make_local_mesh(device="cpu")) == {"data": 512, "model": 1}
    with pytest.raises(ValueError, match="needs 1024 devices"):
        compat.make_mesh((4, 16, 16), ("pod", "data", "model"), device="cpu")


def _names_seen(fn) -> set:
    seen = []

    def constrain(x, name):
        seen.append((name, len(x.shape)))
        return x

    fn(constrain)
    return set(seen)


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b"])
def test_transformer_calls_constrain_as_the_reference(arch):
    """The same (name, rank) pairs reach ``constrain`` in train_loss,
    prefill, decode_step and decode_step_q8 (the reference scans its layers,
    the port loops over them)."""
    from repro.models import transformer as RT

    cfg = dataclasses.replace(reduced_config(arch), remat=False)
    rcfg = dataclasses.replace(ref_reduced_config(arch), remat=False)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rparams = RT.init_params(jax.random.key(0), rcfg)
    B, S = 2, 64
    tok = np.random.RandomState(0).randint(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tok)}
    rbatch = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tok)}
    assert _names_seen(lambda c: T.train_loss(params, cfg, batch, c)) == _names_seen(
        lambda c: RT.train_loss(rparams, rcfg, rbatch, c))
    assert _names_seen(lambda c: T.prefill(params, cfg, batch["tokens"], c)) == _names_seen(
        lambda c: RT.prefill(rparams, rcfg, rbatch["tokens"], c))
    kc, vc = T.make_cache(cfg, B, 8, device="cpu")
    rkc, rvc = RT.make_cache(rcfg, B, 8)
    one, rone = batch["tokens"][:, :1], rbatch["tokens"][:, :1]
    assert _names_seen(lambda c: T.decode_step(params, cfg, one, 0, kc, vc, c)) == _names_seen(
        lambda c: RT.decode_step(rparams, rcfg, rone, 0, rkc, rvc, c))
    kq, vq = T.make_cache_q8(cfg, B, 8, device="cpu")
    rkq, rvq = RT.make_cache_q8(rcfg, B, 8)
    assert _names_seen(lambda c: T.decode_step_q8(params, cfg, one, 0, kq, vq, c)) == _names_seen(
        lambda c: RT.decode_step_q8(rparams, rcfg, rone, 0, rkq, rvq, c))


REINIT_CHILD = r"""
import os, sys
import torch, torch.distributed as dist
from repro_torch.dist import compat

out_dir, second_port = sys.argv[1:]
t = torch.arange(16.0).reshape(8, 2)
compat.init_process_group("cpu")
first = compat.make_mesh((2,), ("data",), device="cpu")
a = compat.distribute(t, first, compat.P("data"))
assert torch.equal(a.full_tensor(), t)
dist.destroy_process_group()
os.environ["MASTER_PORT"] = second_port
compat.init_process_group("cpu")
second = compat.make_mesh((2,), ("data",), device="cpu")
assert second == first and second is not first
b = compat.distribute(t, second, compat.P("data"))
assert b.device_mesh is second, "a DTensor of the new group holds the old mesh"
assert torch.equal(b.full_tensor(), t)
assert torch.equal(b.redistribute(second, compat.placements_of(second, compat.P())).to_local(), t)
dist.destroy_process_group()
print("ok")
"""


def test_dtensors_after_a_new_group_use_its_mesh(tmp_path):
    """A mesh built after its group was destroyed and a new one started
    compares equal to the old mesh; the DTensors placed on it hold the new
    mesh (not a cached spec of the old one) and gather over the new group,
    on two gloo ranks."""
    from torch_ranks import free_port, run_ranks

    outs = run_ranks(REINIT_CHILD, 2, tmp_path, free_port(), timeout=120)
    assert [o.split() for o in outs] == [["ok"], ["ok"]]
