"""repro_torch.models.gnn against repro.models.gnn on the CPU: GatedGCN at
its reduced config (2 layers, d_hidden 16), node readout on a full
synthetic graph and on a sampled subgraph with padding edges, graph readout
on batched molecules, remat on and off.

Parameters are the reference's init carried across by
models.convert.gnn_params_from_numpy (its stacked ``layers`` split into the
port's per-layer list).  Tolerances as tests/test_torch_recsys.py:
node logits and graph predictions within LOGIT_TOL of max |reference|;
the loss within LOSS_TOL; every gradient leaf within GRAD_TOL of the leaf
max; one train.loop.train step (AdamW, lr 1e-3, nonzero biases) within
ADAM_TOL of the leaf max; remat on against off bit-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as ref_reduced_config
from repro.models import gnn as RG
from repro.train import checkpoint as RC
from repro.train import loop as RL
from repro.train import optimizer as RO
from repro_torch.configs import reduced_config
from repro_torch.data import graph as GD
from repro_torch.models import gnn as G
from repro_torch.models.convert import gnn_params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O
from repro_torch.train.loop import TrainConfig, train, value_and_grad

CPU = "cpu"
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 1e-5
N_GRAPHS = 5
CASES = ["full", "sampled", "molecule"]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_named(tree) -> dict:
    return {ckpt._name(p): (torch.stack(l) if isinstance(l, list) else l).detach().double().numpy()
            for p, l in ckpt._flatten(tree)}


def _ref_named(tree) -> dict:
    return {n: np.asarray(x, np.float64) for n, x in RC._flatten(tree)[0]}


def _held_rel(got: dict, want: dict, rel: float) -> float:
    assert got.keys() == want.keys()
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert err <= rel, (name, err, rel)
        worst = max(worst, err)
    return worst


def _cfgs(case, remat=True):
    kw = dict(remat=remat)
    if case == "molecule":
        kw.update(d_edge_feat=3, readout="graph")
    cfg = dataclasses.replace(reduced_config("gatedgcn"), **kw)
    ref = dataclasses.replace(ref_reduced_config("gatedgcn"), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    return cfg, ref


def _batch(case):
    if case == "molecule":
        return GD.batched_molecules(N_GRAPHS, 7, 12, 12, 3, seed=4)
    g = GD.synthetic_graph(300, 6, 12, 5, seed=1)
    if case == "full":
        return {"nodes": g.feats, "edges": GD.edge_list(g), "labels": g.labels}
    b = GD.sample_subgraph(g, np.arange(0, 80, 5), (3, 4), seed=2)
    assert (b["edge_mask"] == 0).any()  # padding edges (0 -> 0) are present
    return b


def _out(mod, params, cfg, batch):
    """Node logits or graph predictions."""
    if cfg.readout == "node":
        return mod.node_logits(params, cfg, batch)
    return mod.graph_prediction(params, cfg, batch, N_GRAPHS)


@pytest.fixture(scope="module")
def ref_params():
    out = {}
    for i, case in enumerate(CASES):
        _, ref = _cfgs(case)
        out[case] = _host(jax.jit(lambda k, _r=ref: RG.init_params(k, _r))(jax.random.key(30 + i)))
    return out


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_outputs_loss_and_every_gradient_match_jax_grad(ref_params, case, remat):
    cfg, ref = _cfgs(case, remat)
    rp, batch = ref_params[case], _batch(case)
    pp = gnn_params_from_numpy(rp, cfg, device=CPU)
    assert isinstance(pp["layers"], list) and len(pp["layers"]) == cfg.n_layers
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jax.jit(lambda p, b: _out(RG, p, ref, b))(rp, jb))
    got = _out(G, pp, cfg, _tb(batch)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    loss_fn = lambda p, b, _c=ref: RG.train_loss(p, _c, b, N_GRAPHS)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(rp, jb)
    pl, pg = value_and_grad(lambda p, b: G.train_loss(p, cfg, b, N_GRAPHS), pp, _tb(batch))
    assert abs(float(pl) - float(loss)) <= LOSS_TOL * abs(float(loss))
    _held_rel(_port_named(pg), _ref_named(grads), GRAD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_remat_on_and_off_bit_equal(ref_params, case):
    out = []
    for remat in (True, False):
        cfg, _ = _cfgs(case, remat)
        pp = gnn_params_from_numpy(ref_params[case], cfg, device=CPU)
        out.append(value_and_grad(lambda p, b: G.train_loss(p, cfg, b, N_GRAPHS), pp,
                                  _tb(_batch(case))))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    for (n, a), (_, b) in zip(_port_named(g1).items(), _port_named(g2).items()):
        assert np.array_equal(a, b), n


def _with_live_biases(rp, seed):
    """Zero leaves (biases, layer norm offsets) drawn at random, so that
    decaying one by mistake would move it."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (rs.randn(*x.shape) * 0.1).astype(x.dtype) if not x.any() else x, rp)


@pytest.mark.parametrize("case", CASES)
def test_one_adamw_train_step_matches_reference_loop(ref_params, case):
    cfg, ref = _cfgs(case)
    rp, batch = _with_live_biases(ref_params[case], 8), _batch(case)
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    rparams, rstate, rhist = RL.train(lambda p, b: RG.train_loss(p, ref, b, N_GRAPHS), rp, [batch],
                                      RL.TrainConfig(steps=1, opt=RO.AdamWConfig(**opt)),
                                      log=lambda s: None)
    pp = gnn_params_from_numpy(rp, cfg, device=CPU)
    pparams, pstate, phist = train(lambda p, b: G.train_loss(p, cfg, b, N_GRAPHS), pp, [batch],
                                   TrainConfig(steps=1, opt=O.AdamWConfig(**opt)),
                                   log=lambda s: None, device=CPU)
    assert abs(phist[0] - rhist[0]) <= LOSS_TOL * abs(rhist[0])
    _held_rel(_port_named(pparams), _ref_named(_host(rparams)), ADAM_TOL)
    _held_rel(_port_named(pstate.m), _ref_named(_host(rstate.m)), ADAM_TOL)
    _held_rel(_port_named(pstate.v), _ref_named(_host(rstate.v)), ADAM_TOL)


def test_padding_edges_are_live_as_in_the_reference(ref_params):
    """The backbone reads no edge_mask: a sampled batch's padding slots
    (0 -> 0) send node 0's message to node 0 in both packages, so node 0's
    logits move when the padding is cut away, and only node 0's."""
    cfg, ref = _cfgs("sampled")
    rp, batch = ref_params["sampled"], _batch("sampled")
    pp = gnn_params_from_numpy(rp, cfg, device=CPU)
    live = batch["edge_mask"] > 0
    cut = {**batch, "edges": batch["edges"][:, live]}
    padded, unpadded = (G.node_logits(pp, cfg, _tb(b)).numpy() for b in (batch, cut))
    for b, got in ((batch, padded), (cut, unpadded)):
        want = np.asarray(RG.node_logits(rp, ref, {k: jnp.asarray(v) for k, v in b.items()}))
        assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    moved = np.flatnonzero(np.abs(padded - unpadded).max(axis=1) > 0)
    assert moved.tolist() == [0]


def test_init_params_layout_and_param_count(ref_params):
    for case in CASES:
        cfg, ref = _cfgs(case)
        pp = G.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
        assert {n: v.shape for n, v in _port_named(pp).items()} == \
            {n: v.shape for n, v in _ref_named(ref_params[case]).items()}
        assert cfg.param_count() == ref.param_count()
        assert ("head_mlp" in pp) == (cfg.readout == "graph")
