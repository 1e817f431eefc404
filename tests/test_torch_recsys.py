"""repro_torch.models.recsys against repro.models.recsys on the CPU: DIN,
DIEN, BST and DCN-v2 at their reduced configs.

Parameters are the reference's init carried across by
models.convert.recsys_params_from_numpy; batches come from
data.recsys_data (equal to the reference's for a seed,
tests/test_torch_graph_data.py).  Tolerances (float32; XLA-CPU and torch
sum in other orders and use other exp / tanh / rsqrt):
  * logits, serve_scores and retrieval_scores: max |port - reference| <=
    LOGIT_TOL * max |reference|;
  * train_loss: within LOSS_TOL of the reference, relative;
  * gradients: every leaf max |port - reference| <= GRAD_TOL * max
    |reference leaf|;
  * one train.loop.train step (AdamW, biases made nonzero so that weight
    decay on them would show): parameters and both moments within ADAM_TOL
    of the leaf max.  The step's lr is 1e-3: decaying a bias by mistake
    moves it by lr * 0.1 of itself, ten times ADAM_TOL; and AdamW's first
    step divides each gradient by its magnitude plus 1e-8, so a gradient
    near 1e-8, where the two packages' sums differ in their last bits,
    moves its parameter by a share of lr that those bits decide (at lr
    1e-2 DCN-v2's cross weights read 1.9e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as ref_reduced_config
from repro.models import recsys as RR
from repro.train import checkpoint as RC
from repro.train import loop as RL
from repro.train import optimizer as RO
from repro_torch.configs import reduced_config
from repro_torch.data.recsys_data import make_batch
from repro_torch.models import recsys as R
from repro_torch.models.convert import recsys_params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O
from repro_torch.train.loop import TrainConfig, train, value_and_grad

CPU = "cpu"
ARCHS = ["din", "dien", "bst", "dcn-v2"]
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_TOL = 1e-5
BATCH = 12


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, (err, tol)


@pytest.fixture(scope="module")
def models():
    """Per arch: (port cfg, reference cfg, reference params (numpy), port
    params, a numpy batch)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg, ref = reduced_config(arch), ref_reduced_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        rp = _host(jax.jit(lambda k, _r=ref: RR.init_params(k, _r))(jax.random.key(10 + i)))
        out[arch] = (cfg, ref, rp, recsys_params_from_numpy(rp, cfg, device=CPU),
                     make_batch(cfg, BATCH, seed=20 + i))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_serve_scores_match_reference(models, arch):
    cfg, ref, rp, pp, batch = models[arch]
    want = np.asarray(jax.jit(lambda p, b: RR.logits(p, ref, b))(rp, batch))
    got = R.logits(pp, cfg, _tb(batch))
    assert got.dtype == torch.float32 and got.shape == (BATCH,)
    _close(got.numpy(), want, LOGIT_TOL)
    scores = R.serve_scores(pp, cfg, make_batch(cfg, BATCH, seed=99, with_label=False), device=CPU)
    want_s = jax.jit(lambda p, b: RR.serve_scores(p, ref, b))(
        rp, make_batch(cfg, BATCH, seed=99, with_label=False))
    _close(scores.numpy(), np.asarray(want_s), LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_jax_grad(models, arch):
    cfg, ref, rp, pp, batch = models[arch]
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: RR.train_loss(p, ref, b)))(rp, batch)
    pl, pg = value_and_grad(lambda p, b: R.train_loss(p, cfg, b), pp, _tb(batch))
    assert abs(float(pl) - float(loss)) <= LOSS_TOL * abs(float(loss))
    _held_rel(_port_named(pg), _ref_named(grads), GRAD_TOL)
    # the lists stay lists: towers (and BST blocks, DCN-v2 cross / tables)
    assert isinstance(pg["tower"], list) and len(pg["tower"]) == len(cfg.mlp) + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_scores_match_reference(models, arch, monkeypatch):
    cfg, ref, rp, pp, _ = models[arch]
    C = 64
    user = make_batch(cfg, 1, seed=5, with_label=False)
    rs = np.random.RandomState(6)
    if cfg.kind == "dcn":
        cands = make_batch(cfg, C, seed=7)["sparse"]
    else:
        cands = rs.randint(0, cfg.item_vocab, size=C).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, u, c: RR.retrieval_scores(p, ref, u, c))(rp, user, cands))
    got = R.retrieval_scores(pp, cfg, user, cands, device=CPU)
    assert got.shape == (C,)
    _close(got.numpy(), want, LOGIT_TOL)
    # in blocks of 24, 24 and 16 candidates: the same scores
    monkeypatch.setattr(R, "RETRIEVAL_BLOCK", 24)
    blocked = R.retrieval_scores(pp, cfg, user, cands, device=CPU)
    _close(blocked.numpy(), want, LOGIT_TOL)


def _with_live_biases(rp, seed):
    """The reference tree with every 1-D zero leaf (biases, layer norm
    offsets) drawn at random, so that decaying it would move it."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (rs.randn(*x.shape) * 0.1).astype(x.dtype) if x.ndim == 1 and not x.any() else x,
        rp)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_train_step_matches_reference_loop(models, arch):
    cfg, ref, rp, _, batch = models[arch]
    rp = _with_live_biases(rp, 3)
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    rparams, rstate, rhist = RL.train(lambda p, b: RR.train_loss(p, ref, b), rp, [batch],
                                      RL.TrainConfig(steps=1, opt=RO.AdamWConfig(**opt)),
                                      log=lambda s: None)
    pp = recsys_params_from_numpy(rp, cfg, device=CPU)
    pparams, pstate, phist = train(lambda p, b: R.train_loss(p, cfg, b), pp, [batch],
                                   TrainConfig(steps=1, opt=O.AdamWConfig(**opt)),
                                   log=lambda s: None, device=CPU)
    assert abs(phist[0] - rhist[0]) <= LOSS_TOL * abs(rhist[0])
    assert int(pstate.step) == int(rstate.step) == 1
    _held_rel(_port_named(pparams), _ref_named(_host(rparams)), ADAM_TOL)
    _held_rel(_port_named(pstate.m), _ref_named(_host(rstate.m)), ADAM_TOL)
    _held_rel(_port_named(pstate.v), _ref_named(_host(rstate.v)), ADAM_TOL)


def test_bst_masked_softmax_and_dien_state_hold_on_short_histories(models):
    """Rows with one live position (the shortest seq_batch draws at T // 4
    >= 1): finite logits equal to the reference's."""
    for arch in ("dien", "bst"):
        cfg, ref, rp, pp, batch = models[arch]
        b = {k: v.copy() for k, v in batch.items()}
        b["hist_mask"][:, 1:] = 0.0
        want = np.asarray(jax.jit(lambda p, bb, _r=ref: RR.logits(p, _r, bb))(rp, b))
        got = R.logits(pp, cfg, _tb(b)).numpy()
        assert np.isfinite(got).all()
        _close(got, want, LOGIT_TOL)


def test_init_params_shapes_match_reference_init(models):
    for arch, (cfg, _, rp, _, _) in models.items():
        pp = R.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
        assert {n: v.shape for n, v in _port_named(pp).items()} == \
            {n: v.shape for n, v in _ref_named(rp).items()}, arch
