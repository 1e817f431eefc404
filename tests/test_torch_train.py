"""repro_torch's LM training path against repro's, at small sizes on the CPU.

The training half of models.transformer (backbone with remat,
chunked_ce_loss, train_loss), train.optimizer and train.loop, and the
launchers launch.train and launch.serve --ckpt-dir.  Parameters are the
reference's init carried across by models.convert; batches are seeded
numpy tokens.  Mirrors tests/test_train_serve.py and the optimizer cases
of tests/test_substrate.py.

Tolerances:
  * loss: |port - reference| <= LOSS_TOL * |reference| (float32; XLA-CPU
    and torch sum in different orders and use different exp / log / rsqrt);
  * gradients: every leaf max |port - reference| <= GRAD_TOL * max
    |reference leaf|, dense, MoE and MoE with tokens dropped past capacity;
  * remat on against off: bit-equal (the recomputed forward is the same
    float32 program on the CPU);
  * AdamW on the same numpy gradients: float32 leaves and both moments
    within ADAM_REL of max |reference leaf| (the update's ops are the same,
    in float32; XLA may fuse them into FMAs), bfloat16 parameters within one
    ulp (a float32 difference that straddles a rounding boundary);
  * the global norm within NORM_REL (float32 sums over ~10^5 squares,
    leaf by leaf in one package and over stacked layers in the other);
  * the schedule within SCHEDULE_ULPS float32 ulps of the eager reference
    (torch.cos and XLA's cos differ by up to 2 ulps; the jitted reference
    differs from the eager one by up to 3); the decay mask equal;
  * grad_accum = 2 against 1: atol 2e-5, as tests/test_train_serve.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as ref_reduced_config
from repro.models import transformer as RT
from repro.train import checkpoint as RC
from repro.train import optimizer as RO
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.data import corpus
from repro_torch.data.pipeline import LMDataPipeline, VOCAB
from repro_torch.dist.fault_tolerance import InjectedFault
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.common import rmsnorm, tree_leaves, tree_map
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O
from repro_torch.train.loop import TrainConfig, make_train_step, train, value_and_grad

CPU = "cpu"
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_REL = 1e-6
NORM_REL = 1e-5
SCHEDULE_ULPS = 2
SEQ = 64


def _tiny_cfg(arch="smollm-135m", **kw):
    """tests/test_train_serve.py's tiny config (2 layers, d 32); the MoE
    keeps reduced phi3.5-moe's 4 experts and 64-token groups."""
    cfg = dataclasses.replace(
        reduced_config(arch), vocab=VOCAB, n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
        d_ff=64, q_chunk=32, kv_chunk=32, ce_chunk=32, **kw)
    ref = dataclasses.replace(
        ref_reduced_config(arch), vocab=VOCAB, n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
        d_ff=64, q_chunk=32, kv_chunk=32, ce_chunk=32, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    return cfg, ref


def _tokens(seed, B=2, S=SEQ, repeat_row=False):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, VOCAB, size=(B, S + 1)).astype(np.int32)
    if repeat_row:
        toks[0] = ord("e")  # one byte: every token of the row routes alike
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port_named(tree):
    """name -> float64 array of a port tree, layers stacked (the names of
    both packages' checkpoints)."""
    out = {}
    for path, leaf in ckpt._flatten(tree):
        t = torch.stack(leaf) if isinstance(leaf, list) else leaf
        out[ckpt._name(path)] = t.detach().double().numpy()
    return out


def _ref_named(tree):
    items, _ = RC._flatten(tree)
    return {n: np.asarray(x, np.float32).astype(np.float64) for n, x in items}


def _held_rel(got: dict, want: dict, rel: float):
    assert got.keys() == want.keys()
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale if w.size else 0.0
        assert err <= rel, (name, err, rel)
        worst = max(worst, err)
    return worst


@pytest.fixture(scope="module")
def models():
    """Per config: (port cfg, reference cfg, reference params, port params,
    jitted reference value_and_grad)."""
    out = {}
    for name, arch in (("dense", "smollm-135m"), ("moe", "phi3.5-moe-42b-a6.6b")):
        cfg, ref = _tiny_cfg(arch)
        rp = RT.init_params(jax.random.key(7), ref)
        vg = jax.jit(jax.value_and_grad(lambda p, b, _c=ref: RT.train_loss(p, _c, b)))
        out[name] = (cfg, ref, rp, lm_params_from_numpy(_host(rp), cfg, device=CPU), vg)
    return out


def _layer0_assignments(params, cfg, tokens):
    """Layer 0's MoE dispatch one-hots summed: assignments kept after the
    capacity drop."""
    lp = params["layers"][0]
    h = params["embed"][torch.from_numpy(tokens).long()]
    h, _ = T._attn_block(h, lp, cfg, torch.arange(tokens.shape[1]))
    x = rmsnorm(h, lp["ln2"], cfg.norm_eps).reshape(-1, cfg.d_model)
    g = min(cfg.moe_group, x.shape[0])
    logits = x.reshape(-1, g, cfg.d_model) @ lp["moe"]["router"]
    dispatch, _, _ = M._route(logits, cfg.moe_cfg, M.capacity(cfg.moe_cfg, g))
    return int(dispatch.sum())


@pytest.mark.parametrize("case", ["dense", "moe", "moe_dropped"])
def test_train_loss_and_every_gradient_match_jax_grad(models, case):
    cfg, _, rp, pp, vg = models[case.split("_")[0]]
    batch = _tokens(11, repeat_row=case == "moe_dropped")
    if case == "moe_dropped":
        kept = _layer0_assignments(pp, cfg, batch["tokens"])
        assert kept < cfg.moe_top_k * batch["tokens"].size  # tokens were dropped
    want_loss, want_grads = vg(rp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(lambda p, b: T.train_loss(p, cfg, b), pp, _tb(batch))
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * abs(float(want_loss))
    _held_rel(_port_named(grads), _ref_named(want_grads), GRAD_TOL)


@pytest.mark.parametrize("case", ["dense", "moe_dropped"])
def test_remat_on_and_off_bit_equal(models, case):
    cfg, _, _, pp, _ = models[case.split("_")[0]]
    batch = _tb(_tokens(12, repeat_row=case == "moe_dropped"))
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(lambda p, b: T.train_loss(p, c, b), pp, batch)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(_port_named(out[True][1]).values(), _port_named(out[False][1]).values()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("chunk", [8, 16, 64, 256])
def test_chunked_ce_loss_matches_reference(chunk):
    rs = np.random.RandomState(chunk)
    h = rs.randn(2, SEQ, 16).astype(np.float32)
    un = rs.randn(16, 40).astype(np.float32)
    tg = rs.randint(0, 40, size=(2, SEQ)).astype(np.int32)
    want = float(RT.chunked_ce_loss(h, un, tg, chunk))
    got = float(T.chunked_ce_loss(torch.from_numpy(h), torch.from_numpy(un), torch.from_numpy(tg), chunk))
    assert abs(got - want) <= LOSS_TOL * abs(want)
    with pytest.raises(ValueError):
        T.chunked_ce_loss(torch.from_numpy(h), torch.from_numpy(un), torch.from_numpy(tg), 24)


def test_backbone_aux_is_the_mean_over_all_layers(models):
    cfg, _, rp, pp, _ = models["moe"]
    tok = _tokens(13, repeat_row=True)["tokens"]
    _, want = jax.jit(lambda p, t: RT.backbone(p, models["moe"][1], t))(rp, jnp.asarray(tok))
    _, got = T.backbone(pp, cfg, torch.from_numpy(tok))
    assert abs(float(got) - float(want)) <= LOSS_TOL * abs(float(want))
    dense_cfg, _, _, dense_pp, _ = models["dense"]
    assert float(T.backbone(dense_pp, dense_cfg, torch.from_numpy(tok))[1]) == 0.0


def test_param_shapes_match_reference():
    cfg, ref = _tiny_cfg("phi3.5-moe-42b-a6.6b")
    got = {n: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for n, t in ((ckpt._name(p), torch.stack(l) if isinstance(l, list) else l)
                        for p, l in ckpt._flatten(T.param_shapes(cfg)))}
    items, _ = RC._flatten(RT.param_shapes(ref))
    assert got == {n: (tuple(s.shape), str(s.dtype)) for n, s in items}
    assert all(t.device.type == "meta" for t in tree_leaves(T.param_shapes(cfg)))


# -- optimizer -------------------------------------------------------------


def _grads_like(tree, seed, scale):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (rs.randn(*x.shape) * scale).astype(np.float32).astype(x.dtype), tree)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_on_the_same_gradients(param_dtype):
    """Three updates, each from the same numpy gradients on both sides,
    state carried.  float32: large enough that the global norm clips.
    bfloat16: small enough that it does not (a clip scale that differs in
    its last bit, from a sum in another order, moves a bfloat16 gradient
    by a whole bfloat16 ulp; clipping is held in float32 here and in
    test_cosine_schedule_clip_and_decay_mask)."""
    clips = param_dtype == "float32"
    cfg, ref = _tiny_cfg(param_dtype=param_dtype)
    rp = _host(RT.init_params(jax.random.key(3), ref))
    pp = lm_params_from_numpy(rp, cfg, device=CPU)
    opt = O.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=5)
    ropt = RO.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=5)
    rs, ps = RO.adamw_init(rp), O.adamw_init(pp)
    rupdate = jax.jit(lambda g, s, p: RO.adamw_update(g, s, p, ropt))
    for i in range(3):
        g = _grads_like(rp, 100 + i, scale=0.5 if clips else 1e-3)
        rp, rs, rm = rupdate(g, rs, rp)
        pp, ps, pm = O.adamw_update(lm_params_from_numpy(g, cfg, device=CPU), ps, pp, opt)
        assert (float(rm["grad_norm"]) > 1.0) == clips
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= NORM_REL * float(rm["grad_norm"])
        assert np.float32(pm["lr"]) == np.float32(rm["lr"])
    assert int(ps.step) == int(rs.step) == 3 and ps.step.dtype == torch.int32
    _held_rel(_port_named(ps.m), _ref_named(rs.m), ADAM_REL)
    _held_rel(_port_named(ps.v), _ref_named(rs.v), ADAM_REL)
    if param_dtype == "float32":
        _held_rel(_port_named(pp), _ref_named(rp), ADAM_REL)
        return
    items, _ = RC._flatten(rp)
    for (name, want), (path, got) in zip(sorted(items), sorted(ckpt._flatten(pp))):
        assert name == ckpt._name(path)
        bits = ckpt._to_host(got).astype(np.int32)
        assert np.abs(bits - np.asarray(want).view(np.uint16).astype(np.int32)).max() <= 1, name


def test_cosine_schedule_clip_and_decay_mask():
    cfg = O.AdamWConfig(peak_lr=3e-3, warmup_steps=7, total_steps=40)
    rcfg = RO.AdamWConfig(peak_lr=3e-3, warmup_steps=7, total_steps=40)
    steps = np.arange(0, 45, dtype=np.int32)
    got = O.cosine_schedule(cfg, torch.from_numpy(steps)).numpy()
    want = np.asarray(RO.cosine_schedule(rcfg, jnp.asarray(steps)))
    assert got.dtype == np.float32
    assert np.all(np.abs(got.view(np.int32) - want.view(np.int32)) <= SCHEDULE_ULPS)
    _, ref = _tiny_cfg("phi3.5-moe-42b-a6.6b")
    cfg_m, _ = _tiny_cfg("phi3.5-moe-42b-a6.6b")
    rp = _host(RT.init_params(jax.random.key(4), ref))
    pp = lm_params_from_numpy(rp, cfg_m, device=CPU)
    mask = O._decay_mask(pp)
    rmask = RO._decay_mask(rp)
    # the reference decays its stacked norm scales (2-D there), not ln_f
    assert mask["layers"][1]["ln1"] is True and mask["ln_f"] is False
    assert rmask["layers"]["ln1"] and not rmask["ln_f"]
    named = {}
    for path, _ in ckpt._flatten(pp):
        node = mask
        for k in path:
            node = node[k][0] if isinstance(node[k], list) else node[k]
        named[ckpt._name(path)] = node
    items, _ = RC._flatten(rmask)
    assert named == {n: bool(f) for n, f in items}
    g = _grads_like(rp, 5, scale=2.0)
    gc, norm = O.clip_by_global_norm(lm_params_from_numpy(g, cfg_m, device=CPU), 1.0)
    rgc, rnorm = RO.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - float(rnorm)) <= NORM_REL * float(rnorm)
    _held_rel(_port_named(gc), _ref_named(rgc), ADAM_REL)


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = O.adamw_init(params)
    cfg = O.AdamWConfig(peak_lr=0.2, warmup_steps=5, total_steps=200, weight_decay=0.0)
    loss = lambda p, _: torch.sum(torch.square(p["w"] - 1.0))
    for _ in range(200):
        _, g = value_and_grad(loss, params, None)
        params, state, _ = O.adamw_update(g, state, params, cfg)
    assert float(loss(params, None)) < 1e-2


def test_sgd_update_matches_reference():
    rs = np.random.RandomState(0)
    p = {"a": rs.randn(3, 4).astype(np.float32), "b": [{"c": rs.randn(5).astype(np.float32)}]}
    g = {"a": rs.randn(3, 4).astype(np.float32), "b": [{"c": rs.randn(5).astype(np.float32)}]}
    want = RO.sgd_update(g, p, 0.1)
    t = lambda tree: {"a": torch.from_numpy(tree["a"]), "b": [{"c": torch.from_numpy(tree["b"][0]["c"])}]}
    got = O.sgd_update(t(g), t(p), 0.1)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0]["c"].numpy(), np.asarray(want["b"][0]["c"]))


# -- loop ------------------------------------------------------------------


def _data(batches=8, seq=32, bs=4):
    docs = corpus.documents("english", 64, doc_len=1024, seed=3)
    pipe = LMDataPipeline(docs, seq_len=seq, batch_size=bs, device=CPU)
    cached = [b for _, b in zip(range(batches), pipe)]

    def cycle():
        i = 0
        while True:
            yield cached[i % len(cached)]
            i += 1

    return cycle()


def test_train_step_trajectory_matches_reference(models):
    """Three make_train_step steps (AdamW) from the same parameters and
    batches: losses within LOSS_TOL, parameters after them within GRAD_TOL."""
    cfg, ref, rp, pp, _ = models["dense"]
    opt = dict(peak_lr=3e-3, warmup_steps=2, total_steps=3)
    rstep = jax.jit(ref_make_train_step(lambda p, b: RT.train_loss(p, ref, b), RO.AdamWConfig(**opt)))
    pstep = make_train_step(lambda p, b: T.train_loss(p, cfg, b), O.AdamWConfig(**opt))
    rs, ps = RO.adamw_init(rp), O.adamw_init(pp)
    for i in range(3):
        batch = _tokens(20 + i)
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v) for k, v in batch.items()})
        pp, ps, pm = pstep(pp, ps, _tb(batch))
        assert abs(float(pm["loss"]) - float(rm["loss"])) <= LOSS_TOL * abs(float(rm["loss"]))
    _held_rel(_port_named(pp), _ref_named(rp), GRAD_TOL)


def test_grad_accum_equivalence():
    cfg, _ = _tiny_cfg()
    params = T.init_params(torch.Generator().manual_seed(1), cfg, device=CPU)
    batch = _tb(next(_data()))
    loss_fn = lambda p, b: T.train_loss(p, cfg, b)
    opt = O.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    st = O.adamw_init(params)
    p1, _, m1 = make_train_step(loss_fn, opt, grad_accum=1)(params, st, batch)
    p2, _, m2 = make_train_step(loss_fn, opt, grad_accum=2)(params, st, batch)
    # microbatched grads average to the full-batch grads (CE is per-token mean)
    for a, b in zip(_port_named(p1).values(), _port_named(p2).values()):
        np.testing.assert_allclose(a, b, atol=2e-5)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5


def test_lm_trains_loss_decreases():
    cfg, _ = _tiny_cfg(dtype="bfloat16", param_dtype="bfloat16")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    tc = TrainConfig(steps=30, log_every=100, ckpt_every=1000, ckpt_dir=None,
                     opt=O.AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=30))
    _, _, hist = train(lambda p, b: T.train_loss(p, cfg, b), params, _data(), tc,
                       log=lambda s: None, device=CPU)
    assert len(hist) == 30 and all(isinstance(x, float) for x in hist)
    assert np.mean(hist[-5:]) < np.mean(hist[:5]) - 0.3, hist


def test_restart_resumes_from_checkpoint(tmp_path):
    cfg, _ = _tiny_cfg()
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    loss_fn = lambda p, b: T.train_loss(p, cfg, b)
    tc = TrainConfig(steps=12, log_every=100, ckpt_every=5, ckpt_dir=str(tmp_path),
                     async_checkpoint=True,
                     opt=O.AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=12))
    kept = {}
    save = ckpt.save

    def spy(tree, directory, step, **kw):
        kept[step] = _port_named(tree)
        return save(tree, directory, step, **kw)

    logs = []
    ckpt.save = spy
    try:
        with pytest.raises(InjectedFault):
            train(loss_fn, params, _data(), tc, fault_at_step=7, log=logs.append, device=CPU)
        # the async save of step 5 was published before the fault surfaced
        assert ckpt.latest_step(tmp_path) == 5
        assert not list(tmp_path.glob(".tmp_*"))
        restored, step = ckpt.restore((params, O.adamw_init(params)), tmp_path, device=CPU)
        assert step == 5
        got = _port_named(restored)
        assert got.keys() == kept[5].keys()
        assert all(np.array_equal(got[n], kept[5][n]) for n in got)
        # supervisor restart: resumes from the step-5 checkpoint, finishes
        _, _, hist = train(loss_fn, params, _data(), tc, log=logs.append, device=CPU)
    finally:
        ckpt.save = save
    assert "resumed from step 5" in logs
    assert len(hist) == 12 - 5  # only the remaining steps ran
    assert ckpt.latest_step(tmp_path) == 12 and sorted(kept) == [5, 10, 12]


def test_watchdog_checkpoint_action_saves(tmp_path):
    cfg, _ = _tiny_cfg()
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)

    class Always:
        events = []

        def start_step(self, step):
            pass

        def end_step(self):
            return "checkpoint"

    tc = TrainConfig(steps=3, log_every=100, ckpt_every=1000, ckpt_dir=str(tmp_path), keep_ckpts=5,
                     opt=O.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=3))
    train(lambda p, b: T.train_loss(p, cfg, b), params, _data(), tc, watchdog=Always(),
          log=lambda s: None, device=CPU)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [f"step_{i:08d}" for i in (1, 2, 3)]


def test_launchers_train_then_serve_from_its_checkpoint(tmp_path, capsys):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    d = str(tmp_path / "ck")
    params, opt_state = launch_train.main(
        ["--device", "cpu", "--reduced", "--steps", "3", "--seq", "32", "--batch", "2",
         "--ckpt-dir", d, "--ckpt-every", "3"])
    assert ckpt.latest_step(d) == 3 and int(opt_state.step) == 3
    results, served, step = launch_serve.main(["--device", "cpu", "--ckpt-dir", d, "--max-new", "4"])
    out = capsys.readouterr().out
    assert "restored step 3" in out and step == 3 and len(results) == 4
    got, want = _port_named(served), _port_named(params)
    assert got.keys() == want.keys() and all(np.array_equal(got[n], want[n]) for n in got)
    # a second launch resumes at the checkpoint and has nothing left to run
    launch_train.main(["--device", "cpu", "--reduced", "--steps", "3", "--seq", "32", "--batch",
                       "2", "--ckpt-dir", d])
    assert "resumed from step 3" in capsys.readouterr().out


def test_production_mesh_needs_256_devices():
    from repro_torch.launch import train as launch_train

    with pytest.raises(ValueError, match="256 devices"):
        launch_train.main(["--production-mesh", "--device", "cpu", "--steps", "1"])
