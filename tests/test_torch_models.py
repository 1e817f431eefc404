"""repro_torch.models and repro_torch.configs against repro.models and
repro.configs, at small sizes on the CPU.

Mirrors tests/test_kv_quant.py and goes further: RoPE, chunked flash
attention (several Q/KV chunks, causal and not, GQA), decode attention,
int8 decode attention on inputs whose int8 sum would wrap, quantize_kv,
moe_ffn with dropped tokens, and prefill / decode_step / decode_step_q8 of
the reduced smollm-135m and phi3.5-moe, with the reference's parameters
carried across by models.convert.  The same seeded numpy inputs go through
both packages in float32.

Tolerances: exact outputs (int8 cache values, MoE dispatch one-hots, greedy
tokens, configs) are compared for equality.  Float outputs are held to
max |port - reference| <= 1e-5 for a single op on O(1) values and
<= 1e-4 * max |reference| for whole forward passes: XLA-CPU and torch
accumulate float32 sums in different orders and use different exp / sin /
rsqrt implementations (a few ulps each).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.models import attention as RA
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch import configs as C
from repro_torch.models import attention as A
from repro_torch.models import common as CM
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import lm_params_from_numpy

CPU = "cpu"
OP_TOL = 1e-5
PASS_REL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol, (err, tol)


def _close_rel(got, want, rel=PASS_REL_TOL):
    _close(got, want, rel * max(1e-30, float(np.abs(_np(want)).max())))


def _jit(fn, cfg):
    """A reference forward pass jitted once per config (op-by-op dispatch
    of an eager pass is slower than its compile here)."""
    return jax.jit(lambda *a: fn(a[0], cfg, *a[1:]))


def _ref_params(cfg, seed):
    """Reference params (JAX init) and the port's converted copy."""
    params = RT.init_params(jax.random.key(seed), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    return params, lm_params_from_numpy(tree, cfg, device=CPU)


# -- configs -------------------------------------------------------------


def _cells(table):
    return {k: dataclasses.asdict(v) for k, v in table.items()}


@pytest.mark.parametrize("arch", sorted(a for a, s in C.ARCHS.items() if s.family == "lm"))
def test_lm_configs_equal_field_by_field(arch):
    ref_full = RC.get_arch(arch).make_config()
    full = C.get_arch(arch).make_config()
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_full)
    assert dataclasses.asdict(C.reduced_config(arch)) == dataclasses.asdict(RC.reduced_config(arch))
    assert full.param_count() == ref_full.param_count()
    assert full.active_param_count() == ref_full.active_param_count()
    assert C.get_arch(arch).family == RC.get_arch(arch).family == "lm"
    assert _cells(C.get_arch(arch).shapes) == _cells(RC.get_arch(arch).shapes)


def test_registry_lists_every_reference_lm_arch_and_the_shape_tables():
    assert {a for a, s in C.ARCHS.items() if s.family == "lm"} == \
        {a for a, s in RC.ARCHS.items() if s.family == "lm"}
    assert C.all_cells() == RC.all_cells()
    for got, want in ((C.LM_SHAPES, RC.LM_SHAPES), (C.GNN_SHAPES, RC.GNN_SHAPES),
                      (C.RECSYS_SHAPES, RC.RECSYS_SHAPES)):
        assert _cells(got) == _cells(want)
    assert [C.pad_to(n, 8) for n in (0, 1, 8, 9)] == [RC.pad_to(n, 8) for n in (0, 1, 8, 9)]


# -- building blocks -------------------------------------------------------


def test_common_blocks():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 16).astype(np.float32)
    scale, bias = rs.randn(16).astype(np.float32), rs.randn(16).astype(np.float32)
    from repro.models import common as R

    _close(CM.rmsnorm(_t(x), _t(scale)), R.rmsnorm(x, scale), OP_TOL)
    _close(CM.layernorm(_t(x), _t(scale), _t(bias)), R.layernorm(x, scale, bias), OP_TOL)
    for name in CM.ACTIVATIONS:
        _close(CM.ACTIVATIONS[name](_t(x)), R.ACTIVATIONS[name](x), OP_TOL)
    labels = rs.randint(0, 16, size=(3, 5))
    _close(CM.softmax_cross_entropy(_t(x), _t(labels)), R.softmax_cross_entropy(x, labels), OP_TOL)
    y = (rs.rand(3, 5, 16) > 0.5).astype(np.float32)
    _close(CM.binary_cross_entropy(_t(x), _t(y)), R.binary_cross_entropy(x, y), OP_TOL)
    # rmsnorm runs in float32 and casts back
    xb = _t(x).to(torch.bfloat16)
    assert CM.rmsnorm(xb, _t(scale)).dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    layers = CM.mlp_init(gen, [16, 8, 4], torch.float32)
    assert CM.param_count(layers) == 16 * 8 + 8 + 8 * 4 + 4
    assert CM.mlp_apply(layers, _t(x)).shape == (3, 5, 4)


@pytest.mark.parametrize("pos_kind", ["shared", "per_row"])
def test_rope(pos_kind):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 8, 4, 16).astype(np.float32)
    pos = np.arange(8) if pos_kind == "shared" else rs.randint(0, 4096, size=(2, 8))
    _close(A.rope_frequencies(16, 10_000.0), RA.rope_frequencies(16, 10_000.0), 1e-7)
    # angles up to 4096 rad: sin/cos of float32 angles agree to a few ulps
    _close(A.apply_rope(_t(x), _t(pos), 10_000.0), RA.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 1e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunks", [(16, 16), (32, 16), (16, 64)])
def test_flash_attention_chunks_causal_gqa(causal, chunks):
    rs = np.random.RandomState(2)
    q = rs.randn(2, 64, 4, 16).astype(np.float32)
    k = rs.randn(2, 64, 2, 16).astype(np.float32)
    v = rs.randn(2, 64, 2, 16).astype(np.float32)
    qc, kc = chunks
    got = A.flash_attention(_t(q), _t(k), _t(v), causal=causal, q_chunk=qc, kv_chunk=kc)
    want = RA.flash_attention(q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc)
    _close(got, want, OP_TOL)


@pytest.mark.parametrize("cur_len", [1, 17, [5, 24]])
def test_decode_attention(cur_len):
    rs = np.random.RandomState(3)
    q = rs.randn(2, 1, 4, 16).astype(np.float32)
    kc = rs.randn(2, 24, 2, 16).astype(np.float32)
    vc = rs.randn(2, 24, 2, 16).astype(np.float32)
    cur = np.asarray(cur_len, np.int32)
    _close(A.decode_attention(_t(q), _t(kc), _t(vc), _t(cur)),
           RA.decode_attention(q, kc, vc, jnp.asarray(cur)), OP_TOL)


def test_decode_attention_q8_overflowing_int8_sums():
    """Queries and keys near +-127 after quantization: every score's int8
    sum would wrap (a torch.einsum on two int8 tensors returns int8), so
    only a widened contraction agrees with the reference's int32 one."""
    rs = np.random.RandomState(4)
    B, S, KVH, G, hd = 2, 20, 2, 2, 32
    q = (np.sign(rs.randn(B, 1, KVH * G, hd)) * rs.uniform(0.9, 1.0, (B, 1, KVH * G, hd))).astype(np.float32)
    k_q = (np.sign(q.reshape(B, KVH, G, hd)[:, None, :, 0]) * 127).astype(np.int8)
    k_q = np.broadcast_to(k_q, (B, S, KVH, hd)).copy()
    k_q[:, ::3] = -k_q[:, ::3]
    v_q = rs.randint(-127, 128, size=(B, S, KVH, hd)).astype(np.int8)
    k_s = rs.uniform(0.01, 0.02, (B, S, KVH)).astype(np.float32)
    v_s = rs.uniform(0.01, 0.02, (B, S, KVH)).astype(np.float32)
    # the exact int score of head (b, h, g) at position s; int8 would wrap
    qq = np.clip(np.round(q / np.maximum(np.abs(q).max(-1, keepdims=True) / 127, 1e-8)), -127, 127)
    exact = np.einsum("bhgd,bshd->bhgs", qq.reshape(B, KVH, G, hd).astype(np.int64), k_q.astype(np.int64))
    assert np.abs(exact).max() > 127 and not np.array_equal(exact.astype(np.int8), exact)
    for cur in (S, 7):
        got = A.decode_attention_q8(_t(q), _t(k_q), _t(k_s), _t(v_q), _t(v_s), cur)
        want = RA.decode_attention_q8(q, k_q, k_s, v_q, v_s, jnp.int32(cur))
        _close(got, want, OP_TOL)


def test_quantize_kv_int8_values_equal():
    rs = np.random.RandomState(5)
    x = (rs.randn(3, 7, 2, 16) * rs.uniform(0.1, 10, (3, 7, 2, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero row: the 1e-8 scale floor
    q, s = T.quantize_kv(_t(x))
    rq, rs_ = RT.quantize_kv(x)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(_np(q), np.asarray(rq))
    np.testing.assert_array_equal(_np(s), np.asarray(rs_))
    _close(T.dequantize_kv(q, s, torch.float32), RT.dequantize_kv(rq, rs_, jnp.float32), 1e-6)
    kq, vq = T.quantize_cache(_t(x), _t(-x))
    rkq, rvq = RT.quantize_cache(x, -x)
    for got, want in ((kq, rkq), (vq, rvq)):
        np.testing.assert_array_equal(_np(got["q"]), np.asarray(want["q"]))
        np.testing.assert_array_equal(_np(got["scale"]), np.asarray(want["scale"]))


def test_moe_ffn_with_dropped_tokens():
    """Two groups of 32 tokens, 4 experts, top-2, capacity 20: a router
    biased toward expert 0 sends it more tokens than its capacity, so both
    packages drop tokens; dispatch one-hots are equal, outputs close."""
    cfg_r = RM.MoEConfig(num_experts=4, top_k=2, group_size=32)
    cfg = M.MoEConfig(num_experts=4, top_k=2, group_size=32)
    assert M.capacity(cfg, 32) == RM.capacity(cfg_r, 32) == 20
    rs = np.random.RandomState(6)
    d, f = 16, 24
    x = rs.randn(64, d).astype(np.float32)
    p = {
        "router": (rs.randn(d, 4) * 0.1).astype(np.float32),
        "w1": (rs.randn(4, d, f) * 0.2).astype(np.float32),
        "w3": (rs.randn(4, d, f) * 0.2).astype(np.float32),
        "w2": (rs.randn(4, f, d) * 0.2).astype(np.float32),
    }
    x[:, 0] = 3.0
    p["router"][0, 0] = 2.0  # expert 0 first for nearly every token
    logits = x[:32] @ p["router"]
    disp_r, comb_r, _ = jax.jit(lambda lg: RM._route(lg, cfg_r, 20))(jnp.asarray(logits))
    disp, comb, _ = M._route(_t(logits), cfg, 20)
    np.testing.assert_array_equal(_np(disp), np.asarray(disp_r))
    _close(comb, comb_r, 1e-6)
    assert np.asarray(disp_r).sum() < 2 * 32  # tokens were dropped
    assert np.asarray(disp_r)[:, 0].sum() == 20  # expert 0 is full
    y, aux = M.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    y_r, aux_r = jax.jit(lambda x_, p_: RM.moe_ffn(x_, p_, cfg_r))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    _close_rel(y, y_r)
    _close(aux, aux_r, OP_TOL)


# -- whole forward passes --------------------------------------------------


def _tokens(cfg, B, S, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b"])
def test_prefill_decode_and_q8_decode(arch):
    cfg = RC.reduced_config(arch)
    rparams, params = _ref_params(cfg, seed=7)
    B, S, extra = 2, 32, 4
    tok = _tokens(cfg, B, S, 8)
    rlog, rkc, rvc = _jit(RT.prefill, cfg)(rparams, jnp.asarray(tok))
    log, kc, vc = T.prefill(params, cfg, _t(tok))
    _close_rel(log, rlog)
    _close_rel(kc, rkc)
    _close_rel(vc, rvc)

    rk2, rv2 = RT.make_cache(cfg, B, S + extra, jnp.float32)
    rk2, rv2 = rk2.at[:, :, :S].set(rkc), rv2.at[:, :, :S].set(rvc)
    k2, v2 = T.make_cache(cfg, B, S + extra, torch.float32, device=CPU)
    k2[:, :, :S], v2[:, :, :S] = kc, vc
    nxt = np.argmax(np.asarray(rlog), -1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(_np(log.argmax(-1)), nxt[:, 0])
    # quantize before decode_step writes at S (the port writes in place)
    kq, vq = T.quantize_cache(k2, v2)
    rkq, rvq = RT.quantize_cache(rk2, rv2)
    rlf, rk3, _ = _jit(RT.decode_step, cfg)(rparams, jnp.asarray(nxt), jnp.int32(S), rk2, rv2)
    lf, k3, _ = T.decode_step(params, cfg, _t(nxt), S, k2, v2)
    _close_rel(lf, rlf)
    _close_rel(k3[:, :, S], np.asarray(rk3)[:, :, S])
    rlq, rkq2, _ = _jit(RT.decode_step_q8, cfg)(rparams, jnp.asarray(nxt), jnp.int32(S), rkq, rvq)
    lq, kq2, _ = T.decode_step_q8(params, cfg, _t(nxt), S, kq, vq)
    _close_rel(lq, rlq)
    assert kq2["q"].dtype == torch.int8 and bool((kq2["q"][:, :, S] != 0).any())
    # the new int8 entries: a value on a rounding tie may land one step apart
    diff = np.abs(_np(kq2["q"][:, :, S]).astype(int) - np.asarray(rkq2["q"])[:, :, S].astype(int))
    assert diff.max() <= 1 and diff.mean() < 0.01


def test_q8_decode_close_to_fp_decode():
    """tests/test_kv_quant.py::test_q8_decode_matches_fp, on the port."""
    cfg = RT.LMConfig(
        name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=97, dtype="float32", param_dtype="float32",
        q_chunk=16, kv_chunk=16, ce_chunk=16,
    )
    _, params = _ref_params(cfg, seed=0)
    B, S = 2, 32
    log, kc, vc = T.prefill(params, cfg, _t(_tokens(cfg, B, S, 1)))
    k2, v2 = T.make_cache(cfg, B, S + 8, torch.float32, device=CPU)
    k2[:, :, :S], v2[:, :, :S] = kc, vc
    kq, vq = T.quantize_cache(k2, v2)
    nxt = log.argmax(-1)[:, None]
    lf, _, _ = T.decode_step(params, cfg, nxt, S, k2, v2)
    lq, _, _ = T.decode_step_q8(params, cfg, nxt, S, kq, vq)
    rel = float((lf - lq).abs().max() / lf.abs().max())
    assert rel < 0.05, rel
    assert torch.equal(lf.argmax(-1), lq.argmax(-1))


def test_eight_greedy_steps_equal_tokens():
    cfg = RC.reduced_config("smollm-135m")
    rparams, params = _ref_params(cfg, seed=9)
    B, S, steps = 2, 16, 8
    tok = _tokens(cfg, B, S, 10)
    rlog, rkc, rvc = _jit(RT.prefill, cfg)(rparams, jnp.asarray(tok))
    log, kc, vc = T.prefill(params, cfg, _t(tok))
    rdecode = _jit(RT.decode_step, cfg)
    rk, rv = RT.make_cache(cfg, B, S + steps, jnp.float32)
    rk, rv = rk.at[:, :, :S].set(rkc), rv.at[:, :, :S].set(rvc)
    k, v = T.make_cache(cfg, B, S + steps, torch.float32, device=CPU)
    k[:, :, :S], v[:, :, :S] = kc, vc
    ref_toks, toks = [], []
    for step in range(steps):
        rn = jnp.argmax(rlog, -1)[:, None].astype(jnp.int32)
        n = log.argmax(-1)[:, None]
        ref_toks.append(np.asarray(rn)[:, 0])
        toks.append(_np(n)[:, 0])
        rlog, rk, rv = rdecode(rparams, rn, jnp.int32(S + step), rk, rv)
        log, k, v = T.decode_step(params, cfg, n, S + step, k, v)
        _close_rel(log, rlog)
    np.testing.assert_array_equal(np.stack(toks), np.stack(ref_toks))


def test_init_params_shapes_counts_and_seeded():
    for arch in ("smollm-135m", "phi3.5-moe-42b-a6.6b"):
        cfg = C.reduced_config(arch)
        p1 = T.init_params(torch.Generator().manual_seed(3), cfg, device=CPU)
        p2 = T.init_params(torch.Generator().manual_seed(3), cfg, device=CPU)
        ref = jax.eval_shape(lambda k: RT.init_params(k, cfg), jax.random.key(0))
        assert CM.param_count(p1) == cfg.param_count()
        assert p1["embed"].shape == ref["embed"].shape
        for name, leaf in jax.tree_util.tree_leaves_with_path(ref["layers"]):
            keys = [e.key for e in name]
            got = p1["layers"][0]
            for kk in keys:
                got = got[kk]
            assert tuple(got.shape) == tuple(leaf.shape[1:]), keys
        assert all(torch.equal(a, b) for a, b in zip(
            [p1["embed"], p1["layers"][-1]["wq"]], [p2["embed"], p2["layers"][-1]["wq"]]))
    assert T.unembed_matrix(p1, cfg).shape == (cfg.d_model, cfg.vocab)


def test_convert_bfloat16_tree_bit_for_bit():
    """The full configs keep bfloat16 parameters: converted values keep
    their 16 bits, and a tied config takes no unembed matrix."""
    cfg = dataclasses.replace(RC.reduced_config("smollm-135m"), dtype="bfloat16",
                              param_dtype="bfloat16", tie_embeddings=True)
    params = RT.init_params(jax.random.key(11), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    got = lm_params_from_numpy(tree, cfg, device=CPU)
    assert "unembed" not in got and got["embed"].dtype == torch.bfloat16
    want = np.asarray(tree["layers"]["wq"][1]).view(np.uint16)
    np.testing.assert_array_equal(got["layers"][1]["wq"].view(torch.int16).numpy().view(np.uint16), want)
    np.testing.assert_array_equal(got["embed"].view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(tree["embed"]).view(np.uint16))
    with pytest.raises(ValueError):
        lm_params_from_numpy(tree, dataclasses.replace(cfg, n_layers=3), device=CPU)
