"""repro_torch.train.checkpoint against repro.train.checkpoint on the CPU.

The on-disk format is the reference's: the same leaf names, manifests and
.npy files (bfloat16 included, byte for byte), with the port's per-layer
list stacked on axis 0.  A checkpoint either package writes is restored by
the other, equal (no tolerance: the values are copied, never computed).
Mirrors the checkpoint cases of tests/test_substrate.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as ref_reduced_config
from repro.models import transformer as RT
from repro.train import checkpoint as RC
from repro.train import optimizer as RO
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import VOCAB
from repro_torch.models import transformer as T
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O

CPU = "cpu"


def _cfgs(arch, dtype="bfloat16"):
    kw = dict(vocab=VOCAB, n_layers=3, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
              dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(reduced_config(arch), **kw),
            dataclasses.replace(ref_reduced_config(arch), **kw))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's exact contents (bfloat16 as its raw bits)."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _named(tree) -> dict:
    """name -> tensor, layers stacked, as the checkpoint names them."""
    return {ckpt._name(path): torch.stack(leaf) if isinstance(leaf, list) else leaf
            for path, leaf in ckpt._flatten(tree)}


def _equal_trees(a, b):
    na, nb = _named(a), _named(b)
    assert na.keys() == nb.keys()
    for name, x in na.items():
        y = nb[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(_bits(x), _bits(y)), name


@pytest.fixture(scope="module")
def ref_states():
    """Per arch, the reference's (params, AdamW state after one update):
    moments and step not zero; init and update jitted once."""
    out = {}
    for arch in ("smollm-135m", "phi3.5-moe-42b-a6.6b"):
        cfg, ref = _cfgs(arch)

        def make(key, _ref=ref):
            params = RT.init_params(key, _ref)
            grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
            new_p, state, _ = RO.adamw_update(grads, RO.adamw_init(params), params,
                                              RO.AdamWConfig())
            return new_p, state

        params, state = jax.jit(make)(jax.random.key(5))
        out[arch] = (cfg, _host(params), _host(state))
    return out


def _port_state(cfg, params, state):
    """The same state in the port's layout."""
    return (lm_params_from_numpy(params, cfg, device=CPU),
            O.AdamWState(step=torch.tensor(int(state.step), dtype=torch.int32),
                         m=lm_params_from_numpy(state.m, cfg, device=CPU),
                         v=lm_params_from_numpy(state.v, cfg, device=CPU)))


def test_checkpoint_roundtrip_bf16_and_keep_k(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(5, dtype=torch.bfloat16)}}
    ckpt.save(tree, tmp_path, step=10)
    ckpt.save(tree, tmp_path, step=20)
    restored, step = ckpt.restore(tree, tmp_path, device=CPU)
    assert step == 20
    _equal_trees(restored, tree)
    assert restored["b"]["c"].dtype == torch.bfloat16
    restored, step = ckpt.restore(tree, tmp_path, step=10, device=CPU)
    assert step == 10
    for s in (30, 40, 50):
        ckpt.save(tree, tmp_path, step=s, keep=2)
    assert ckpt.latest_step(tmp_path) == 50
    assert len(list(tmp_path.glob("step_*"))) == 2
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore({"a": torch.zeros(4, 3), "b": {"c": torch.zeros(5)}}, tmp_path, device=CPU)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tree, tmp_path / "none", device=CPU)


def test_checkpoint_async_and_atomic(tmp_path):
    tree = {"w": torch.ones((64, 64))}
    t = ckpt.save(tree, tmp_path, step=1, async_=True)
    # the host copy is taken before save returns: changing the tensor now
    # does not change what is written
    tree["w"].zero_()
    t.join()
    assert not t.is_alive()
    restored, step = ckpt.restore({"w": torch.zeros(64, 64)}, tmp_path, device=CPU)
    assert step == 1 and bool((restored["w"] == 1).all())
    assert not list(tmp_path.glob(".tmp_*"))
    # a stale tmp directory of a crashed writer never shadows a checkpoint
    os.makedirs(tmp_path / f".tmp_step_2_{os.getpid()}")
    assert ckpt.latest_step(tmp_path) == 1


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b"])
def test_port_checkpoint_is_the_reference_format(tmp_path, ref_states, arch):
    """The port's save of (params, opt_state) and the reference's save of
    the same state: equal manifests and byte-identical .npy files (names
    from tree_flatten_with_path, layers stacked on axis 0, bfloat16 under
    ml_dtypes' header)."""
    cfg, params, state = ref_states[arch]
    RC.save((params, state), tmp_path / "ref", step=1)
    ckpt.save(_port_state(cfg, params, state), tmp_path / "port", step=1)
    ref_dir, port_dir = tmp_path / "ref" / "step_00000001", tmp_path / "port" / "step_00000001"
    want = json.loads((ref_dir / "manifest.json").read_text())
    got = json.loads((port_dir / "manifest.json").read_text())
    assert got == want
    names = [leaf["name"] for leaf in got["leaves"]]
    assert names[:2] == ["0__embed", "0__layers__ln1"] and "1__step" in names
    assert "1__m__layers__wq" in names and "1__v__ln_f" in names
    assert {leaf["dtype"] for leaf in got["leaves"]} == {"bfloat16", "float32", "int32"}
    for leaf in want["leaves"]:
        assert (port_dir / leaf["file"]).read_bytes() == (ref_dir / leaf["file"]).read_bytes()


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, ref_states, arch):
    """ckpt.save((params, opt_state)) of the reference, restored by the port
    into its own layout, equals lm_params_from_numpy of the same tree."""
    cfg, params, state = ref_states[arch]
    RC.save((params, state), tmp_path, step=7)
    init = T.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    like = (init, O.adamw_init(init))
    (p, s), step = ckpt.restore(like, tmp_path, device=CPU)
    assert step == 7
    _equal_trees((p, s), _port_state(cfg, params, state))
    assert isinstance(p["layers"], list) and len(p["layers"]) == cfg.n_layers
    assert s.step.dtype == torch.int32 and int(s.step) == 1
    # meta tensors (param_shapes) describe the tree as well
    shapes = T.param_shapes(cfg)
    (p2, _), _ = ckpt.restore((shapes, O.adamw_init(p)), tmp_path, device=CPU)
    _equal_trees(p2, p)


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, ref_states, arch):
    cfg, params, state = ref_states[arch]
    ckpt.save(_port_state(cfg, params, state), tmp_path, step=3)
    (rp, rs), step = RC.restore((params, state), tmp_path)
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves((rp, rs)), jax.tree_util.tree_leaves((params, state))):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
