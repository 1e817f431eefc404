"""One rule for the reference's stacked layers, in the optimizer's decay
mask and in the checkpoint format (models.common.is_stacked_layers).

The reference stacks exactly one list on axis 0, the one under the key
``layers`` (the LM's scanned layers, GatedGCN's vmapped ones); every other
list (MLP towers, BST ``blocks``, DCN-v2 ``cross`` and ``tables``, the GNN
``head_mlp``) is a Python list, its index a path element and its leaves
ranked alone.  Pins ROADMAP §3 faults 5 (tower biases decayed) and 6
(checkpoints of towers raised, blocks misnamed): the port's decay mask
equals ``repro.train.optimizer._decay_mask`` on all ten reduced archs, and
DCN-v2, BST and GatedGCN states cross between the two packages' checkpoints
both ways with equal manifests and byte-equal .npy files.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced_config as ref_reduced_config
from repro.models import common as RM
from repro.models import gnn as RG
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro.train import checkpoint as RC
from repro.train import optimizer as RO
from repro_torch.configs import ARCH_IDS, get_arch, reduced_config
from repro_torch.models import common as M
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.models.convert import gnn_params_from_numpy, recsys_params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O

CPU = "cpu"
PORT_MODELS = {"lm": T, "gnn": G, "recsys": R}
REF_MODELS = {"lm": RT, "gnn": RG, "recsys": RR}


def _flags_at(mask, path):
    """The port mask's flags for one checkpoint path (every layer's flag
    where the path runs through the stacked layers)."""
    if not path:
        return [mask]
    if isinstance(mask, list):
        if path[0].isdigit():
            return _flags_at(mask[int(path[0])], path[1:])
        return [f for layer in mask for f in _flags_at(layer, path)]
    return _flags_at(mask[path[0]], path[1:])


def _named_mask(params) -> dict:
    mask = O._decay_mask(params)
    out = {}
    for path, _ in ckpt._flatten(params):
        flags = set(_flags_at(mask, path))
        assert len(flags) == 1, path
        out[ckpt._name(path)] = flags.pop()
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decay_mask_equals_reference_on_every_reduced_arch(arch):
    family = get_arch(arch).family
    shapes = PORT_MODELS[family].param_shapes(reduced_config(arch))
    ref_shapes = REF_MODELS[family].param_shapes(ref_reduced_config(arch))
    items, _ = RC._flatten(RO._decay_mask(ref_shapes))
    assert _named_mask(shapes) == {n: bool(f) for n, f in items}


def test_fault5_tower_biases_do_not_decay():
    """ROADMAP §3 fault 5's input: the port gave a list of {'w': True, 'b':
    True}; the reference decays the weights and not the biases."""
    tree = {"tower": M.mlp_init(torch.Generator().manual_seed(0), [8, 4, 1], torch.float32)}
    mask = O._decay_mask(tree)
    assert mask == {"tower": [{"w": True, "b": False}, {"w": True, "b": False}]}
    ref_tree = {"tower": RM.mlp_init(RM.KeyGen(jax.random.key(0)), [8, 4, 1], jnp.float32)}
    assert RO._decay_mask(ref_tree) == {"tower": [{"w": True, "b": False}] * 2}
    # the LM's per-layer list keeps its stacked rank: a layer's norm decays
    layers = {"layers": [{"ln1": torch.ones(4)}, {"ln1": torch.ones(4)}], "ln_f": torch.ones(4)}
    assert O._decay_mask(layers) == {"layers": [{"ln1": True}, {"ln1": True}], "ln_f": False}


def test_is_stacked_layers_rule():
    layer = [{"w": torch.zeros(2)}]
    assert M.is_stacked_layers(("layers",), layer)
    assert M.is_stacked_layers(("1", "m", "layers"), layer)
    for path, node in ((("blocks",), layer), (("tower",), layer), ((), layer),
                       (("layers",), []), (("layers",), [torch.zeros(2)]),
                       (("layers",), {"w": torch.zeros(2)})):
        assert not M.is_stacked_layers(path, node), path


def test_fault6_blocks_and_towers_on_disk(tmp_path):
    """ROADMAP §3 fault 6's input: blocks were written stacked
    (blocks__wq [1, 4, 4]) and a tower raised in torch.stack.  Now both
    trees are written as the reference writes them."""
    rs = np.random.RandomState(0)
    tree = {"blocks": [{"wq": rs.randn(4, 4).astype(np.float32)}],
            "tower": [{"w": rs.randn(8, 4).astype(np.float32), "b": np.zeros(4, np.float32)},
                      {"w": rs.randn(4, 1).astype(np.float32), "b": np.zeros(1, np.float32)}]}
    port = {"blocks": [{"wq": torch.from_numpy(tree["blocks"][0]["wq"])}],
            "tower": [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in tree["tower"]]}
    ckpt.save(port, tmp_path / "port", step=1)
    RC.save(tree, tmp_path / "ref", step=1)
    got = json.loads((tmp_path / "port" / "step_00000001" / "manifest.json").read_text())
    want = json.loads((tmp_path / "ref" / "step_00000001" / "manifest.json").read_text())
    assert got == want
    assert {"name": "blocks__0__wq", "file": "blocks__0__wq.npy", "shape": [4, 4],
            "dtype": "float32"} in got["leaves"]
    assert "tower__1__b" in [leaf["name"] for leaf in got["leaves"]]
    back, _ = ckpt.restore(port, tmp_path / "ref", device=CPU)
    assert isinstance(back["tower"], list) and len(back["tower"]) == 2
    assert torch.equal(back["tower"][0]["w"], port["tower"][0]["w"])


# -- DCN-v2, BST and GatedGCN states across the two packages ---------------


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def ref_states():
    """Per arch, the reference's reduced (params, AdamW state after one
    update): moments and step not zero."""
    out = {}
    for arch in ("dcn-v2", "bst", "gatedgcn"):
        ref = ref_reduced_config(arch)
        mod = REF_MODELS[ref_get_arch(arch).family]

        def make(key, _ref=ref, _mod=mod):
            params = _mod.init_params(key, _ref)
            grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
            new_p, state, _ = RO.adamw_update(grads, RO.adamw_init(params), params,
                                              RO.AdamWConfig())
            return new_p, state

        params, state = jax.jit(make)(jax.random.key(6))
        out[arch] = (reduced_config(arch), _host(params), _host(state))
    return out


def _port_state(cfg, params, state):
    conv = gnn_params_from_numpy if cfg.name == "gatedgcn" else recsys_params_from_numpy
    return (conv(params, cfg, device=CPU),
            O.AdamWState(step=torch.tensor(int(state.step), dtype=torch.int32),
                         m=conv(state.m, cfg, device=CPU), v=conv(state.v, cfg, device=CPU)))


def _init_like(cfg):
    mod = G if cfg.name == "gatedgcn" else R
    init = mod.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    return init, O.adamw_init(init)


def _bits(tree) -> dict:
    return {ckpt._name(p): (torch.stack(l) if isinstance(l, list) else l).numpy()
            for p, l in ckpt._flatten(tree)}


@pytest.mark.parametrize("arch", ["dcn-v2", "bst", "gatedgcn"])
def test_port_checkpoint_is_the_reference_format(tmp_path, ref_states, arch):
    cfg, params, state = ref_states[arch]
    RC.save((params, state), tmp_path / "ref", step=1)
    ckpt.save(_port_state(cfg, params, state), tmp_path / "port", step=1)
    ref_dir, port_dir = tmp_path / "ref" / "step_00000001", tmp_path / "port" / "step_00000001"
    want = json.loads((ref_dir / "manifest.json").read_text())
    got = json.loads((port_dir / "manifest.json").read_text())
    assert got == want
    names = {leaf["name"] for leaf in got["leaves"]}
    expect = {"dcn-v2": {"0__tables__7", "0__cross__1__b", "1__m__tower__2__w"},
              "bst": {"0__blocks__0__wq", "0__blocks__0__ln1", "1__v__tower__0__b"},
              "gatedgcn": {"0__layers__A", "0__layers__bA", "1__m__layers__ln_h"}}[arch]
    assert expect <= names and "1__step" in names
    for leaf in want["leaves"]:
        assert (port_dir / leaf["file"]).read_bytes() == (ref_dir / leaf["file"]).read_bytes()


@pytest.mark.parametrize("arch", ["dcn-v2", "bst", "gatedgcn"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, ref_states, arch):
    cfg, params, state = ref_states[arch]
    RC.save((params, state), tmp_path, step=7)
    (p, s), step = ckpt.restore(_init_like(cfg), tmp_path, device=CPU)
    assert step == 7 and s.step.dtype == torch.int32 and int(s.step) == 1
    want = _bits(_port_state(cfg, params, state))
    got = _bits((p, s))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype and np.array_equal(got[name], w), name


@pytest.mark.parametrize("arch", ["dcn-v2", "bst", "gatedgcn"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, ref_states, arch):
    cfg, params, state = ref_states[arch]
    ckpt.save(_port_state(cfg, params, state), tmp_path, step=3)
    (rp, rs), step = RC.restore((params, state), tmp_path)
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves((rp, rs)), jax.tree_util.tree_leaves((params, state))):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
