"""repro_torch.configs against repro.configs: the ten archs in the
reference's order, every reduced config and every full (arch, shape) config
equal field by field, and param_shapes of every full config equal to the
reference's jax.eval_shape shapes, as meta tensors (nothing allocated:
DCN-v2's tables alone hold 574 M floats)."""

import dataclasses

import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import all_cells as ref_all_cells
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced_config as ref_reduced_config
from repro.models import gnn as RG
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro.train import checkpoint as RC
from repro_torch.configs import ARCH_IDS, all_cells, get_arch, reduced_config
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.models.common import param_count, tree_leaves
from repro_torch.train import checkpoint as ckpt

PORT_MODELS = {"lm": T, "gnn": G, "recsys": R}
REF_MODELS = {"lm": RT, "gnn": RG, "recsys": RR}


def test_arch_ids_families_and_cells_equal_reference():
    assert ARCH_IDS == REF_ARCH_IDS and len(ARCH_IDS) == 10
    assert [get_arch(a).family for a in ARCH_IDS] == [ref_get_arch(a).family for a in ARCH_IDS]
    assert all_cells() == ref_all_cells() and len(all_cells()) == 40
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("nope")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_config_equals_reference(arch):
    cfg, ref = reduced_config(arch), ref_reduced_config(arch)
    assert type(cfg).__name__ == type(ref).__name__
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch,shape", ref_all_cells())
def test_full_config_of_every_cell_equals_reference(arch, shape):
    cfg = get_arch(arch).make_config(shape)
    ref = ref_get_arch(arch).make_config(shape)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(get_arch(arch).shapes[shape]) == \
        dataclasses.asdict(ref_get_arch(arch).shapes[shape])


def _full_configs():
    out = []
    for arch in ARCH_IDS:
        shapes = list(get_arch(arch).shapes) if get_arch(arch).family == "gnn" else [None]
        out += [(arch, s) for s in shapes]
    return out


@pytest.mark.parametrize("arch,shape", _full_configs())
def test_param_shapes_of_full_configs_match_eval_shape(arch, shape):
    spec = get_arch(arch)
    cfg, ref = spec.make_config(shape), ref_get_arch(arch).make_config(shape)
    shapes = PORT_MODELS[spec.family].param_shapes(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    got = {ckpt._name(p): (((len(l),) if isinstance(l, list) else ()) + tuple(
               (l[0] if isinstance(l, list) else l).shape),
           str((l[0] if isinstance(l, list) else l).dtype).replace("torch.", ""))
           for p, l in ckpt._flatten(shapes)}
    items, _ = RC._flatten(REF_MODELS[spec.family].param_shapes(ref))
    assert got == {n: (tuple(s.shape), str(s.dtype)) for n, s in items}
    if spec.family == "gnn":
        assert cfg.param_count() == ref.param_count()


def test_recsys_parameter_counts():
    """DCN-v2 holds 577 M parameters (its tables 574.4 M), BST 34 M, DIN
    and DIEN 18 M."""
    counts = {a: param_count(R.param_shapes(get_arch(a).make_config()))
              for a in ("dcn-v2", "bst", "din", "dien")}
    assert counts == {"dcn-v2": 576_968_643, "bst": 34_404_417, "din": 18_232_842,
                      "dien": 18_346_337}
    vocabs = get_arch("dcn-v2").make_config().sparse_vocabs
    assert sum(vocabs) * 16 == 574_400_000 and vocabs == R.dcn_default_vocabs(26)
