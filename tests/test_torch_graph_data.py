"""repro_torch.data.graph and repro_torch.data.recsys_data against the
reference's copies on the CPU: the same seeds give equal arrays (no
tolerance), for three seeds each."""

import numpy as np
import pytest

from repro.configs import reduced_config as ref_reduced_config
from repro.data import graph as RG
from repro.data import recsys_data as RD
from repro_torch.configs import reduced_config
from repro_torch.data import graph as G
from repro_torch.data import recsys_data as D

SEEDS = (0, 1, 7)


def _equal_dicts(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("seed", SEEDS)
def test_synthetic_graph_edge_list_and_sampler(seed):
    g = G.synthetic_graph(500, 8, 6, 4, seed=seed)
    r = RG.synthetic_graph(500, 8, 6, 4, seed=seed)
    for name in ("indptr", "indices", "feats", "labels"):
        assert np.array_equal(getattr(g, name), getattr(r, name)), name
        assert getattr(g, name).dtype == getattr(r, name).dtype, name
    assert (g.n_nodes, g.n_edges) == (r.n_nodes, r.n_edges)
    assert np.array_equal(G.edge_list(g), RG.edge_list(r))
    seeds = np.random.RandomState(seed).choice(500, 16, replace=False)
    got = G.sample_subgraph(g, seeds, (5, 3), seed=seed + 3)
    want = RG.sample_subgraph(r, seeds, (5, 3), seed=seed + 3)
    _equal_dicts(got, want)
    # padded to the fanout's product, with live padding slots (0 -> 0)
    assert got["edges"].shape == (2, 16 * 5 + 16 * 15)
    assert got["nodes"].shape[0] == 16 * (1 + 5 + 15)


def test_sampler_pads_low_degree_nodes():
    """A graph of degree-1 nodes under fanout 4: most edge slots are
    padding (edge_mask 0, edges 0 -> 0), as in the reference."""
    g = G.synthetic_graph(64, 1, 3, 2, seed=5)
    r = RG.synthetic_graph(64, 1, 3, 2, seed=5)
    seeds = np.arange(8)
    got = G.sample_subgraph(g, seeds, (4, 4), seed=1)
    _equal_dicts(got, RG.sample_subgraph(r, seeds, (4, 4), seed=1))
    pad = got["edge_mask"] == 0
    assert pad.any() and not got["edges"][:, pad].any()


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_molecules(seed):
    _equal_dicts(G.batched_molecules(6, 9, 17, 5, 3, seed=seed),
                 RG.batched_molecules(6, 9, 17, 5, 3, seed=seed))


@pytest.mark.parametrize("arch", ["din", "dien", "bst", "dcn-v2"])
@pytest.mark.parametrize("seed", SEEDS)
def test_recsys_batches(arch, seed):
    cfg, ref = reduced_config(arch), ref_reduced_config(arch)
    _equal_dicts(D.make_batch(cfg, 33, seed=seed), RD.make_batch(ref, 33, seed=seed))
    _equal_dicts(D.make_batch(cfg, 5, seed=seed, with_label=False),
                 RD.make_batch(ref, 5, seed=seed, with_label=False))
    if arch == "dcn-v2":
        _equal_dicts(D.dcn_batch(cfg, 9, seed), RD.dcn_batch(ref, 9, seed))
    else:
        _equal_dicts(D.seq_batch(cfg, 9, seed), RD.seq_batch(ref, 9, seed))
        b = D.seq_batch(cfg, 64, seed)
        assert b["hist_mask"].sum(axis=1).min() >= max(1, cfg.seq_len // 4)
