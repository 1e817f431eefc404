"""repro_torch.models.embedding against repro.models.embedding on the CPU.

Lookups, bags (sum, mean, max; weighted; an empty bag) and hash_bucket are
held equal to the reference with no tolerance: a bag sums its rows in id
order on both sides, and hash_bucket is integer arithmetic (the port's
int64 carry masked to 32 bits against the reference's uint32 wraparound).
masked_mean_pool's sum over the sequence is held within POOL_REL of the
reference's largest value, since the two packages add in other orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import embedding as RE
from repro_torch.models import embedding as E

V, D = 37, 6
POOL_REL = 1e-6


def _table(seed=0):
    return np.random.RandomState(seed).randn(V, D).astype(np.float32)


def _bags(seed, num_bags=7, nnz=40):
    """ids and sorted-or-not bag indices that leave bags 2 and 5 empty."""
    rs = np.random.RandomState(seed)
    live = np.array([b for b in range(num_bags) if b not in (2, 5)])
    seg = rs.choice(live, size=nnz).astype(np.int32)
    ids = rs.randint(0, V, size=nnz).astype(np.int32)
    w = rs.rand(nnz).astype(np.float32)
    return ids, seg, w, num_bags


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference_exactly(combiner, weighted):
    table = _table(1)
    ids, seg, w, n = _bags(2)
    want = np.asarray(RE.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), n,
                                       combiner, jnp.asarray(w) if weighted else None))
    got = E.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(seg), n,
                          combiner, torch.from_numpy(w) if weighted else None).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (n, D)
    assert np.array_equal(got, want)
    empty = got[[2, 5]]
    assert np.all(empty == (-np.inf if combiner == "max" else 0.0))


def test_embedding_bag_rejects_unknown_combiner():
    with pytest.raises(ValueError, match="unknown combiner"):
        E.embedding_bag(torch.zeros(3, 2), torch.zeros(1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), 1, "median")


def test_lookup_and_masked_mean_pool_match_reference():
    table = _table(3)
    rs = np.random.RandomState(4)
    ids = rs.randint(0, V, size=(3, 5)).astype(np.int32)
    got = E.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    assert np.array_equal(got, np.asarray(RE.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))))
    mask = (rs.rand(3, 5) < 0.6).astype(np.float32)
    mask[1] = 0.0  # an all-masked row pools to 0
    want = np.asarray(RE.masked_mean_pool(jnp.asarray(got), jnp.asarray(mask)))
    pooled = E.masked_mean_pool(torch.from_numpy(got), torch.from_numpy(mask)).numpy()
    # a float32 sum over T: XLA and torch add in other orders (POOL_REL)
    assert np.abs(pooled - want).max() <= POOL_REL * np.abs(want).max()
    assert np.all(pooled[1] == 0)


@pytest.mark.parametrize("vocab", [1, 97, 1 << 20, 10_000_000])
def test_hash_bucket_matches_reference_uint32(vocab):
    """Negative ids wrap as astype(uint32); ids at and past 2^31 (uint32 in
    the reference, int64 here) hash their low 32 bits."""
    rs = np.random.RandomState(vocab % 1000)
    neg = np.concatenate([np.array([-1, -2, -(1 << 31), 0, 1, (1 << 31) - 1], np.int32),
                          rs.randint(-(1 << 31), 1 << 31, size=200, dtype=np.int64).astype(np.int32)])
    high = np.concatenate([np.array([1 << 31, (1 << 32) - 1, 3_000_000_000], np.uint32),
                           rs.randint(1 << 31, 1 << 32, size=200, dtype=np.int64).astype(np.uint32)])
    for ids, tensor in ((neg, torch.from_numpy(neg)),
                        (high, torch.from_numpy(high.astype(np.int64)))):
        want = np.asarray(RE.hash_bucket(jnp.asarray(ids), vocab))
        got = E.hash_bucket(tensor, vocab)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert got.min() >= 0 and got.max() < vocab


def test_init_table_scale_and_spec():
    spec = E.TableSpec("item", 4096, 16)
    t = E.init_table(torch.Generator().manual_seed(0), spec)
    assert t.shape == (4096, 16) and t.dtype == torch.float32
    assert abs(float(t.std()) - 0.25) < 0.01  # 1 / sqrt(dim)
