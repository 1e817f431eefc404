"""repro_torch.dist.embedding_exchange against repro.dist.embedding_exchange
and table[ids], on four gloo ranks of a (2, 2) ("data", "model") mesh.

The reference test's sizes (tests/test_embedding_exchange.py): V = 4096
rows of d = 16, n = 512 ids sharded over "data", the table row-sharded over
"model".  Every lookup equals table[ids] bit for bit (no tolerance: a
lookup copies rows) and the reference's lookup on four fake XLA devices
(same mesh, same inputs, in a subprocess).  ``PATH_COUNTS`` shows which
path each rank took: uniform and Zipf (1.3) ids at the default capacity
take the all-to-all, as one id for all does (its bucket exactly full) and
ids split evenly at capacity factor 1; one id for all and Zipf at capacity
factor 1 overflow and take the reference's (n, d) psum path, their ids
being replicated over the table axis.  One case gives the two ranks of a
table group different ids, one overflowing and one not: without the flag
reduced over the table axis they would wait on different collectives for
ever; with it the lookup ends (a timeout fails it), takes the gathered
psum path and stays exact.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torch_ranks import run_ranks, run_reference

V, D, N = 4096, 16, 512
RANKS = 4


def _cases():
    """name -> (ids (N,), capacity factor); ids replicated over "model"."""
    rng = np.random.RandomState(0)
    zipf = ((rng.zipf(1.3, N) - 1) % V).astype(np.int32)
    # each rank's 256 ids, half on either table shard: at capacity factor 1
    # every bucket is exactly full
    balanced = ((np.arange(N) % 2) * (V // 2) + rng.randint(0, V // 2, N)).astype(np.int32)
    return {
        "uniform": (rng.randint(0, V, N).astype(np.int32), 2.0),
        "zipf": (zipf, 2.0),
        "zipf_cap1": (zipf, 1.0),
        "one_id": (np.full(N, 7, np.int32), 2.0),
        "one_id_cap1": (np.full(N, 7, np.int32), 1.0),
        "balanced_cap1": (balanced, 1.0),
    }


CASES = _cases()
# the path each case takes on every rank
PATHS = {"uniform": "alltoall", "zipf": "alltoall", "zipf_cap1": "psum", "one_id": "alltoall",
         "one_id_cap1": "psum", "balanced_cap1": "alltoall"}

RANK_CHILD = r"""
import json, sys
import numpy as np, torch
from repro_torch.dist import compat
from repro_torch.dist import embedding_exchange as ex

out_dir = sys.argv[1]
cases = json.loads(open(f"{out_dir}/cases.json").read())
rank, world = compat.init_process_group("cpu")
mesh = compat.make_mesh((2, 2), ("data", "model"), device="cpu")
table = torch.from_numpy(np.load(f"{out_dir}/table.npy"))
keep, paths = {}, {}
for name, (ids, cf) in cases.items():
    ids = torch.tensor(ids, dtype=torch.int32)
    if name == "mixed" and mesh.get_local_rank("model") == 1:
        ids = torch.tensor(cases["balanced_cap1"][0], dtype=torch.int32)
    ex.reset_path_counts()
    out = ex.make_alltoall_lookup(mesh, "model", ("data",), capacity_factor=cf)(table, ids)
    keep[name] = out.to_local().numpy()
    paths[name] = {k: v for k, v in ex.PATH_COUNTS.items() if v}
np.savez(f"{out_dir}/rank{rank}.npz", **keep)
print(json.dumps({"rank": rank, "data": mesh.get_local_rank("data"),
                  "model": mesh.get_local_rank("model"), "paths": paths}))
torch.distributed.destroy_process_group()
"""

REF_PROBE = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.dist.compat import make_mesh
from repro.dist.embedding_exchange import make_alltoall_lookup

out_dir = sys.argv[1]
cases = json.loads(open(f"{out_dir}/cases.json").read())
mesh = make_mesh((2, 2), ("data", "model"))
table = jnp.asarray(np.load(f"{out_dir}/table.npy"))
keep = {}
for name, (ids, cf) in cases.items():
    if name != "mixed":
        lk = jax.jit(make_alltoall_lookup(mesh, "model", ("data",), capacity_factor=cf))
        keep[name] = np.asarray(lk(table, jnp.asarray(np.asarray(ids, np.int32))))
np.savez(f"{out_dir}/reference.npz", **keep)
"""


@pytest.fixture(scope="module")
def exchanged(tmp_path_factory):
    d = tmp_path_factory.mktemp("exchange")
    table = np.random.RandomState(1).randn(V, D).astype(np.float32)
    np.save(d / "table.npy", table)
    cases = {k: (ids.tolist(), cf) for k, (ids, cf) in CASES.items()}
    # model rank 0 of each table group gets one id for all (overflow), model
    # rank 1 balanced ids (no overflow), at capacity factor 1
    cases["mixed"] = (CASES["one_id"][0].tolist(), 1.0)
    (d / "cases.json").write_text(json.dumps(cases))
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(run_ranks, RANK_CHILD, RANKS, d, timeout=120)
        run_reference(REF_PROBE, RANKS, d)
        outs = ranks.result()
    infos = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    return table, infos, [np.load(d / f"rank{r}.npz") for r in range(RANKS)], np.load(
        d / "reference.npz")


@pytest.mark.parametrize("name", list(CASES))
def test_lookup_equals_table_rows_and_the_reference(exchanged, name):
    table, infos, got, ref = exchanged
    ids = CASES[name][0]
    rows = N // 2
    for info, g in zip(infos, got):
        sl = slice(info["data"] * rows, (info["data"] + 1) * rows)
        np.testing.assert_array_equal(g[name], table[ids[sl]])
        np.testing.assert_array_equal(g[name], ref[name][sl])


@pytest.mark.parametrize("name", list(CASES))
def test_counters_show_the_path_taken(exchanged, name):
    _, infos, _, _ = exchanged
    for info in infos:
        assert info["paths"][name] == {PATHS[name]: 1}


def test_mixed_ids_in_a_table_group_end_exact_on_the_psum_path(exchanged):
    table, infos, got, _ = exchanged
    rows = N // 2
    for info, g in zip(infos, got):
        ids = CASES["one_id" if info["model"] == 0 else "balanced_cap1"][0]
        sl = slice(info["data"] * rows, (info["data"] + 1) * rows)
        np.testing.assert_array_equal(g["mixed"], table[ids[sl]])
        # the rank that did not overflow followed the one that did, and
        # the ids differing took the gathered form
        assert info["paths"]["mixed"] == {"psum_gathered": 1}
