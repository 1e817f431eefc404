"""repro_torch.core.distributed and the multi-process sharded scan.

Mirrors tests/test_distributed_scan.py and the in-process mesh case of
tests/test_shard_stream.py: the port's halo-exchange find/count over 1, 2,
3 and 8 CPU shards (and a 2 x 4 grid) equals repro.core.epsm.find on the
whole text, for m in {2, 9, 17, 33}, shards narrower than m - 1 included:
there the reference's own 8-device scan misses occurrences (ROADMAP §3,
reference fault 4; its probe runs in a subprocess, since jax fixes its
device count at start).  Then two processes join a gloo group through
init_stream_cluster and run ShardedStreamScanner; their merged counts and
positions equal a single StreamScanner's.  No tolerance.
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import epsm as Repsm
from repro_torch.core import engine as E
from repro_torch.core.distributed import make_distributed_count, make_distributed_find
from repro_torch.core.stream import StreamScanner
from repro_torch.launch.mesh import init_stream_cluster

from conftest import make_text

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _whole(text, pat) -> np.ndarray:
    return np.asarray(Repsm.find(jnp.asarray(text), jnp.asarray(pat)))


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_distributed_find_count_equal_the_whole_text(shards):
    rng = np.random.RandomState(40 + shards)
    for sigma in (2, 4):
        text = make_text(rng, 24 * 96, sigma)  # one length for every shard count: one jit a (m, n)
        for m in (2, 9, 17, 33):
            s = rng.randint(0, len(text) - m + 1)
            pat = text[s : s + m].copy()
            want = _whole(text, pat)
            assert want.sum() >= 1
            got = make_distributed_find([CPU] * shards)(text, pat)
            assert got.dtype == torch.bool and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"S={shards} m={m}")
            count = make_distributed_count([CPU] * shards)(torch.from_numpy(text), pat)
            assert count.dtype == torch.int32 and int(count) == int(want.sum())


def test_shards_narrower_than_the_halo_pin_reference_fault_4():
    """8 shards of 4 bytes: an occurrence of m = 9 or 17 spans three or more
    shards; the port takes the halo from every next shard it needs and
    gives the whole-text answer."""
    text = np.random.RandomState(1).randint(0, 2, size=32).astype(np.uint8)
    for m, s in ((3, 4), (5, 4), (9, 4), (17, 6), (32, 0)):
        pat = text[s : s + m].copy()
        want = _whole(text, pat)
        np.testing.assert_array_equal(make_distributed_find([CPU] * 8)(text, pat).numpy(), want)
        assert int(make_distributed_count([CPU] * 8)(text, pat)) == int(want.sum())
    grid = [[CPU] * 4, [CPU] * 4]  # a 2 x 4 grid, read row-major like ("pod", "data")
    for m in (3, 9, 20):
        pat = text[2 : 2 + m].copy()
        np.testing.assert_array_equal(make_distributed_find(grid)(text, pat).numpy(), _whole(text, pat))


REFERENCE_PROBE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np, jax.numpy as jnp
from repro.core import distributed, epsm
from repro.dist.compat import make_mesh
t = np.random.RandomState(1).randint(0, 2, size=32).astype(np.uint8)
p = t[4:13].copy()
mesh = make_mesh((8,), ("data",))
print(json.dumps({"whole": int(np.asarray(epsm.find(jnp.asarray(t), jnp.asarray(p))).sum()),
                  "mesh8": int(distributed.make_distributed_count(mesh, "data")(jnp.asarray(t), jnp.asarray(p)))}))
"""


def test_reference_mesh_misses_what_the_port_finds():
    """The reference call of fault 4: make_distributed_count over an
    8-device mesh, 4-byte shards, m = 9, counts 0 where the whole text has
    1; the port counts 1."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", REFERENCE_PROBE], capture_output=True, text=True,
                         timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    assert ref == {"whole": 1, "mesh8": 0}
    text = np.random.RandomState(1).randint(0, 2, size=32).astype(np.uint8)
    assert int(make_distributed_count([CPU] * 8)(text, text[4:13].copy())) == 1


def test_uneven_text_empty_pattern_and_no_card_raise(monkeypatch):
    with pytest.raises(ValueError, match="equal shards"):
        make_distributed_find([CPU] * 3)(np.zeros(10, np.uint8), b"ab")
    with pytest.raises(ValueError, match="empty pattern"):
        make_distributed_count([CPU] * 2)(np.zeros(10, np.uint8), b"")
    with pytest.raises(ValueError):
        make_distributed_find([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_distributed_find()


def test_init_stream_cluster_single_process_is_a_no_op():
    assert init_stream_cluster() == (0, 1)
    assert init_stream_cluster(num_processes=1) == (0, 1)
    with pytest.raises(ValueError):
        init_stream_cluster(num_processes=2)  # no coordinator nor process id


GLOO_CHILD = r"""
import json, sys
import numpy as np
import torch.distributed
from repro_torch.core import engine
from repro_torch.core.shard_stream import ShardedStreamScanner
from repro_torch.launch.mesh import init_stream_cluster

rank, coordinator = int(sys.argv[1]), sys.argv[2]
got = init_stream_cluster(coordinator, 2, rank)
assert got == (rank, 2) and init_stream_cluster(coordinator, 2, rank) == got
text = np.random.RandomState(77).randint(0, 4, size=50_000).astype(np.uint8)
pats = [text[100:108].copy(), text[9000:9003].copy(), text[30000:30032].copy()]
plans = engine.compile_patterns(pats, device="cpu")
out = {}
for steal in (False, True):
    sc = ShardedStreamScanner(plans, 5, 2048, devices=["cpu"] * 2, steal=steal)
    assert sc.n_shards == 5
    counts = sc.count_many(text)
    pos = ShardedStreamScanner(plans, None, 2048, devices=["cpu"] * 2, steal=steal).positions_many(text)
    out[str(steal)] = {"counts": counts.tolist(), "positions": [p.tolist() for p in pos]}
part = ShardedStreamScanner(plans, 4, 2048, devices=["cpu"], on_exhausted="partial").count_many(
    lambda s, e: (_ for _ in ()).throw(IOError("down")) if s >= 25_000 else text[s:e],
    total_bytes=len(text))
out["missing"] = [list(r) for r in part.missing]
print(json.dumps(out), flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()  # joins gloo's threads before exit
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_sharded_scan():
    """Two processes, one gloo group: each scans its shards (i % 2 ==
    rank), counts are all-reduced and positions all-gathered, and both
    ranks hold the single scanner's answer; the partial scan's missing
    ranges are gathered from both ranks."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    coordinator = f"127.0.0.1:{_free_port()}"

    def child(rank):  # run() kills a child that outlives its timeout
        return subprocess.run([sys.executable, "-c", GLOO_CHILD, str(rank), coordinator], env=env,
                              cwd=ROOT, capture_output=True, text=True, timeout=120)

    with ThreadPoolExecutor(2) as pool:
        done = list(pool.map(child, range(2)))
    outs = []
    for res in done:
        assert res.returncode == 0, res.stderr
        outs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    text = np.random.RandomState(77).randint(0, 4, size=50_000).astype(np.uint8)
    pats = [text[100:108].copy(), text[9000:9003].copy(), text[30000:30032].copy()]
    plans = E.compile_patterns(pats, device=CPU)
    want = StreamScanner(plans, 2048).count_many(text).tolist()
    want_pos = [p.tolist() for p in StreamScanner(plans, 2048).positions_many(text)]
    for got in outs:
        for steal in ("False", "True"):
            assert got[steal]["counts"] == want and got[steal]["positions"] == want_pos
        # shards 2 (rank 0) and 3 (rank 1) fail: both ranks report both
        assert got["missing"] == [[25_000, 50_000]]
