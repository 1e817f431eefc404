"""Helpers of the port's multi-rank tests: start N CPU processes as one gloo
group, with torchrun's environment, and collect what each rank wrote.

Each rank runs ``python -c CODE OUT_DIR`` with ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set, so
``repro_torch.dist.compat.init_process_group("cpu")`` joins the group;
one intra-op thread a rank.  A rank that fails or outlives the timeout
fails the caller, and none outlives the call.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code: str, world: int, out_dir, *args, timeout: float = 240.0) -> list:
    """Run ``code`` on ``world`` ranks; returns each rank's stdout."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "WORLD_SIZE": str(world), "RANK": str(rank),
               "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(out_dir), *map(str, args)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for rank, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {rank} of {world} outlived {timeout} s")
            assert proc.returncode == 0, f"rank {rank} of {world} exited {proc.returncode}:\n{err}"
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


@contextlib.contextmanager
def one_rank_group():
    """A gloo group of this process alone, destroyed on exit (so no later
    test in the process sees a group)."""
    import torch.distributed as dist

    assert not dist.is_initialized(), "a process group is already initialized"
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_reference(code: str, devices: int, *args, timeout: float = 300.0) -> str:
    """Run ``code`` (which imports jax and repro) in a subprocess with
    ``devices`` fake CPU devices; returns its stdout."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    res = subprocess.run([sys.executable, "-c", code, *map(str, args)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr
    return res.stdout
