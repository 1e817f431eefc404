"""The port's package boundary and device rule.

repro_torch imports torch and numpy, never jax nor the reference package
``repro``; chip_smoke.py likewise.  With no card, a host input runs only when
the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_import_leaves_jax_out():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.core.epsm, "
        "repro_torch.kernels.epsmc.ops, repro_torch.kernels.multipattern.ops, repro_torch.obs, "
        "repro_torch.core.stream, repro_torch.approx, repro_torch.kernels.megascan.ops, "
        "repro_torch.kernels.approx.ops, repro_torch.core.automaton, "
        "repro_torch.kernels.acscan.ops, repro_torch.serve.query_plane, repro_torch.serve.server, "
        "repro_torch.dist, repro_torch.dist.fault_tolerance, repro_torch.dist.fault_injection, "
        "repro_torch.dist.sharding, repro_torch.dist.compat, repro_torch.launch.mesh, "
        "repro_torch.core.remote_source, repro_torch.core.shard_stream, repro_torch.core.distributed; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
        "assert not bad, bad"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_no_gpu_means_no_silent_cpu_run(monkeypatch):
    from repro_torch.core import epsm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        epsm.find(b"ab", b"b")
    assert epsm.find(b"ab", b"b", device="cpu").tolist() == [False, True]
