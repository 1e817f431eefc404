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
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{path.name} imports {mod}"


def test_import_leaves_jax_out():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.core.epsm, "
        "repro_torch.kernels.epsmc.ops, repro_torch.kernels.multipattern.ops, repro_torch.obs, "
        "repro_torch.core.stream, repro_torch.approx, repro_torch.kernels.megascan.ops, "
        "repro_torch.kernels.approx.ops, repro_torch.core.automaton, "
        "repro_torch.kernels.acscan.ops, repro_torch.serve.query_plane, repro_torch.serve.server, "
        "repro_torch.dist, repro_torch.dist.fault_tolerance, repro_torch.dist.fault_injection, "
        "repro_torch.dist.sharding, repro_torch.dist.compat, repro_torch.launch.mesh, "
        "repro_torch.core.remote_source, repro_torch.core.shard_stream, repro_torch.core.distributed, "
        "repro_torch.models.common, repro_torch.models.attention, repro_torch.models.moe, "
        "repro_torch.models.transformer, repro_torch.models.convert, repro_torch.configs, "
        "repro_torch.configs.shapes, repro_torch.configs.registry, repro_torch.configs.smollm_135m, "
        "repro_torch.configs.yi_9b, repro_torch.configs.minitron_4b, "
        "repro_torch.configs.phi3_5_moe_42b_a6_6b, repro_torch.configs.grok_1_314b, "
        "repro_torch.data.pipeline, repro_torch.serve.engine, repro_torch.launch.serve, "
        "repro_torch.train, repro_torch.train.optimizer, repro_torch.train.checkpoint, "
        "repro_torch.train.loop, repro_torch.launch.train, repro_torch.models.embedding, "
        "repro_torch.models.recsys, repro_torch.models.gnn, repro_torch.data.graph, "
        "repro_torch.data.recsys_data, repro_torch.configs.din, repro_torch.configs.dien, "
        "repro_torch.configs.bst, repro_torch.configs.dcn_v2, repro_torch.configs.gatedgcn, "
        "repro_torch.core.baselines, repro_torch.kernels.baselines, "
        "repro_torch.kernels.baselines.ops, repro_torch.kernels.baselines.ref, "
        "repro_torch.kernels.baselines.baselines, repro_torch.dist.compression, "
        "repro_torch.dist.embedding_exchange; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes')]; "
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


def test_serving_and_pipeline_entry_points_need_the_card_or_cpu(monkeypatch):
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import LMDataPipeline
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine, StopScanner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("smollm-135m")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for make in (
        lambda **kw: StopScanner([b"ab"], 1, 4, **kw),
        lambda **kw: ServeEngine(params, cfg, **kw),
        lambda **kw: LMDataPipeline([], seq_len=8, batch_size=1, blocklist=[b"abcd"], **kw),
        lambda **kw: tf.init_params(torch.Generator().manual_seed(0), cfg, **kw),
        lambda **kw: tf.make_cache(cfg, 1, 8, **kw),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        make(device="cpu")
    eng = ServeEngine(params, cfg, max_len=16, device="cpu")
    assert len(eng.generate([b"ab"], max_new_tokens=2)) == 1


def test_training_entry_points_need_the_card_or_cpu(monkeypatch, tmp_path):
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import TrainConfig, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("smollm-135m")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ckpt.save({"w": torch.ones(2)}, tmp_path, step=1)
    for call in (
        lambda: train(lambda p, b: 0.0, params, iter(()), TrainConfig(steps=0)),
        lambda: ckpt.restore({"w": torch.zeros(2)}, tmp_path),
        lambda: launch_train.main(["--reduced", "--steps", "0"]),
        lambda: launch_serve.main(["--max-new", "1"]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert float(ckpt.restore({"w": torch.zeros(2)}, tmp_path, device="cpu")[0]["w"][0]) == 1.0
    assert train(lambda p, b: 0.0, params, iter(()), TrainConfig(steps=0), device="cpu")[2] == []


def test_recsys_and_gnn_entry_points_need_the_card_or_cpu(monkeypatch):
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.data.recsys_data import make_batch
    from repro_torch.models import gnn, recsys
    from repro_torch.models.convert import gnn_params_from_numpy, recsys_params_from_numpy
    from repro_torch.train.loop import TrainConfig, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rcfg, gcfg = reduced_config("din"), reduced_config("gatedgcn")
    gen = lambda: torch.Generator().manual_seed(0)
    params = recsys.init_params(gen(), rcfg, device="cpu")
    gparams = gnn.init_params(gen(), gcfg, device="cpu")
    host = {k: v.numpy() if isinstance(v, torch.Tensor) else [{n: t.numpy() for n, t in d.items()}
                                                             for d in v]
            for k, v in params.items()}
    batch = make_batch(rcfg, 4, seed=0)
    user, cands = make_batch(rcfg, 1, seed=1, with_label=False), np.arange(5, dtype=np.int32)
    for call in (
        lambda **kw: recsys.init_params(gen(), rcfg, **kw),
        lambda **kw: gnn.init_params(gen(), gcfg, **kw),
        lambda **kw: recsys.serve_scores(params, rcfg, batch, **kw),
        lambda **kw: recsys.retrieval_scores(params, rcfg, user, cands, **kw),
        lambda **kw: recsys_params_from_numpy(host, rcfg, **kw),
        lambda **kw: train(lambda p, b: recsys.train_loss(p, rcfg, b), params, [batch],
                           TrainConfig(steps=1, log_every=1), log=lambda s: None, **kw),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn_params_from_numpy({}, gcfg)
    assert recsys.serve_scores(params, rcfg, batch, device="cpu").shape == (4,)
    assert gparams["layers"][0]["A"].device.type == "cpu"


def test_meshes_launcher_and_sharded_restore_need_the_card_or_cpu(monkeypatch, tmp_path):
    """With no card, a mesh, the mesh launcher and a restore onto a mesh run
    only when the caller asks for the CPU; a CPU mesh restores CPU
    DTensors.  No group is left behind."""
    import torch.distributed as dist

    from repro_torch.dist import compat
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: compat.make_mesh((1, 1), ("data", "model")),
                 lambda: lmesh.make_local_mesh(),
                 lambda: lmesh.make_production_mesh(),
                 lambda: compat.init_process_group(),
                 lambda: launch_train.main(["--reduced", "--steps", "1", "--batch", "2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        assert not dist.is_initialized()
    ckpt.save({"w": torch.arange(6.0).reshape(3, 2)}, tmp_path, step=2)
    try:
        mesh = lmesh.make_local_mesh(device="cpu")
        assert mesh.device_type == "cpu"
        shard = {"w": sh.NamedSharding(mesh, compat.P("data", None))}
        got, step = ckpt.restore({"w": torch.zeros(3, 2)}, tmp_path, shardings=shard)
        assert step == 2 and got["w"].to_local().device.type == "cpu"
        assert torch.equal(got["w"].to_local(), torch.arange(6.0).reshape(3, 2))
    finally:
        dist.destroy_process_group()
    launch_train.main(["--device", "cpu", "--reduced", "--steps", "1", "--batch", "2", "--seq", "32"])
    assert not dist.is_initialized()
