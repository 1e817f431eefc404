"""Training launcher: LM training over a device mesh (the card unless
``--device cpu``), with the EPSM-filtered data pipeline, periodic async
checkpoints, resume and the straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 50 --reduced --seq 128 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --reduced --steps 3 --batch 4 --seq 64 --device cpu

The port's copy of ``repro.launch.train``.  ``--production-mesh`` builds the
16x16 ("data", "model") mesh (256 ranks); otherwise the mesh holds every
rank of the group on "data": one when started alone, N under ``torchrun
--nproc-per-node N`` (gloo on the CPU; NCCL, with gloo for host tensors, on
cards).  Parameters and AdamW state are DTensors placed by
``dist.sharding.lm_param_specs`` / ``opt_state_specs`` under tp_sp, as
the reference (``make_step``'s ``strategy`` also takes zero_dp, which
shards them over the data axes); every rank runs the pipeline and takes its
rows of the global batch by ``lm_batch_specs``; gradients are averaged over
the data-parallel axes (``train.loop.make_mesh_train_step``).  The result is
the one-device run's: the token-mean loss and the MoE auxiliary loss (a
mean over token groups) average over ranks to the global batch's because
every rank holds the same number of rows and of whole MoE groups; a batch
whose MoE groups would span ranks raises ValueError.  A "model" axis of
more than one rank (tensor-parallel execution) raises NotImplementedError.
Resume restores the checkpoint onto the mesh (``restore(...,
shardings=)``); rank 0 writes checkpoints.  Parameters are drawn from seed
0.  The last async checkpoint is waited for before the launcher returns.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch, reduced_config
from repro_torch.core.packing import resolve_device
from repro_torch.data import corpus
from repro_torch.data.pipeline import LMDataPipeline, VOCAB
from repro_torch.dist import compat
from repro_torch.dist import sharding as sh
from repro_torch.dist.fault_tolerance import StepWatchdog
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import AsyncSaver, batch_to, make_mesh_train_step, whole
from repro_torch.train.optimizer import AdamWConfig, adamw_init


def check_moe_groups(cfg, mesh, batch: int, seq: int, strategy: str = "tp_sp") -> None:
    """Raise ValueError when a rank's rows would not hold whole MoE groups
    of the global batch (their routing, capacity and aux loss would then
    differ from the one-device run's)."""
    bdp = sh.lm_batch_specs("lm_train", mesh, batch, strategy)["tokens"][0]
    ranks = sh.axis_size(mesh, bdp)
    if not cfg.is_moe or ranks == 1:
        return
    group = min(cfg.moe_group, batch * seq)
    local = batch // ranks * seq
    if local % group:
        raise ValueError(f"{local} tokens a rank do not hold whole MoE groups of {group} tokens "
                         f"(batch {batch} x seq {seq} over {ranks} ranks)")


def make_step(cfg, mesh, batch: int, seq: int, opt_cfg: AdamWConfig, strategy: str = "tp_sp"):
    """The launcher's train step on ``mesh`` and the parameters' specs:
    (step, param_specs).  The loss runs on whole parameters and local rows,
    plain tensors, so it takes no ``constrain``: the activation table
    (``sh.lm_activation_table``) has DTensors to act on only under
    tensor-parallel execution, which is not ported."""
    if sh.axis_size(mesh, "model") > 1:
        raise NotImplementedError(
            "tensor-parallel execution on a 'model' axis of more than one rank is not ported")
    check_moe_groups(cfg, mesh, batch, seq, strategy)
    pspecs = sh.lm_param_specs(cfg, mesh, strategy)
    step = make_mesh_train_step(lambda p, b: tf.train_loss(p, cfg, b), opt_cfg, mesh,
                                sh.lm_batch_specs("lm_train", mesh, batch, strategy))
    return step, pspecs


def init_state(cfg, mesh, pspecs, device):
    """Parameters from seed 0 and fresh AdamW state, placed on the mesh."""
    params = tf.init_params(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    return (sh.distribute_tree(params, mesh, pspecs),
            sh.distribute_tree(adamw_init(params), mesh, sh.opt_state_specs(pspecs)))


def pipeline(seq: int, batch: int, device) -> LMDataPipeline:
    """The launcher's data: english documents through the EPSM-filtered
    pipeline, the same global batches on every rank."""
    docs = corpus.documents("english", 100_000, doc_len=4096, seed=0)
    return LMDataPipeline(docs, seq_len=seq, batch_size=batch, blocklist=[b"FORBIDDEN"],
                          dedup=False, device=device)


def main(argv=None):
    """Returns (params, opt_state) after the last step, whole on every rank."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (requires 256 devices)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to opt out")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    joined = not dist.is_initialized()  # a group this call starts, it ends
    try:
        return _run(args, dev)
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, dev):
    if args.production_mesh:
        mesh = make_production_mesh(device=dev)
    else:
        mesh = make_local_mesh(("data", "model"), device=dev)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"mesh: {compat.mesh_axes(mesh)} on {dev}")

    if args.reduced:
        cfg = dataclasses.replace(
            reduced_config(args.arch), vocab=VOCAB,
            q_chunk=args.seq, kv_chunk=args.seq, ce_chunk=args.seq,
        )
    else:
        cfg = dataclasses.replace(get_arch(args.arch).make_config(), vocab=VOCAB)
    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=20, total_steps=args.steps)

    step_fn, pspecs = make_step(cfg, mesh, args.batch, args.seq, opt_cfg)
    params, opt_state = init_state(cfg, mesh, pspecs, dev)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        shardings = (sh.tree_to_shardings(mesh, pspecs),
                     sh.tree_to_shardings(mesh, sh.opt_state_specs(pspecs)))
        (params, opt_state), start = ckpt.restore((params, opt_state), args.ckpt_dir,
                                                  shardings=shardings)
        say(f"resumed from step {start}")

    pipe = pipeline(args.seq, args.batch, dev)
    wd = StepWatchdog(policy="log")
    saver = AsyncSaver(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    try:
        for step, batch in zip(range(start, args.steps), pipe):
            wd.start_step(step)
            params, opt_state, m = step_fn(params, opt_state, batch_to(batch, dev))
            wd.end_step()
            if step % 10 == 0:
                say(f"step {step}: loss={float(m['loss']):.4f}")
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.save((params, opt_state), step + 1, async_=True)
    finally:
        if saver:
            saver.wait()
            dist.barrier()
    say("done;", f"{len(wd.events)} straggler events")
    return tree_map(whole, params), type(opt_state)(*tree_map(whole, tuple(opt_state)))

if __name__ == "__main__":
    main()
