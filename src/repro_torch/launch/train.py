"""Training launcher: LM training on one device (the card unless
``--device cpu``), with the EPSM-filtered data pipeline, periodic async
checkpoints, resume and the straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 50 --reduced --seq 128 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 3 --device cpu

The port's copy of ``repro.launch.train``.  The reference runs under a
device mesh; here the mesh is the one device, and ``--production-mesh``
raises (it needs 256 devices).  Parameters are drawn from seed 0.  The
last async checkpoint is waited for before the launcher returns.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.core.packing import resolve_device
from repro_torch.data import corpus
from repro_torch.data.pipeline import LMDataPipeline, VOCAB
from repro_torch.dist.fault_tolerance import StepWatchdog
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import AsyncSaver, batch_to, make_train_step
from repro_torch.train.optimizer import AdamWConfig, adamw_init


def main(argv=None):
    """Returns (params, opt_state) after the last step."""
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

    if args.production_mesh:
        make_production_mesh()
    dev = resolve_device(args.device)
    print(f"mesh: {{'data': 1, 'model': 1}} on {dev}")

    if args.reduced:
        cfg = dataclasses.replace(
            reduced_config(args.arch), vocab=VOCAB,
            q_chunk=args.seq, kv_chunk=args.seq, ce_chunk=args.seq,
        )
    else:
        cfg = dataclasses.replace(get_arch(args.arch).make_config(), vocab=VOCAB)
    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=20, total_steps=args.steps)

    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    opt_state = adamw_init(params)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start = ckpt.restore((params, opt_state), args.ckpt_dir, device=dev)
        print(f"resumed from step {start}")

    step_fn = make_train_step(lambda p, b: tf.train_loss(p, cfg, b), opt_cfg)
    docs = corpus.documents("english", 100_000, doc_len=4096, seed=0)
    pipe = LMDataPipeline(docs, seq_len=args.seq, batch_size=args.batch,
                          blocklist=[b"FORBIDDEN"], dedup=False, device=dev)
    wd = StepWatchdog(policy="log")
    saver = AsyncSaver(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    try:
        for step, batch in zip(range(start, args.steps), pipe):
            wd.start_step(step)
            params, opt_state, m = step_fn(params, opt_state, batch_to(batch, dev))
            wd.end_step()
            if step % 10 == 0:
                print(f"step {step}: loss={float(m['loss']):.4f}")
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.save((params, opt_state), step + 1, async_=True)
    finally:
        if saver:
            saver.wait()
    print("done;", f"{len(wd.events)} straggler events")
    return params, opt_state


if __name__ == "__main__":
    main()
