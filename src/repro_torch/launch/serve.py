"""Serving launcher: batched KV-cache decoding with EPSM stop strings, on
the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 4 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --ckpt-dir DIR

The port's copy of ``repro.launch.serve``: the model is the reduced
smollm-135m with random weights drawn from seed 0, or, with ``--ckpt-dir``,
the parameters of the newest checkpoint there (written by either package's
``train/checkpoint.py``, e.g. by ``launch.train --reduced``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import reduced_config
from repro_torch.core.packing import resolve_device
from repro_torch.data.pipeline import VOCAB
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adamw_init


def main(argv=None):
    """Returns (results, the served parameters, the restored step or None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to opt out")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        reduced_config("smollm-135m"), vocab=VOCAB,
        q_chunk=64, kv_chunk=64, ce_chunk=64,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(gen, cfg, device=dev)
    step = None
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (params, _), step = ckpt.restore((params, adamw_init(params)), args.ckpt_dir, device=dev)
        print(f"restored step {step}")

    eng = ServeEngine(params, cfg, max_len=256, device=dev)
    prompts = [f"request {i:02d} says ".encode() for i in range(args.requests)]
    t0 = time.perf_counter()
    results = eng.generate(
        prompts, max_new_tokens=args.max_new, temperature=0.7,
        stop_strings=[b". ", b"\n"],
    )
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in results)
    print(f"served {len(prompts)} requests on {dev}, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s)")
    for p, r in zip(prompts, results):
        print(f"  {p!r} -> {r.text[:40]!r} stopped_by={r.stopped_by!r}")
    return results, eng.params, step


if __name__ == "__main__":
    main()
