#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one CUDA card.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py [--seed S] [--phases a,b,...]

A bare run takes every phase and is the proof of the tree.  ``--phases``
takes a comma-separated selection (env and build always run); a phase that
reads another's result runs it too (NEEDS below), and the env line lists
what ran.  The kernels line then lists the kernels whose timing ran.

Phases, one JSON line each (more for main-multi and main-stream):

  env           torch / CUDA versions and the card's name and power limit;
  build         nvcc builds the eight sources from src/repro_torch/kernels/csrc,
                one nvcc per source, all at once;
  compare       each EPSM kernel's wrapper against its plain PyTorch version on
                the card, bit for bit (torch.equal on the whole mask: the
                outputs are exact);
  compare-multi the multi-pattern kernel against its plain version the same
                way: n, B, P, m, alphabet, flood, trailing 0x00, unaligned row
                views, LUT widths 17..22 bits, and end_min through the engine;
  compare-stream the megascan kernel against its plain version (the engine's
                exact count_many and the dense mismatch count, both plain
                PyTorch, with end_min) bit for bit: windows of 1 byte to
                64 MiB, L < window length, seam bounds prev_ov, a/b/c/x group
                mixes, m at the eligibility edges, a 16 MiB flood, patterns
                ending in 0x00, k in {1, 2, 127}, the main stream's own
                112-pattern set at the window the stream cuts, k = 0 and 1,
                and the private pattern-id tables: duplicate patterns, a 'b'
                plan with colliding fingerprints, 'a' and 'b' groups of 33
                and 512 patterns, 25 'a' groups of 512;
                every spec's smem_bytes held equal to the launcher's;
  compare-approx the approx kernel against its plain version: m 1..127, k 0..m,
                both paths (the pigeonhole filter and the first-word path,
                forced), LUT gate on and off, 40 and 70 patterns (W > 1),
                up to 27 pieces at W > 1 (the piece rows' shared memory
                held equal to the launcher's),
                flood, trailing 0x00, ragged lengths, 70000 rows, an
                unaligned row view, and end_min through the engine's
                k-mismatch mask route;
  compare-automaton the acscan kernel's two modes against their plain
                versions: automaton states and terminal-state histograms of
                tables in shared memory (genome, 2048 patterns), in L2
                (english, 8192) and in HBM (random m = 8, 10,000), uint16 and
                int32 entries, every variant forced where it fits (table and
                histogram placement, lanes a thread), a
                dictionary holding byte 0x00, max_m = 2000, n from 1 to
                1 MiB + 7 around the segment widths, ragged rows, end_min,
                and the main path's shapes (256 MiB, the (4096, 65536)
                batch, the stream's windows);
  main          epsm.find / count / positions with algo="auto" on device texts of
                1 GiB genome, 256 MiB protein and 256 MiB english, with the kernels'
                launch counters set to 0 just before and read just after;
  main-multi    the engine and multi-pattern API at full size (find_multi on a
                64 MiB genome, PatternSet.count_each on 256 MiB english with a
                64- and a 512-pattern set, PatternSet.blocked on a (4096, 65536)
                batch, multipattern_batched on an (8, 8 MiB) batch), each run
                between counter resets, each output checked against an
                independent path on the card afterwards;
  main-stream   streaming at full size from host memory: a 4 GiB genome through
                StreamScanner(plans) (megascan by default on the card) with 112
                patterns (a/b/c groups), against epsm.count on the text
                resident on the card, and 256 MiB of it at k = 1 ('x'
                groups) against the plain version window by window and the
                resident count_many(k=1), plus a
                fenced trace of 1 GiB (host assembly, copy, kernel); a 256 MiB
                gzip english source (traced the same way) through stream_count and
                PatternSet.contains_any_stream; epsm.positions auto-streaming a
                256 MiB host protein text against the resident call;
  main-approx   epsm.find(k=) on 256 MiB protein, PatternSet(k=1).count_each on
                64 MiB english and approx_batched on an (8, 8 MiB) batch, each
                against the plain version on the card;
  main-dict     dictionary-scale counting at 256 MiB: PatternSet.count_each and
                blocked (4096 x 65536 ragged) with 8192 english patterns,
                benchmarks/run.py's bench_dictionary (m = 8) at 10,000 and
                50,000 patterns on its average and adversarial textures, and
                stream_count of the english set over 1 GiB of host memory
                (megascan turns it away; the automaton takes every window);
                acscan counts-mode launches held equal to the automaton
                routes taken (and no states-mode launch), and
                counts to automaton=False plans on a 16 MiB slice and epsm.count;
  main-serve    a GrepServer on 127.0.0.1 over a QueryPlane on the card: a
                256 MiB english corpus, a 1 MiB one sent over the wire, 8
                connections sending 71 count, dictionary-scale any / count
                and match queries at once, each answer held against
                count_each alone, and the service trace through
                benchmarks/validate_trace.py;
  compare-shard ShardedStreamScanner (count_many, any_many, positions_many) with
                the main stream's 112 patterns and at k = 1 against one
                StreamScanner on the card, equal: texts of 40 bytes to 6 MiB,
                1, 2, 3, 8 and 13 shards (some narrower than the overlap, some
                empty), static and stealing at 1, 2 and 4 lanes with sheds;
                FaultPlan seeds 0-2 through FaultyRangeSource (read errors,
                truncations, latency spikes, shard crashes, all retried); one
                range that always fails under on_exhausted="partial"; a
                RemoteRangeReader over a faulty FakeObjectStore; and
                make_distributed_find / count with 8 shards on the card
                against epsm.find, m from 2 to 64, 8-byte shards included;
  main-shard    the main stream's 4 GiB host genome and 112 patterns through
                ShardedStreamScanner at 8 shards on the card, static and
                stealing at 2 and 4 lanes (and a fenced trace of the 4-lane
                run through benchmarks/validate_trace.py), 1 GiB through a
                seeded FaultPlan, 1 GiB through a RemoteRangeReader, positions
                of 14 patterns over 256 MiB, two child processes of this
                script in one gloo group scanning 512 MiB, and
                make_distributed_count over 1 GiB (one EPSMa/b/c launch a
                shard); every answer equal to a single StreamScanner's (or
                epsm.count), megascan launches equal to the dispatches, GB/s
                beside the single scanner's from the same run;
  compare-lm    the LM serving path on the card against its own run on the CPU
                (float32, TF32 off, parameters from one seeded init): full
                smollm-135m (byte vocab 257) and phi3.5-moe at full width
                cut to 1 layer (16 experts, top-2, tokens dropped past
                capacity at layer 0 on both sides, the dispatch equal), 4
                prompts of 128 bytes: prefill logits and caches, 8
                decode_steps and 8 decode_step_q8s (each side from its own
                int8 caches), logits within LM_TOL (float) or LM_TOL_Q8
                (int8) of the CPU's and equal greedy tokens wherever the
                top-2 gap is wider than that;
  main-lm       ServeEngine.generate at full smollm-135m width in bfloat16: 8
                requests of 512 english bytes, 256 new tokens, max_len 1024;
                greedy, then with each row's own 2-, 6- and 20-byte
                substrings as stops (every row stops at the step and on the
                stop an oracle names; one multipattern launch a step), then
                the 6-byte ones with a byte changed at stop_k = 1 (one approx
                launch a step), then twice sampled from one seed; prefill,
                decode and stop-scan ms (fenced spans), tokens/s, peak
                memory;
  main-pipeline LMDataPipeline on the card with 4096 english blocklist
                patterns of m 4..32 (141-142 a length): 128 MiB of english in
                documents of 512 B - 64 KiB plus 8 of 1-4 MiB (one megascan
                launch a window of contains_any_stream, over the set
                recompiled flat) and 64 near-duplicates, then 32 MiB at
                blocklist_k = 1, then 4 MiB of 512 B - 16 KiB documents with
                64 near-duplicates and dedup; every verdict equal to a host
                oracle, stats and batches equal to a host re-packing with an
                independent dedup, routes and launches;
  compare-train the LM training path on the card against its own run on the
                CPU (float32, TF32 off, parameters from one seeded init):
                full smollm-135m (byte vocab 257) and phi3.5-moe at full
                width cut to 1 layer (1.56 B parameters; one row of one
                repeated byte, so tokens drop past capacity on both sides,
                the dispatch equal), B = 2, S = 128: train_loss and every
                gradient leaf with remat on and off (the CPU's side runs
                once: remat does not change its answer), one AdamW update from
                the CPU's gradients, a 2-step make_train_step loss
                trajectory, each within TRAIN_TOL or ADAM_TOL of the CPU's;
                smollm's grad_accum = 2 against 1 on the card (the
                gradients adamw_update gets, and the loss);
  main-train    train.loop.train at full smollm-135m width in bfloat16, B = 8,
                S = 1024, 60 steps of AdamW over LMDataPipeline on the card
                (a 64-pattern english blocklist at blocklist_k = 1; two
                planted 1-4 MiB documents through megascan): async
                checkpoints every 20 steps, a fault injected at step 45, a
                second run resuming from step 40 (the restored state
                bit-equal to a copy held at step 40; 20 steps; step 60
                published, no .tmp_* left); verdicts equal to the host
                oracle, approx launches = filter dispatches x length groups,
                megascan launches = stream windows; tokens/s, a fenced
                step, a torch.profiler breakdown of 3 steps, peak memory
                with remat on and off, checkpoint save and restore times;
                then launch.train --reduced (30 steps, checkpoints every 10)
                and launch.serve --ckpt-dir restoring its step 30, the
                served parameters equal to the checkpoint's;
  main-dist     the multi-device layer on a (1, 1) ("data", "model") mesh of
                this process (a one-rank group: NCCL, gloo for host
                tensors): launch.train's step at full smollm-135m width in
                bfloat16, B = 8, S = 1024, 10 steps over the launcher's
                pipeline (its launches read: none, the engine's sparse
                route), against make_train_step
                from the same seed and batches (losses and state bit-equal,
                or the difference printed and held to TRAIN_TOL), step ms
                of each; every arch's spec tables on the mesh, smollm-135m,
                DCN-v2 and GatedGCN placed (each local shard the whole
                tensor); quantized_psum of smollm's float32 gradient tree
                (error under 1e-2 of a leaf's max, reconstruction within
                1e-6, equal to the CPU's run), its ms; the all-to-all
                exchange on DCN-v2's 10 M-row table with uniform, Zipf (1.3)
                and single ids at capacity factors 2 and 0.5 (each lookup
                equal to table[ids], both paths counted), ms a path; the
                mesh run's state saved and restored onto the mesh
                (bit-equal, s); two children of this script in one gloo
                group on the card (compression against the same sum formed
                here, the exchange over a table axis of two, 3 launcher
                steps of a reduced LM within DIST_TOL of the one-rank run)
                whose CPU zero_dp checkpoint restores onto the card's mesh
                bit for bit;
  compare-recsys DIN, DIEN, BST and DCN-v2 at their published widths (DCN-v2
                with its full dcn_default_vocabs tables, 577 M parameters)
                on the card against their own run on the CPU from one
                seeded init (float32, TF32 off), B = 256 from make_batch:
                logits and serve_scores within RECSYS_TOL of the CPU's max
                |logit|, train_loss and every gradient leaf within
                TRAIN_TOL of the leaf's max, retrieval_scores on 4096
                candidates within RECSYS_TOL;
  compare-gnn   GatedGCN at full width (16 layers, d_hidden 70) on the card
                against the CPU, remat on and off, on a Cora-sized
                synthetic graph (full_graph_sm), 128 batched molecules
                (graph readout) and one minibatch_lg subgraph (1024 seeds,
                fanout 15, 10, padding edges live) sampled from a
                Reddit-sized synthetic graph (232,965 nodes, ~114.5 M
                edges, built once): the float32 loss, and the loss and
                every gradient leaf of a float64 run, within TRAIN_TOL of
                the CPU's float64 run; the card's and the CPU's float32
                gradients against that run are printed (float32 alone, on
                the CPU, is further than TRAIN_TOL from it there);
  main-recsys   per recsys arch at full width: serve_scores at B = 512 (50
                fenced calls, p50 / p99) and B = 262,144 (5 calls, rows/s,
                peak memory), retrieval_scores of one user against 1 M
                candidates (in blocks of RETRIEVAL_BLOCK rows), held
                against serve_scores on a few hand-built rows; 20 steps of
                train.loop.train at B = 65,536 (AdamW at the reference's
                defaults, a fresh make_batch a step, the batches drawn
                first by HOST_THREADS threads): examples/s, a fenced
                step, losses, peak memory and a torch.profiler breakdown of
                one step; the trained BST and DCN-v2 states saved and
                restored bit-equal;
  main-gnn      GatedGCN training at full width: 10 steps on fresh
                minibatch_lg subgraphs (host sample ms beside the step),
                20 on fresh batched molecules, 20 full-batch on the
                Cora-sized graph: losses, steps/s, launches, syncs and idle
                share of a step, peak memory; one checkpoint saved and
                restored bit-equal; ogb_products is not run (one edge-state
                tensor alone is 17.3 GB; it needs four cards);
  fault7        PatternSet.contains_any_stream on the card with a 2056-byte
                pattern, a set megascan refuses: the reference's verdict
                (any occurrence, by bytes.find on the host) on a 4 MiB
                genome that holds it, one that does not, and one with it
                planted across a window seam: one acscan counts launch a window;
  compare-baselines the paper's baselines (core.baselines) on its three
                corpora at 4 MiB, m in the reference's FULL_M within each
                loop's limits, two extracted patterns a length: the four
                device loops (shift_or, kmp_dfa, hash3, bndm) through the
                entry points between counter resets (their main path), each
                mask bit-equal to the loop's plain version on the card (same
                seg), to packed_naive on the card and to epsm.find (the EPSM
                kernels); rabin_karp against packed_naive; the periodic text
                [7, 7, 9] tiled, 1-byte and (seg + 1)-byte texts, segments
                narrower than m, and the raises at m = 33 (SO) and 32 (BNDM);
  timing-baselines each loop at 4 MiB a corpus, m = 8 and 16: kernel ms
                (CUDA events, median of 20, queued behind a device sleep)
                and the entry point's call ms, plain ms, the bound (bytes,
                or the loop's counted steps times its operations a step),
                the skip loops' warp lane efficiency, epsm.find ms (queued,
                and a call's), packed_naive and rabin_karp fenced ms; then
                a sweep of seg from 4 to 4096 over m in {4, 8, 16, 32} and
                the best seg a loop beside the default;
  timing       median kernel times (CUDA events, queued behind a device sleep
                so they exclude the wrapper's host time) beside the plain
                versions' times and the bounds, and the times of epsm.find and
                epsm.count around the EPSM kernels; megascan at the stream's
                window (the kernels line) and on one 64 MiB window, with
                call_ms and its host share, the restated bound beside the
                first design's own-algorithm count (ops_per_position_pr13);
                approx beside its
                first-word path; acscan's
                states and counts modes beside both bounds, and every forced
                variant, at the main path's shapes: 256 MiB english (the
                counts mode there is the kernels line), genome and
                bench_dictionary's adversarial texture, the (4096, 65536)
                batch and a 4 MiB stream window with end_min.

Then one line {"kernels": [...]}, the card's name and power limit as
nvidia-smi prints them, and last {"ok": true, "device": {...}}.  Any failed
check raises, so the script exits nonzero and prints no result.  It also exits
nonzero when no CUDA device is available or the port's package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gzip
import io
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
GIB = 1 << 30
MIB = 1 << 20
DEVICE = "cuda"
MAIN_LENGTHS = (2, 3, 4, 8, 12, 16, 24, 32, 64)
PATTERNS_PER_LENGTH = 16
STREAM_LENGTHS = (3, 6, 8, 12, 16, 24, 32)  # 'a', three 'b' and three 'c' groups
DICT_LENGTHS = tuple(range(4, 16))  # the dictionary phases' pattern lengths (EPSMb)
KERNEL_SOURCES = {
    "epsma": ("src/repro_torch/kernels/csrc/epsma.cu", "src/repro/kernels/epsma/epsma.py:28"),
    "epsmb": ("src/repro_torch/kernels/csrc/epsmb.cu", "src/repro/kernels/epsmb/epsmb.py:43"),
    "epsmc": ("src/repro_torch/kernels/csrc/epsmc.cu", "src/repro/kernels/epsmc/epsmc.py:47"),
    "multipattern": ("src/repro_torch/kernels/csrc/multipattern.cu",
                     "src/repro/kernels/multipattern/multipattern.py:53"),
    "megascan": ("src/repro_torch/kernels/csrc/megascan.cu",
                 "src/repro/kernels/megascan/megascan.py:81"),
    "approx": ("src/repro_torch/kernels/csrc/approx.cu", "src/repro/kernels/approx/approx.py:55"),
    "acscan": ("src/repro_torch/kernels/csrc/acscan.cu", "src/repro/kernels/acscan/acscan.py:36"),
    # the baselines' device loops replace no Pallas kernel: the reference's
    # lax.scan / lax.while_loop over the whole text
    "shift_or": ("src/repro_torch/kernels/csrc/baselines.cu", "src/repro/core/baselines.py:86"),
    "kmp_dfa": ("src/repro_torch/kernels/csrc/baselines.cu", "src/repro/core/baselines.py:124"),
    "hash3": ("src/repro_torch/kernels/csrc/baselines.cu", "src/repro/core/baselines.py:179"),
    "bndm": ("src/repro_torch/kernels/csrc/baselines.cu", "src/repro/core/baselines.py:218"),
}
# H100 SXM integer rate on the CUDA cores (NVIDIA H100 whitepaper): 132 SMs x
# 64 INT32 lanes a clock x 1.98 GHz boost.  The compares, adds, shifts and
# multiply-adds counted in the megascan and approx operation bounds run there,
# not on the tensor cores.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Device clock cycles (~5 ms) a queued timing waits behind, longer than any
# wrapper's host time before its launch
QUEUE_CYCLES = 10_000_000
# Positions one warp owns in the megascan and approx kernels (32 lanes x 16),
# the span of their per-warp gates
WARP_SPAN = 512


def emit(obj):
    print(json.dumps(obj), flush=True)
    return obj


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Port:
    """The port's modules, imported once the card is known to be there."""

    def __init__(self):
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.core import epsm
        from repro_torch.data import corpus
        from repro_torch.kernels import _build
        from repro_torch.kernels.epsma.epsma import epsma_cuda
        from repro_torch.kernels.epsma.ref import epsma_ref
        from repro_torch.kernels.epsmb.epsmb import epsmb_cuda
        from repro_torch.kernels.epsmb.ref import epsmb_ref
        from repro_torch.kernels.epsmc.epsmc import epsmc_cuda
        from repro_torch.kernels.epsmc.ref import epsmc_filter_ref
        from repro_torch.core import engine, multipattern
        from repro_torch.kernels.multipattern import ops as mp_ops
        from repro_torch.kernels.multipattern.multipattern import multipattern_cuda
        from repro_torch.kernels.multipattern.ref import multipattern_batched_ref
        from repro_torch.core import stream
        from repro_torch.approx import counting
        from repro_torch.kernels.megascan import ops as ms_ops
        from repro_torch.kernels.megascan.megascan import megascan_cuda
        from repro_torch.kernels.megascan.ref import megascan_count_window_ref
        from repro_torch.kernels.approx import approx as ax_kernel
        from repro_torch.kernels.approx import ops as ax_ops
        from repro_torch.kernels.approx.approx import approx_cuda
        from repro_torch.kernels.approx.ref import approx_batched_ref
        from repro_torch.obs.recorder import Recorder
        from repro_torch.core import automaton
        from repro_torch.kernels.acscan.acscan import acscan_counts_cuda, acscan_cuda
        from repro_torch.kernels.acscan.ref import acscan_counts_ref, acscan_states_ref
        from repro_torch.serve import query_plane
        from repro_torch.serve.server import GrepClient, GrepServer
        from repro_torch.core import distributed, remote_source, shard_stream
        from repro_torch.dist import fault_injection, fault_tolerance, sharding
        from repro_torch.kernels.megascan import megascan as ms_kernel
        from repro_torch.launch import mesh
        from repro_torch import configs
        from repro_torch.data import pipeline
        from repro_torch.models import common as lm_common
        from repro_torch.models import moe as lm_moe
        from repro_torch.models import transformer as tf
        from repro_torch.serve import engine as serve_engine
        from repro_torch.launch import serve as launch_serve
        from repro_torch.launch import train as launch_train
        from repro_torch.train import checkpoint as train_ckpt
        from repro_torch.train import loop as train_loop
        from repro_torch.train import optimizer as train_opt
        from repro_torch.data import graph as graph_data
        from repro_torch.data import recsys_data
        from repro_torch.models import gnn, recsys
        from repro_torch.core import baselines
        from repro_torch.kernels.baselines import baselines as bl_kernel
        from repro_torch.kernels.baselines import ref as bl_plain
        from repro_torch.dist import compat, compression, embedding_exchange

        self.epsm, self.corpus, self.build = epsm, corpus, _build
        self.engine, self.mp, self.mp_ops = engine, multipattern, mp_ops
        self.mp_cuda, self.mp_plain = multipattern_cuda, multipattern_batched_ref
        self.stream, self.counting, self.Recorder = stream, counting, Recorder
        self.ms_ops, self.ms_plain = ms_ops, megascan_count_window_ref
        self.ax_ops, self.ax_cuda, self.ax_plain = ax_ops, approx_cuda, approx_batched_ref
        self.ax_kernel = ax_kernel
        self.automaton, self.acscan_cuda = automaton, acscan_cuda
        self.acscan_counts_cuda, self.acscan_counts_ref = acscan_counts_cuda, acscan_counts_ref
        self.acscan_states_ref = acscan_states_ref
        self.qp, self.GrepServer, self.GrepClient = query_plane, GrepServer, GrepClient
        self.shard_stream, self.distributed, self.remote = shard_stream, distributed, remote_source
        self.fi, self.ft, self.ms_kernel, self.mesh = fault_injection, fault_tolerance, ms_kernel, mesh
        self.sharding = sharding
        self.configs, self.pipeline, self.serve_engine = configs, pipeline, serve_engine
        self.tf, self.lm_moe, self.lm_common = tf, lm_moe, lm_common
        self.ckpt, self.loop, self.opt = train_ckpt, train_loop, train_opt
        self.launch_train, self.launch_serve = launch_train, launch_serve
        self.recsys, self.recsys_data, self.gnn, self.graph_data = recsys, recsys_data, gnn, graph_data
        self.baselines, self.bl_plain = baselines, bl_plain
        self.compat, self.compression, self.exchange = compat, compression, embedding_exchange
        self.wrappers = {"epsma": epsma_cuda, "epsmb": epsmb_cuda, "epsmc": epsmc_cuda,
                         "multipattern": multipattern_cuda, "megascan": megascan_cuda,
                         "approx": approx_cuda, "acscan": acscan_cuda,
                         "acscan_counts": acscan_counts_cuda,
                         "shift_or": bl_kernel.shift_or_cuda, "kmp_dfa": bl_kernel.kmp_dfa_cuda,
                         "hash3": bl_kernel.hash3_cuda, "bndm": bl_kernel.bndm_cuda}
        self.plain = {"epsma": epsma_ref, "epsmb": epsmb_ref, "epsmc": epsmc_filter_ref}

    def reset_launches(self) -> None:
        for wrapper in self.wrappers.values():
            wrapper.launches = 0

    def launches(self) -> dict:
        return {name: w.launches for name, w in self.wrappers.items()}


def random_text(torch, n: int, sigma: int, gen, alphabet=None):
    idx = torch.randint(0, sigma, (n,), generator=gen, device=DEVICE, dtype=torch.uint8)
    if alphabet is None:
        return idx
    return torch.tensor(list(alphabet), dtype=torch.uint8, device=DEVICE)[idx.long()]


def compare_kernels(torch, port: Port, seed: int, sizes, flood_n: int) -> dict:
    """Hold every kernel against its plain version, bit for bit; returns the
    number of cases and the largest |kernel - plain| per kernel."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    # m = 9000 reaches past the staged halo (8192 bytes) into global memory
    cases = {
        "epsma": [(m, {}) for m in (1, 2, 3, 5, 40, 9000)],
        "epsmb": [(m, {"fuse_verify": f}) for m in (4, 5, 8, 12, 15, 33, 9000)
                  for f in (True, False)],
        "epsmc": [(m, {}) for m in (16, 17, 24, 32, 64, 300, 5000, 9000)],
    }
    done = {name: 0 for name in cases}
    max_err = {name: 0 for name in cases}

    def hold(name, text, pattern, kw, label):
        got = port.wrappers[name](text, pattern, **kw)
        want = port.plain[name](text, pattern, **kw)
        torch.cuda.synchronize()
        if got.numel():
            err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
            max_err[name] = max(max_err[name], err)
        if not torch.equal(got, want):
            diff = torch.nonzero(got != want).flatten()[:8].tolist()
            raise RuntimeError(f"{name} {label} {kw}: kernel != plain at {diff}")
        done[name] += 1
        return got

    for n in sizes:
        for sigma in (2, 4, 256):
            text = random_text(torch, n, sigma, gen)
            for name, group in cases.items():
                for m, kw in group:
                    if m > n:
                        continue
                    s = int(torch.randint(0, n - m + 1, (1,), generator=gen, device=DEVICE))
                    hold(name, text, text[s : s + m].clone(), kw, f"n={n} sigma={sigma} m={m}")
            # an unaligned view of the text exercises the byte-wise staging path
            if n > 64:
                view = text[3:]
                for name, (m, kw) in (("epsma", cases["epsma"][2]), ("epsmb", cases["epsmb"][4]),
                                      ("epsmc", cases["epsmc"][1])):
                    hold(name, view, view[-m:].clone(), kw, f"unaligned n={n - 3} m={m}")
    # the flood: every start matches
    flood = torch.full((flood_n,), ord("A"), dtype=torch.uint8, device=DEVICE)
    for name, m in (("epsma", 3), ("epsmb", 8), ("epsmc", 32)):
        got = hold(name, flood, flood[:m].clone(), {}, f"flood n={flood_n} m={m}")
        check(int(got.sum()) == flood_n - m + 1, f"{name} flood count")
    # patterns ending in 0x00: one occurrence at the very end, and none where
    # only the zero padding past n would complete them
    for name, m in (("epsma", 3), ("epsmb", 8), ("epsmc", 24)):
        text = random_text(torch, 1_000_003, 255, gen) + 1  # bytes 1..255
        pat = text[-m:].clone()
        pat[-1] = 0
        text[-1] = 0
        got = hold(name, text, pat, {}, f"trailing 0x00 m={m}")
        check(bool(got[-m]), f"{name} trailing 0x00 occurrence")
        short = text[:-1].contiguous()  # now the pattern's last byte would lie past n
        got = hold(name, short, pat, {}, f"zero-padding trap m={m}")
        check(not bool(got[-m + 1 :].any()), f"{name} zero-padding trap")
    return {"cases": done, "max_abs_err": max_err}


def main_path(torch, np, port: Port, seed: int, genome_n: int, other_n: int) -> dict:
    """Drive epsm.find / count / positions on the card; returns launches."""
    epsm, corpus = port.epsm, port.corpus
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    english = np.tile(corpus.english(4 * MIB, seed), -(-other_n // (4 * MIB)))[:other_n]
    texts = {
        "genome": random_text(torch, genome_n, 4, gen, corpus.GENOME_ALPHABET),
        "protein": random_text(torch, other_n, 20, gen, corpus.PROTEIN_ALPHABET),
        "english": torch.from_numpy(english.copy()).to(DEVICE),
    }
    torch.cuda.synchronize()
    expected = {name: 0 for name in port.wrappers}
    port.reset_launches()
    per_text = {}
    for tname, text in texts.items():
        t0 = time.perf_counter()
        host = text.cpu().numpy()
        calls = 0
        for m in MAIN_LENGTHS:
            pats = corpus.extract_patterns(host, m, PATTERNS_PER_LENGTH, seed=m)
            starts = corpus.pattern_starts(len(host), m, PATTERNS_PER_LENGTH, seed=m)
            algo = epsm.select_algo(m)
            for i, (p_np, start) in enumerate(zip(pats, starts)):
                p = torch.from_numpy(p_np.copy()).to(DEVICE)
                mask = epsm.find(text, p)
                count = int(epsm.count(text, p))
                pos = epsm.positions(text, p)
                expected[algo] += 3
                calls += 3
                check(count >= 1, f"{tname} m={m} #{i}: count {count}")
                check(len(pos) == count == int(mask.sum()), f"{tname} m={m} #{i}: positions")
                if m >= 8:
                    j = np.searchsorted(pos, start)
                    check(j < len(pos) and pos[j] == start, f"{tname} m={m} #{i}: start {start}")
                if i < 2:
                    check(torch.equal(mask, port.plain[algo](text, p)),
                          f"{tname} m={m} #{i}: mask != plain")
        torch.cuda.synchronize()
        per_text[tname] = {"bytes": text.numel(), "calls": calls,
                           "seconds": round(time.perf_counter() - t0, 3)}
    launches = port.launches()
    emit({"phase": "main", "texts": per_text, "launches": launches, "expected": expected})
    check(launches == expected, f"launch counts {launches} != calls {expected}")
    check(all(launches[name] > 0 for name in port.plain), "a kernel of the path never launched")
    del texts
    return launches


def time_cuda(torch, fn, reps: int, queued: bool = False) -> float:
    """Median milliseconds of `reps` runs of fn, each between CUDA events.
    With ``queued`` the events and fn's launches are enqueued behind a
    ~5 ms device sleep, so the interval is the device's time alone and not
    the host's time to issue the launch (a kernel's own time; unqueued it
    is a call's time, the host's share included when the host is slower)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timing(torch, port: Port, seed: int, n: int) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    text = random_text(torch, n, 4, gen, port.corpus.GENOME_ALPHABET)
    bound_ms = 2 * n / HBM_BYTES_PER_S * 1e3
    rows = {}
    for name, m, kw in (("epsma", 3, {}), ("epsmb", 8, {}), ("epsmb", 12, {}),
                        ("epsmc", 16, {}), ("epsmc", 32, {})):
        s = int(torch.randint(0, n - m + 1, (1,), generator=gen, device=DEVICE))
        p = text[s : s + m].clone()
        kernel_ms = time_cuda(torch, lambda: port.wrappers[name](text, p, **kw), 20, queued=True)
        plain_ms = time_cuda(torch, lambda: port.plain[name](text, p, **kw), 5)
        # the entry points around the kernel: mask allocation, dispatch, and
        # for count the reduction over the mask
        find_ms = time_cuda(torch, lambda: port.epsm.find(text, p), 20)
        count_ms = time_cuda(torch, lambda: port.epsm.count(text, p), 20)
        row = {"phase": "timing", "kernel": name, "n": n, "m": m, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "library_ms": None, "GB_per_s": 2 * n / (kernel_ms * 1e-3) / 1e9,
               "find_ms": find_ms, "count_ms": count_ms}
        emit(row)
        rows.setdefault(name, row)  # the first length of each kernel goes in the summary
    return rows


def mp_bound_ms(B: int, n: int, P: int, m: int, kbits: int) -> float:
    """Least time of one multipattern launch: the B*n text bytes read, the
    B*P*n mask bytes written, the LUT bitset, anchors and lengths read once,
    over the memory rate (its integer operations are far below the card's
    rate, so bytes bound it)."""
    nw = m // 4 + (m % 4 != 0)
    moved = B * n + B * P * n + (1 << kbits) // 8 + 4 * P * nw + 4 * B
    return moved / HBM_BYTES_PER_S * 1e3


def compare_multipattern(torch, np, port: Port, seed: int) -> dict:
    """Hold the multi-pattern kernel against its plain version on the card, bit
    for bit, through the op, the launch wrapper and the engine route."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    engine = port.engine
    done = {"op": 0, "wrapper": 0, "engine": 0}
    max_err = 0

    def hold(got, want, label):
        nonlocal max_err
        torch.cuda.synchronize()
        if got.numel():
            max_err = max(max_err, int((got.to(torch.int8) - want.to(torch.int8)).abs().max()))
        if not torch.equal(got, want):
            diff = torch.nonzero(got != want)[:4].tolist()
            raise RuntimeError(f"multipattern {label}: kernel != plain at {diff}")

    def ragged(B, n):
        if B == 1:
            return torch.full((1,), n, dtype=torch.int32, device=DEVICE)
        return torch.tensor([n, max(0, n - 5), n // 2], dtype=torch.int32, device=DEVICE)

    def op_case(texts, ps, lengths, label):
        hold(port.mp_ops.multipattern_batched(texts, ps, lengths),
             port.mp_plain(texts, ps, lengths), label)
        done["op"] += 1

    shapes = ((1, 4), (7, 5), (32, 8), (200, 8), (7, 15), (32, 16), (7, 24), (1, 64), (1, 4096))
    for n in (1, 4095, 4096, 4097, 1_000_003):
        for sigma in (2, 4, 256):
            for B in (1, 3):
                texts = random_text(torch, B * n, sigma, gen).view(B, n)
                lengths = ragged(B, n)
                for P, m in shapes:
                    if m > n or (P == 200 and (B, sigma) != (1, 256)):
                        continue
                    starts = torch.randint(0, n - m + 1, (P,), generator=gen, device=DEVICE)
                    ps = torch.stack([texts[0, s : s + m] for s in starts.tolist()])
                    op_case(texts, ps, lengths, f"n={n} sigma={sigma} B={B} P={P} m={m}")
            if n > 64:
                # a row view offset by one byte: unaligned staging
                text = random_text(torch, n + 1, sigma, gen)
                view = text[1:]
                ps = torch.stack([view[-8:], view[:8]])
                op_case(view, ps, None, f"unaligned n={n} sigma={sigma}")
    # more rows than a grid's y extent (65535): the kernel loops over rows
    texts = random_text(torch, 70_000 * 37, 4, gen).view(70_000, 37)
    lengths = torch.randint(0, 38, (70_000,), generator=gen, device=DEVICE, dtype=torch.int32)
    op_case(texts, torch.stack([texts[5, 3:9], texts[69_999, 30:36]]), lengths, "B=70000")
    # bucketed plans whose fingerprint widens past 17 bits: P = 2100 (kbits 18)
    # through the op; through the wrapper, LUTs of 20 and 22 bits (each holding
    # its patterns' slots)
    text = random_text(torch, 4097, 256, gen)
    pats = np.unique(np.random.RandomState(seed).randint(0, 256, (4400, 8)).astype(np.uint8), axis=0)
    pats = torch.from_numpy(pats[:2100]).to(DEVICE)
    pats[::7] = torch.stack([text[s : s + 8] for s in range(0, 300 * 13, 13)])
    (plan,) = engine.compile_patterns_cached(list(pats.cpu().numpy()), automaton=False,
                                             device=DEVICE)
    check(plan.kbits == 18 and plan.slot_off is not None, f"P=2100 plan kbits {plan.kbits}")
    op_case(text, pats, None, "P=2100 kbits=18")
    anchors_np = plan.anchors.cpu().numpy().view(np.uint32)
    for kbits in (20, 22):
        lut = torch.rand(1 << kbits, generator=gen, device=DEVICE) < 0.001
        lut[torch.from_numpy(engine._np_window_fingerprint(anchors_np, kbits)).long().to(DEVICE)] = True
        got = port.mp_cuda(text[None, :], plan.anchors, 8, lut, kbits=kbits, use_lut=True)
        hold(got, port.mp_plain(text[None, :], pats), f"wrapper kbits={kbits}")
        done["wrapper"] += 1
    # the flood: every tile gated on, every start of 'A'*8 a match
    flood = torch.full((1, 1 << 20), ord("A"), dtype=torch.uint8, device=DEVICE)
    ps = flood[0, :8].repeat(2, 1)
    ps[1, 3] = ord("B")
    got = port.mp_ops.multipattern_batched(flood, ps)
    hold(got, port.mp_plain(flood, ps), "flood")
    check(int(got[0, 0].sum()) == (1 << 20) - 7 and not bool(got[0, 1].any()), "flood counts")
    done["op"] += 1
    # patterns ending in 0x00: one occurrence at the very end, none where only
    # the zero padding past n would complete them
    for m in (5, 8, 15, 24):
        text = random_text(torch, 1_000_003, 255, gen) + 1  # bytes 1..255
        text[-1] = 0
        pat = text[-m:].clone()[None, :]
        got = port.mp_ops.multipattern_batched(text, pat)
        hold(got, port.mp_plain(text, pat), f"trailing 0x00 m={m}")
        check(bool(got[0, 0, -m]), f"trailing 0x00 occurrence m={m}")
        short = text[:-1]
        got = port.mp_ops.multipattern_batched(short, pat)
        hold(got, port.mp_plain(short, pat), f"zero-padding trap m={m}")
        check(not bool(got.any()), f"zero-padding trap m={m}")
        done["op"] += 2
    # end_min through the engine's EPSMb mask route (kernel vs _dense_b)
    texts = random_text(torch, 3 * 100_003, 4, gen).view(3, 100_003)
    pats = [texts[0, s : s + m].cpu().numpy() for m in (4, 7, 12) for s in (11, 5000, 77777)]
    idx = engine.build_index(texts, torch.tensor([100_003, 60_000, 33]))
    plans = engine.compile_patterns(pats, device=DEVICE)
    for end_min in (None, 0, 50_000, 100_002):
        for plan in plans:
            hold(engine._match_group_b(idx, plan, None, end_min),
                 engine._dense_b(idx, plan, end_min), f"engine end_min={end_min} m={plan.m}")
            done["engine"] += 1
    return {"cases": done, "max_abs_err": max_err}


def main_multi(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """Drive the engine and the multi-pattern API at full size.  Each run sits
    between a counter reset and a counter read; its output is then checked
    against an independent path on the card (single-pattern epsm kernels, the
    per-group count path, the plain version), outside the counted window."""
    engine, mp, corpus = port.engine, port.mp, port.corpus
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    rs = np.random.RandomState(seed)
    launches = {name: 0 for name in port.wrappers}
    expected_mp = 0
    walls, routes = {}, {}

    def run(label, fn):
        torch.cuda.synchronize()
        port.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        for name, v in port.launches().items():
            launches[name] += v
        return out

    torch.cuda.reset_peak_memory_stats()
    # find_multi: 64 MiB genome, P = 16 patterns of each length
    genome = random_text(torch, sizes["genome"], 4, gen, corpus.GENOME_ALPHABET)
    host = genome.cpu().numpy()
    for m in (3, 8, 12, 24):
        ps = corpus.extract_patterns(host, m, 16, seed=m)
        masks = run(f"find_multi_m{m}", lambda: mp.find_multi(genome, ps))
        expected_mp += int(engine.EPSMA_MAX <= m < engine.EPSMB_MAX)
        for i in range(16):
            want = port.epsm.find(genome, torch.from_numpy(ps[i].copy()).to(DEVICE))
            check(torch.equal(masks[i], want), f"find_multi m={m} row {i} != epsm.find")
        check(int(masks.sum()) >= 16, f"find_multi m={m}: extracted patterns not found")
        del masks
    del genome
    # PatternSet.count_each: 256 MiB english, a 64-pattern mixed set (flat
    # plans) and a 512-pattern set (4 x 128: bucketed, no automaton)
    english = np.tile(corpus.english(4 * MIB, seed), -(-sizes["english"] // (4 * MIB)))
    english = torch.from_numpy(english[: sizes["english"]].copy()).to(DEVICE)
    host = english.cpu().numpy()
    mixed = [p for m in (2, 3, 5, 8, 12, 16, 24, 32)
             for p in corpus.extract_patterns(host, m, 8, seed=100 + m)]
    big = [p for m in (6, 8, 12, 20) for p in corpus.extract_patterns(host, m, 128, seed=200 + m)]
    sets = {"mixed64": mp.PatternSet(mixed, device=DEVICE), "dict512": mp.PatternSet(big, device=DEVICE)}
    check(all(p.slot_off is not None or p.c_slot_off is not None for p in sets["dict512"].plans),
          "the 512-pattern set must compile to bucketed plans")
    for name, ps in sets.items():
        pats = mixed if name == "mixed64" else big
        counts = run(f"count_each_{name}", lambda: ps.count_each(english))
        check(counts.dtype == torch.int32, "count_each dtype")
        routes[f"count_each_{name}"] = engine.route_probe(ps.index(english), ps.plans)
        for row, pid in enumerate(ps.order):
            want = port.epsm.count(english, torch.from_numpy(pats[pid].copy()).to(DEVICE))
            check(int(counts[row]) == int(want), f"count_each {name} row {row} != epsm.count")
        check(int(counts.min()) >= 1, f"count_each {name}: an extracted pattern not counted")
    # PatternSet.blocked on a (4096, 65536) padded batch with ragged lengths
    Bb, Lb = sizes["batch"]
    batch = english[: Bb * Lb].view(Bb, Lb).clone()
    del english
    lengths = torch.from_numpy(rs.randint(1, Lb + 1, size=Bb).astype(np.int32)).to(DEVICE)
    pos = torch.arange(Lb, device=DEVICE)[None, :]
    batch.masked_fill_(pos >= lengths[:, None].long(), 0)
    ps = sets["dict512"]
    verdicts = run("blocked_dict512", lambda: ps.blocked(batch, lengths))
    idx = ps.index(batch, lengths)
    routes["blocked_dict512"] = engine.route_probe(idx, ps.plans)
    want = engine.count_many(idx, ps.plans, shared=False).sum(-1) > 0
    check(torch.equal(verdicts, want), "blocked != count_many(shared=False) > 0")
    n_blocked = int(verdicts.sum())
    del batch, idx, want
    # multipattern_batched on an (8, 8 MiB) genome batch, gate on and off
    Bm, nm = sizes["mp_batch"]
    texts = random_text(torch, Bm * nm, 4, gen, corpus.GENOME_ALPHABET).view(Bm, nm)
    host = texts[0].cpu().numpy()
    for m in (8, 24):
        ps = torch.from_numpy(corpus.extract_patterns(host, m, 32, seed=300 + m)).to(DEVICE)
        masks = run(f"multipattern_batched_m{m}", lambda: port.mp_ops.multipattern_batched(texts, ps))
        expected_mp += 1
        check(torch.equal(masks, port.mp_plain(texts, ps)), f"multipattern_batched m={m} != plain")
        del masks
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "main-multi", "routes": routes, "blocked": n_blocked,
          "peak_bytes": peak, "peak_gib": peak / GIB})
    emit({"phase": "main-multi", "wall_s": walls, "launches": launches,
          "expected": {"multipattern": expected_mp}})
    check(launches["multipattern"] == expected_mp,
          f"multipattern launches {launches['multipattern']} != {expected_mp}")
    check(all(v == 0 for name, v in launches.items() if name != "multipattern"),
          f"an EPSM kernel launched on the engine path: {launches}")
    del texts
    return {"launches": launches["multipattern"], "wall_s": walls, "peak_bytes": peak}


def timing_multipattern(torch, port: Port, seed: int, B: int, n: int, P: int) -> dict:
    """The kernel at m = 8 (LUT gate on) and m = 24 (gate off) beside its
    plain version and bound; returns the m = 8 row."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)
    texts = random_text(torch, B * n, 4, gen, port.corpus.GENOME_ALPHABET).view(B, n)
    lengths = torch.full((B,), n, dtype=torch.int32, device=DEVICE)
    rows = []
    for m in (8, 24):
        starts = torch.randint(0, n - m + 1, (P,), generator=gen, device=DEVICE)
        ps = torch.stack([texts[0, s : s + m] for s in starts.tolist()])
        (plan,) = port.engine.compile_patterns(list(ps.cpu().numpy()), device=DEVICE)
        use_lut = plan.regime == "b"
        kernel_ms = time_cuda(torch, lambda: port.mp_cuda(
            texts, plan.anchors, m, plan.lut_any, kbits=plan.kbits, use_lut=use_lut,
            lengths=lengths), 20, queued=True)
        plain_ms = time_cuda(torch, lambda: port.mp_plain(texts, ps, lengths), 5)
        bound_ms = mp_bound_ms(B, n, P, m, plan.kbits)
        row = {"phase": "timing", "kernel": "multipattern", "B": B, "n": n, "P": P, "m": m,
               "use_lut": use_lut, "kbits": plan.kbits, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "library_ms": None, "GB_per_s": B * n * (P + 1) / (kernel_ms * 1e-3) / 1e9}
        emit(row)
        rows.append(row)
    return rows[0]


def genome_text(torch, n: int, gen):
    """An n-byte ACGT text made on the card, 256 MiB at a time (the alphabet
    lookup indexes with int64)."""
    out = torch.empty(n, dtype=torch.uint8, device=DEVICE)
    lut = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=DEVICE)
    for s in range(0, n, 256 * MIB):
        e = min(n, s + 256 * MIB)
        out[s:e] = lut[torch.randint(0, 4, (e - s,), generator=gen, device=DEVICE)]
    return out


def compare_megascan(torch, np, port: Port, seed: int) -> dict:
    """Hold the megascan kernel against its plain version (plain PyTorch:
    the engine's exact count_many and, for k > 0, the dense mismatch count,
    over the same window with length and end_min) bit for bit."""
    engine, ms = port.engine, port.ms_ops
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    rs = np.random.RandomState(seed + 3)
    done, max_err = {"cases": 0, "ineligible": 0, "smem_checked": 0}, 0

    lib = port.build.load("megascan")
    lib.megascan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.megascan_smem_bytes.restype = ctypes.c_longlong

    def spec_of(plans, k=None):
        spec = ms.build_mega_spec(plans, k=k)
        check(spec is not None, f"megascan spec None for m={[p.m for p in plans]} k={k}")
        # the spec's shared memory is the launcher's
        smem = lib.megascan_smem_bytes(spec.halo_back, spec.halo_fwd, spec.p_total)
        check(smem == spec.smem_bytes, f"smem {spec.smem_bytes} != launcher's {smem}")
        done["smem_checked"] += 1
        return spec

    def hold(window, plans, spec, L, ov, label):
        nonlocal max_err
        got = ms.megascan_count_window(window, plans, spec, length=L, prev_ov=ov)
        want = port.ms_plain(window, plans, k=spec.k, length=L, prev_ov=ov)
        torch.cuda.synchronize()
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want).flatten()[:4].tolist()
            raise RuntimeError(f"megascan {label}: kernel != plain at rows {bad}: "
                               f"{got[bad].tolist()} vs {want[bad].tolist()}")
        done["cases"] += 1
        return got

    def pats_from(host, lengths, per=2, sigma=4):
        pats = []
        for m in lengths:
            for _ in range(per):
                s = rs.randint(0, max(1, len(host) - m + 1))
                p = host[s : s + m]
                pats.append(p.copy() if len(p) == m else rs.randint(0, sigma, m).astype(np.uint8))
            pats.append(rs.randint(0, sigma, m).astype(np.uint8))
        return pats

    mixes = {0: (2, 3, 5, 8, 13, 16, 24, 40), 1: (2, 5, 8, 13, 16, 33)}
    for n in (1, 4095, 4096, 4097, 1_000_003, 64 * MIB):
        window = random_text(torch, n, 4, gen)
        host = window[: min(n, 1 << 20)].cpu().numpy()
        for k, lengths in mixes.items():
            plans = engine.compile_patterns(pats_from(host, lengths), k=k, device=DEVICE)
            spec = spec_of(plans, k if k else None)
            check({g.kind for g in spec.groups} == ({"x"} if k else {"a", "b", "c"}),
                  f"group kinds {spec.groups}")
            for L in sorted({n, max(0, n - 37)}):
                for ov in sorted({0, 1, 13, 31, 100, max(0, L - 5)}):
                    hold(window, plans, spec, L, ov, f"n={n} L={L} ov={ov} k={k}")
    # the main stream's own set (16 patterns at each of STREAM_LENGTHS) at
    # the window its scanner cuts, seam bounds up to its overlap and near L
    host = genome_text(torch, MIB, gen).cpu().numpy()
    pats = [p for m in STREAM_LENGTHS for p in port.corpus.extract_patterns(host, m, 16, seed=400 + m)]
    for k in (0, 1):
        plans = engine.compile_patterns(pats, k=k, device=DEVICE)
        sc = port.stream.StreamScanner(plans, "auto", k=k or None)
        spec = spec_of(plans, k or None)
        n = sc.window_bytes
        window = genome_text(torch, n, gen)
        for i, s in enumerate(range(4096 - 20, n - 64, n // 7)):  # across tile edges
            p = pats[(17 * i) % len(pats)]
            window[s : s + len(p)] = torch.from_numpy(p.copy()).to(DEVICE)
        for L in (n, n - 37):
            for ov in (0, 13, sc.overlap, L - 5):
                hold(window, plans, spec, L, ov, f"stream set n={n} L={L} ov={ov} k={k}")
    # m at the eligibility edges: 'x' up to m = 4093 (4096 - 3); 'c' up to
    # stride + m = 4095 (m = 2055; no m gives exactly 4096, m = 2056 gives 4104)
    n = 1_000_003
    window = random_text(torch, n, 4, gen)
    host = window.cpu().numpy()
    for k, lengths in ((1, (4093,)), (0, (2055,)), (2, (4000, 2055))):
        plans = engine.compile_patterns(pats_from(host, lengths, per=1), k=k, device=DEVICE)
        spec = spec_of(plans, k if k else None)
        for L, ov in ((n, 0), (n - 1000, 4092), (n, n - 5000)):
            hold(window, plans, spec, L, ov, f"edge m={lengths} k={k} L={L} ov={ov}")
    for k, lengths in ((1, (4094,)), (0, (2056,)), (128, (8,))):
        plans = engine.compile_patterns(pats_from(host, lengths, per=1), device=DEVICE)
        check(ms.build_mega_spec(plans, k=k or None) is None, f"m={lengths} k={k} must be ineligible")
        done["ineligible"] += 1
    # k in {1, 2, 127} over mixed lengths, and budgets of m or more
    for k, lengths in ((1, (3, 7, 12, 20)), (2, (4, 9, 31)), (127, (5, 16, 130, 200))):
        plans = engine.compile_patterns(pats_from(host, lengths), k=k, device=DEVICE)
        spec = spec_of(plans)
        for ov in (0, 13, 777):
            hold(window, plans, spec, n - 3, ov, f"k={k} ov={ov}")
    # the flood: every start of 'A' * m matches
    flood = torch.full((16 * MIB,), ord("A"), dtype=torch.uint8, device=DEVICE)
    fp = [b"AAA", b"A" * 8, b"A" * 12, b"A" * 24, b"AAAAAAAB", b"B" + b"A" * 23]
    for k in (0, 1):
        plans = engine.compile_patterns(fp, k=k, device=DEVICE)
        spec = spec_of(plans, k if k else None)
        got = hold(flood, plans, spec, 16 * MIB, 0, f"flood k={k}")
        want = {b"AAA": 16 * MIB - 2, b"A" * 8: 16 * MIB - 7}
        order = engine.plan_order(plans)
        for row, pid in enumerate(order):
            if fp[pid] in want:
                check(int(got[row]) == want[fp[pid]], f"flood count {fp[pid]!r} k={k}")
    # patterns ending in 0x00 at the very end of the window: counted with
    # L = n, and never where only the zero padding past L would complete them
    text = random_text(torch, 1_000_003, 255, gen) + 1  # bytes 1..255
    text[-1] = 0
    host = text.cpu().numpy()
    zpats = [host[-m:].copy() for m in (3, 8, 24)]
    for k in (0, 1):
        plans = engine.compile_patterns(zpats, k=k, device=DEVICE)
        spec = spec_of(plans, k if k else None)
        full = hold(text, plans, spec, text.numel(), 0, f"trailing 0x00 k={k}")
        check(int(full.min()) >= 1, f"trailing 0x00 occurrence k={k}")
        # L = n - 1: the last byte is now the window's zero padding
        trap = hold(text, plans, spec, text.numel() - 1, 0, f"zero-padding trap k={k}")
        if k == 0:
            check(int((full - trap).min()) == 1, "zero-padding trap: the end occurrence counted")
    # the private pattern-id tables: duplicate patterns, a 'b' plan whose
    # fingerprints collide (no lut_pid: the private bitmask), 'a' groups of
    # 33 and 512 patterns (W = 2 and 16) and 'b' groups of 512, 25 copies
    # of the 512-pattern 'a' plan; n % 4096 != 0, L < n and ov > 0
    n = 1_000_003
    window = random_text(torch, n, 16, gen)
    host = window.cpu().numpy()
    grams = np.unique(np.lib.stride_tricks.sliding_window_view(host[:200_000], 3), axis=0)
    words = np.unique(np.lib.stride_tricks.sliding_window_view(host[:200_000], 7), axis=0)
    dup = pats_from(host, (2, 3, 6, 9, 16), per=3, sigma=16)
    dup += [dup[0], dup[4], dup[4], dup[8], dup[13]]
    sets = {
        "duplicates": (engine.compile_patterns(dup, device=DEVICE), None),
        "nondistinct_b": (engine.compile_patterns(pats_from(host, (5, 7, 12), per=40, sigma=16),
                                                  kbits=6, device=DEVICE), None),
        "a33_b33": (engine.compile_patterns(list(grams[rs.permutation(len(grams))[:33]])
                                            + list(words[:33]), device=DEVICE), None),
        "a512_b512": (engine.compile_patterns(list(grams[rs.permutation(len(grams))[:512]])
                                              + list(words[rs.permutation(len(words))[:512]]),
                                              automaton=False, device=DEVICE), None),
    }
    a512 = [p for p in sets["a512_b512"][0] if p.m == 3]
    sets["a512_x25"] = (a512 * 25, None)  # 25 'a' tables of 8 KB, 12,800 counters
    check(any(not p.distinct and p.m > 3 for p in sets["nondistinct_b"][0]), "no colliding 'b' plan")
    check(sets["a512_b512"][0][1].lut_pid is None, "the 512-pattern 'b' plan is bucketed")
    for label, (plans, _) in sets.items():
        spec = spec_of(plans)
        for L, ov in ((n, 0), (n - 37, 13), (n - 4096, 777), (n, n - 100_000)):
            hold(window, plans, spec, L, ov, f"{label} L={L} ov={ov}")
        done[label] = 1
    return {"cases": done, "max_abs_err": max_err}


def compare_approx(torch, np, port: Port, seed: int) -> dict:
    """Hold the approx kernel against its plain version on the card, bit for
    bit, through the op (gate as the plan gives it) and the launch wrapper
    (gate forced on and off)."""
    engine = port.engine
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 4)
    done, max_err = {"op": 0, "wrapper": 0, "engine": 0, "pieces": 0}, 0

    def hold(got, want, label):
        nonlocal max_err
        torch.cuda.synchronize()
        if got.numel():
            max_err = max(max_err, int((got.to(torch.int8) - want.to(torch.int8)).abs().max()))
        if not torch.equal(got, want):
            diff = torch.nonzero(got != want)[:4].tolist()
            raise RuntimeError(f"approx {label}: kernel != plain at {diff}")

    def ragged(B, n):
        if B == 1:
            return torch.full((1,), n, dtype=torch.int32, device=DEVICE)
        return torch.tensor([n, max(0, n - 5), n // 2], dtype=torch.int32, device=DEVICE)

    def wrapper_case(texts, ps, k, lengths, label):
        """The rule's path, and the first-word path forced, gate on and off."""
        (plan,) = engine.compile_patterns(list(ps.cpu().numpy()), k=max(1, min(k, 2)),
                                          automaton=False, device=DEVICE)
        luts = [None]
        if plan.relaxed_lut is not None and k <= plan.k:
            luts.append(plan.relaxed_lut)
        want = port.ax_plain(texts, ps, k, lengths)
        P, m = ps.shape
        for lut in luts:
            for forced in (None, False):
                got = port.ax_cuda(texts, plan.patterns, plan.anchors, k, lut, kbits=plan.kbits,
                                   lengths=lengths, _pieces=forced)
                hold(got, want, f"{label} gate={lut is not None} pieces={forced}")
                done["wrapper"] += 1
                done["pieces"] += forced is None and port.ax_kernel.use_pieces(m, k, P)

    for n in (1, 4095, 4097, 1_000_003):
        for sigma in (4, 256):
            for B in (1, 3):
                texts = random_text(torch, B * n, sigma, gen).view(B, n)
                lengths = ragged(B, n)
                for m in (1, 3, 4, 5, 16, 127):
                    if m > n:
                        continue
                    starts = torch.randint(0, n - m + 1, (4,), generator=gen, device=DEVICE)
                    ps = torch.stack([texts[0, s : s + m] for s in starts.tolist()])
                    ps[1, m // 2] ^= 1  # one mismatch
                    for k in sorted({0, 1, 2, 3, m}):
                        label = f"n={n} sigma={sigma} B={B} m={m} k={k}"
                        hold(port.ax_ops.approx_batched(texts, ps, k, lengths),
                             port.ax_plain(texts, ps, k, lengths), label)
                        done["op"] += 1
                        if n == 1_000_003 and B == 3:
                            wrapper_case(texts, ps, k, lengths, label)
            if n > 64:
                text = random_text(torch, n + 1, sigma, gen)
                view = text[1:]  # a row view offset by one byte: unaligned staging
                ps = torch.stack([view[-8:], view[:8]])
                hold(port.ax_ops.approx_batched(view, ps, 1), port.ax_plain(view, ps, 1),
                     f"unaligned n={n}")
                done["op"] += 1
    # W > 1: 40 and 70 patterns (two and three bitmask words), both paths,
    # k = 0..3, ragged rows
    n = 1_000_003
    texts = random_text(torch, 3 * n, 4, gen).view(3, n)
    lengths = ragged(3, n)
    for P, m in ((40, 16), (70, 24), (40, 13)):
        starts = torch.randint(0, n - m + 1, (P,), generator=gen, device=DEVICE).tolist()
        ps = torch.stack([texts[i % 3, s : s + m] for i, s in enumerate(starts)])
        ps[1::3, m // 2] ^= 1
        for k in (0, 1, 2, 3):
            wrapper_case(texts, ps, k, lengths, f"W>1 P={P} m={m} k={k}")
            hold(port.ax_ops.approx_batched(texts, ps, k, lengths),
                 port.ax_plain(texts, ps, k, lengths), f"W>1 op P={P} m={m} k={k}")
            done["op"] += 1
    # W > 1 with many pieces: the piece rows past 48 KB of shared memory, at
    # the rule's edge (27 pieces of m = 127 fit, 28 do not); the launcher's
    # shared memory is the rule's
    lib = port.build.load("approx")
    lib.approx_pieces_smem_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    lib.approx_pieces_smem_bytes.restype = ctypes.c_longlong
    for P, m, k in ((40, 64, 7), (40, 127, 26), (40, 127, 27), (32, 127, 30)):
        want_smem = port.ax_kernel.pieces_smem_bytes(m, k, P)
        check(lib.approx_pieces_smem_bytes(m, k, P) == want_smem,
              f"approx smem P={P} m={m} k={k}: {want_smem} != launcher's")
        check(port.ax_kernel.use_pieces(m, k, P) == (k != 27), f"approx rule P={P} m={m} k={k}")
        starts = torch.randint(0, n - m + 1, (P,), generator=gen, device=DEVICE).tolist()
        ps = torch.stack([texts[i % 3, s : s + m] for i, s in enumerate(starts)])
        ps[1::3, m // 2] ^= 1
        wrapper_case(texts, ps, k, lengths, f"many pieces P={P} m={m} k={k}")
    check(done["pieces"] > 0, "no compare case took the pigeonhole filter")
    # more rows than a grid's y extent (65535): the kernel loops over rows
    texts = random_text(torch, 70_000 * 37, 4, gen).view(70_000, 37)
    lengths = torch.randint(0, 38, (70_000,), generator=gen, device=DEVICE, dtype=torch.int32)
    ps = torch.stack([texts[5, 3:8], texts[69_999, 30:35]])
    hold(port.ax_ops.approx_batched(texts, ps, 1, lengths), port.ax_plain(texts, ps, 1, lengths),
         "B=70000")
    done["op"] += 1
    # the flood: every start of 'A' * 16 within k of patterns with j changes
    flood = torch.full((1, 16 * MIB), ord("A"), dtype=torch.uint8, device=DEVICE)
    ps = flood[0, :16].repeat(3, 1)
    ps[1, 5] = ord("B")
    ps[2, 1] = ps[2, 9] = ord("C")
    for k in (1, 2):
        got = port.ax_ops.approx_batched(flood, ps, k)
        hold(got, port.ax_plain(flood, ps, k), f"flood k={k}")
        counts = got[0].sum(-1).tolist()
        check(counts == [16 * MIB - 15, 16 * MIB - 15, (16 * MIB - 15) * (k == 2)],
              f"flood counts k={k}: {counts}")
        done["op"] += 1
    # patterns ending in 0x00: found at the very end, never completed by the
    # zero padding past n
    for m in (3, 5, 16):
        text = random_text(torch, 1_000_003, 255, gen) + 1
        text[-1] = 0
        pat = text[-m:].clone()[None, :]
        pat[0, 0] ^= 1  # one mismatch, within k = 1
        got = port.ax_ops.approx_batched(text, pat, 1)
        hold(got, port.ax_plain(text, pat, 1), f"trailing 0x00 m={m}")
        check(bool(got[0, 0, -m]), f"trailing 0x00 occurrence m={m}")
        short = text[:-1]
        got = port.ax_ops.approx_batched(short, pat, 1)
        hold(got, port.ax_plain(short, pat, 1), f"zero-padding trap m={m}")
        check(not bool(got[0, 0, -m + 1 :].any()), f"zero-padding trap m={m}")
        done["op"] += 2
    # end_min through the engine's k-mismatch mask route (kernel vs plain)
    texts = random_text(torch, 3 * 100_003, 4, gen).view(3, 100_003)
    pats = [texts[0, s : s + m].cpu().numpy() for m in (3, 7, 12) for s in (11, 5000, 77777)]
    idx = engine.build_index(texts, torch.tensor([100_003, 60_000, 33]))
    for k in (1, 2):
        for plan in engine.compile_patterns(pats, k=k, device=DEVICE):
            for end_min in (None, 0, 50_000, 100_002):
                hold(port.counting.match_group_approx(idx, plan, k, end_min),
                     port.counting._dense_match_approx(idx, plan, k, end_min),
                     f"engine k={k} m={plan.m} end_min={end_min}")
                done["engine"] += 1
    return {"cases": done, "max_abs_err": max_err}


def windows_of(n: int, window_bytes: int, step: int) -> int:
    """Windows a StreamScanner emits for an n-byte source."""
    return 0 if n == 0 else 1 + -(-max(0, n - window_bytes) // step)


def stream_genome(torch, port: Port, gen, n: int):
    """The stream phases' genome: n ACGT bytes made on the card, their host
    copy, and 112 patterns extracted from it (16 at each STREAM_LENGTHS m:
    one 'a', three 'b' and three 'c' megascan groups)."""
    text = genome_text(torch, n, gen)
    host = text.cpu().numpy()
    pats = [p for m in STREAM_LENGTHS for p in port.corpus.extract_patterns(host, m, 16, seed=400 + m)]
    return text, host, pats


def plain_stream_counts(torch, port: Port, text, plans, k: int, overlap: int, piece: int):
    """The megascan plain version over a text resident on the card, cut into
    windows of ``piece`` new bytes as a stream cuts it (each window re-reads
    ``overlap`` bytes and counts only occurrences ending in its new bytes)."""
    total = None
    for s in range(0, text.numel(), piece):
        lo = max(0, s - overlap)
        c = port.ms_plain(text[lo : s + piece], plans, k=k, prev_ov=s - lo)
        total = c if total is None else total + c
    return total


def main_stream(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """Streaming at full size from host memory, each run between a counter
    reset and a counter read, each output checked afterwards against the
    counts on a text resident on the card."""
    engine, stream, corpus, epsm = port.engine, port.stream, port.corpus, port.epsm
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    out = {}
    launches = {name: 0 for name in port.wrappers}

    def run(label, fn):
        torch.cuda.synchronize()
        port.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[label] = {"wall_s": time.perf_counter() - t0, "launches": port.launches()}
        for name, v in port.launches().items():
            launches[name] += v
        return res

    # -- the genome: 112 patterns (16 at each m), planted across the first 16 seams
    n = sizes["genome"]
    text, host, pats = stream_genome(torch, port, gen, n)
    plans = engine.compile_patterns(pats, device=DEVICE)
    sc = stream.StreamScanner(plans, "auto")
    check(sc.spec is not None, "build_mega_spec is None for the genome plan set")
    check({g.kind for g in sc.spec.groups} == {"a", "b", "c"}, f"groups {sc.spec.groups}")
    for w in range(1, 17):  # straddle the end of window w - 1's new bytes
        p = pats[(7 * w) % len(pats)]
        s = w * sc.step_bytes + sc.overlap - len(p) // 2
        host[s : s + len(p)] = p
        text[s : s + len(p)] = torch.from_numpy(p.copy()).to(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counts = run("genome", lambda: sc.count_many(host))
    rise = torch.cuda.max_memory_allocated() - base
    n_win = windows_of(n, sc.window_bytes, sc.step_bytes)
    for row, pid in enumerate(sc.order):
        want = int(epsm.count(text, torch.from_numpy(pats[pid].copy()).to(DEVICE)))
        check(int(counts[row]) == want, f"genome stream row {row} (m={len(pats[pid])}): "
                                        f"{int(counts[row])} != resident {want}")
    ms_launches = out["genome"]["launches"]["megascan"]
    check(sc.dispatch_count == n_win == ms_launches,
          f"dispatch_count {sc.dispatch_count}, windows {n_win}, megascan launches {ms_launches}")
    check(rise < GIB, f"device memory rose by {rise} bytes over the scan")
    emit({"phase": "main-stream", "run": "genome", "bytes": n, "patterns": len(pats),
          "chunk_bytes": sc.chunk_bytes, "window_bytes": sc.window_bytes, "windows": n_win,
          "dispatch_count": sc.dispatch_count, "megascan_launches": ms_launches,
          "device_bytes_per_chunk": sc.device_bytes_per_chunk, "memory_rise_bytes": rise,
          "wall_s": out["genome"]["wall_s"], "GB_per_s": n / out["genome"]["wall_s"] / 1e9,
          "counts_total": int(counts.sum(dtype=np.int64))})
    emit(traced_scan(torch, port, "genome_traced", plans, host[: sizes["traced"]],
                     chunk_bytes=sc.chunk_bytes))
    # -- k = 1 over 256 MiB of the genome: 'x' groups
    nk = sizes["kmismatch"]
    plans1 = engine.compile_patterns(pats, k=1, device=DEVICE)
    sc1 = stream.StreamScanner(plans1, "auto", k=1)
    check(sc1.spec is not None and {g.kind for g in sc1.spec.groups} == {"x"},
          "k = 1 plan set must be eligible with 'x' groups only")
    counts1 = run("genome_k1", lambda: sc1.count_many(host[:nk]))
    want1 = plain_stream_counts(torch, port, text[:nk], plans1, 1, sc1.overlap, 32 * MIB)
    check(np.array_equal(counts1, want1.cpu().numpy()), "k = 1 stream != plain version")
    resident1 = engine.count_many(engine.build_index(text[:nk]), plans1, k=1)[0]
    check(torch.equal(resident1, want1), "k = 1 resident count_many != plain version")
    n_win1 = windows_of(nk, sc1.window_bytes, sc1.step_bytes)
    check(sc1.dispatch_count == n_win1 == out["genome_k1"]["launches"]["megascan"],
          "k = 1 dispatches != windows != megascan launches")
    emit({"phase": "main-stream", "run": "genome_k1", "bytes": nk, "windows": n_win1,
          "wall_s": out["genome_k1"]["wall_s"], "GB_per_s": nk / out["genome_k1"]["wall_s"] / 1e9,
          "counts_total": int(counts1.sum(dtype=np.int64))})
    del text
    # -- a gzip english source of several members, and contains_any_stream
    ne = sizes["english"]
    english = np.tile(corpus.english(4 * MIB, seed), -(-ne // (4 * MIB)))[:ne]
    members = np.array_split(english, 8)
    with ThreadPoolExecutor(8) as pool:
        blob = b"".join(pool.map(lambda a: gzip.compress(a.tobytes(), compresslevel=1), members))
    epats = [p for m in (2, 3, 5, 8, 12, 16, 24, 32)
             for p in corpus.extract_patterns(english, m, 8, seed=500 + m)]
    got = run("gzip", lambda: stream.stream_count(stream.Compressed(blob), epats))
    gz = emit(traced_scan(torch, port, "gzip_traced", engine.compile_patterns_cached(epats),
                          stream.Compressed(blob), chunk_bytes="auto"))
    check(out["gzip"]["launches"]["megascan"] == gz["windows"],
          f"gzip: megascan launches {out['gzip']['launches']['megascan']} != windows {gz['windows']}")
    dev_en = torch.from_numpy(english).to(DEVICE)
    for i, p in enumerate(epats):
        want = int(epsm.count(dev_en, torch.from_numpy(p.copy()).to(DEVICE)))
        check(int(got[i]) == want, f"gzip stream pattern {i}: {int(got[i])} != {want}")
    del dev_en
    rsp = np.random.RandomState(seed + 6)
    block = [rsp.randint(128, 256, size=m).astype(np.uint8) for m in (6, 9, 12, 20) for _ in range(4)]
    ps = port.mp.PatternSet(block, device=DEVICE)
    doc = english[: 64 * MIB].copy()
    clean = run("contains_any_stream_clean", lambda: ps.contains_any_stream(doc))
    doc[40 * MIB : 40 * MIB + 12] = block[9]
    dirty = run("contains_any_stream_dirty", lambda: ps.contains_any_stream(doc))
    check(not clean and dirty, f"contains_any_stream clean={clean} dirty={dirty}")
    emit({"phase": "main-stream", "run": "gzip", "bytes": ne, "compressed_bytes": len(blob),
          "members": len(members), "wall_s": out["gzip"]["wall_s"],
          "GB_per_s": ne / out["gzip"]["wall_s"] / 1e9,
          "contains_any_stream": {"clean": clean, "dirty": dirty,
                                  "clean_wall_s": out["contains_any_stream_clean"]["wall_s"],
                                  "dirty_wall_s": out["contains_any_stream_dirty"]["wall_s"]}})
    del english, doc, blob
    # -- epsm.positions on a host protein text auto-streams (find_stream)
    npr = sizes["protein"]
    prot = random_text(torch, npr, 20, gen, corpus.PROTEIN_ALPHABET)
    phost = prot.cpu().numpy()
    check(npr >= epsm.STREAM_AUTO_BYTES, "the protein text must be long enough to auto-stream")
    for m in (4, 8, 20):
        (p,) = corpus.extract_patterns(phost, m, 1, seed=600 + m)
        pos = run(f"positions_m{m}", lambda: epsm.positions(phost, p))
        want = epsm.positions(prot, torch.from_numpy(p.copy()).to(DEVICE))
        check(np.array_equal(pos, want), f"streamed positions m={m} != resident")
        check(len(pos) >= 1, f"positions m={m}: extracted pattern not found")
    emit({"phase": "main-stream", "run": "positions", "bytes": npr,
          "wall_s": {m: out[f"positions_m{m}"]["wall_s"] for m in (4, 8, 20)}})
    emit({"phase": "main-stream", "launches": launches})
    return {"launches": launches, "rise": rise, "window_bytes": sc.window_bytes,
            "wall_s": {k: v["wall_s"] for k, v in out.items()},
            "host": host, "pats": pats, "genome_GB_per_s": n / out["genome"]["wall_s"] / 1e9}


def traced_scan(torch, port: Port, label: str, plans, source, **kw) -> dict:
    """Where a stream's time goes: the same scan with a fenced recorder, so
    the host_prep span times the window's read, decompression and assembly,
    device_put the host-to-device copy and dispatch the scan on the card,
    each waiting for its device work (the pipeline is serialized)."""
    rec = port.Recorder(enabled=True, fence=True)
    sc = port.stream.StreamScanner(plans, recorder=rec, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc.count_many(source)
    return {"phase": "main-stream", "run": label, "windows": sc.dispatch_count,
            "fenced_wall_s": time.perf_counter() - t0, "span_ms": rec.span_totals_ms()}


def main_approx(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """k-mismatch matching at full size: each call between counter resets,
    each output checked afterwards against the plain version on the card.
    The calls that reach the kernel are counted by a spy on the engine's
    k-mismatch mask route, the one caller of the kernel on these paths."""
    corpus, epsm, counting = port.corpus, port.epsm, port.counting
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    launches, expected, walls = 0, 0, {}
    route = counting.match_group_approx

    def spy(*args, **kw):
        nonlocal expected
        expected += 1
        return route(*args, **kw)

    def run(label, fn):
        nonlocal launches
        torch.cuda.synchronize()
        port.reset_launches()
        counting.match_group_approx = spy
        t0 = time.perf_counter()
        try:
            res = fn()
            torch.cuda.synchronize()
        finally:
            counting.match_group_approx = route
        walls[label] = time.perf_counter() - t0
        got = port.launches()
        check(all(v == 0 for name, v in got.items() if name != "approx"),
              f"{label}: another kernel launched: {got}")
        launches += got["approx"]
        return res

    prot = random_text(torch, sizes["protein"], 20, gen, corpus.PROTEIN_ALPHABET)
    host = prot[: 1 << 24].cpu().numpy()
    for m in (8, 16, 32):
        (p,) = corpus.extract_patterns(host, m, 1, seed=700 + m)
        p = torch.from_numpy(p.copy()).to(DEVICE)
        p[m // 2] = ord("W") if int(p[m // 2]) != ord("W") else ord("A")  # one substitution
        for k in (1, 2):
            mask = run(f"find_m{m}_k{k}", lambda: epsm.find(prot, p, k=k))
            check(torch.equal(mask, port.ax_plain(prot, p[None, :], k)[0, 0]),
                  f"epsm.find m={m} k={k} != plain")
            check(int(mask.sum()) >= 1, f"epsm.find m={m} k={k}: planted site not found")
            del mask
    del prot
    ne = sizes["english"]
    english = np.tile(corpus.english(4 * MIB, seed), -(-ne // (4 * MIB)))[:ne]
    pats = [p for m in (2, 3, 5, 8, 12, 16, 24, 32)
            for p in corpus.extract_patterns(english, m, 8, seed=800 + m)]
    dev_en = torch.from_numpy(english).to(DEVICE)
    ps = port.mp.PatternSet(pats, k=1, device=DEVICE)
    counts = run("count_each_k1", lambda: ps.count_each(dev_en))
    col = 0
    for plan in ps.plans:
        want = port.ax_plain(dev_en, plan.patterns, 1).sum(-1, dtype=torch.int32)[0]
        check(torch.equal(counts[col : col + plan.n_patterns], want), f"count_each k=1 m={plan.m}")
        col += plan.n_patterns
    check(int(counts.min()) >= 1, "count_each k=1: an extracted pattern not counted")
    del dev_en
    B, nb = sizes["batch"]
    texts = genome_text(torch, B * nb, gen).view(B, nb)
    th = texts[0, : 1 << 24].cpu().numpy()
    bp = torch.from_numpy(corpus.extract_patterns(th, 16, 32, seed=900)).to(DEVICE)
    masks = run("approx_batched", lambda: port.ax_ops.approx_batched(texts, bp, 2))
    expected += 1  # the op calls the kernel itself
    check(torch.equal(masks, port.ax_plain(texts, bp, 2)), "approx_batched != plain")
    del masks, texts
    emit({"phase": "main-approx", "wall_s": walls, "launches": launches, "expected": expected})
    check(launches == expected, f"approx launches {launches} != calls reaching it {expected}")
    return {"launches": launches, "wall_s": walls}


def warp_pass_frac(torch, port: Port, index, m: int, kbits: int, lut) -> float:
    """Share of the kernels' 512-position warp spans (per row) holding a
    valid start whose window fingerprint hits ``lut``: the spans whose
    per-pattern work a LUT-gated group or op cannot skip on this data."""
    engine = port.engine
    h = engine.FingerprintBank(index.packed).window_fp(m, kbits)
    hit = lut[h.long()] & engine._valid_starts(index, m)
    hit = torch.nn.functional.pad(hit, (0, (-hit.shape[1]) % WARP_SPAN))
    return float(hit.view(hit.shape[0], -1, WARP_SPAN).any(-1).float().mean())


def bound_of(moved_bytes: float, ops: float) -> tuple:
    """(least ms, what binds): bytes over the memory rate against integer
    operations over the CUDA cores' INT32 rate."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mega_ops_first_design(torch, port: Port, window, plans, spec) -> float:
    """Integer operations per position of the first megascan design, counted
    from the plan set's shapes and this window's warp-gate hits (kept
    beside the restated bound so that the change of yardstick shows):
      'a'  3 a pattern (mask, compare, add);
      'b'  the fingerprint chain, 3 a strided word the chain has not yet
           reached (shared across groups), 3 for the tail word, 6 for the
           hash and the LUT probe; then 2 a pattern (first-word compare and
           merge) in the warps the gate lets through;
      'c'  20 an inspected block (8 byte loads, 8 multiply-adds, mask,
           probe), one block a stride;
      'x'  the 'b' fingerprint when the relaxed LUT gates the group, then 5
           a pattern (__vcmpne4, popcount, shift, compare, merge) in the
           warps it lets through (all warps without the gate)."""
    index = port.engine.build_index(window)
    per_pos, chain = 0.0, 0
    for plan, g in zip(plans, spec.groups):
        if g.kind == "a":
            per_pos += 3 * g.n_patterns
        elif g.kind == "c":
            per_pos += 20 / g.stride
        else:
            frac = 1.0
            if g.kind == "b" or g.use_lut:
                ns = g.m // 4
                per_pos += 3 * max(0, ns - chain) + 3 * (g.m % 4 != 0) + 6
                chain = max(chain, ns)
                lut = plan.lut_any if g.kind == "b" else plan.relaxed_lut
                frac = warp_pass_frac(torch, port, index, g.m, g.kbits, lut)
            per_pos += frac * g.n_patterns * (2 if g.kind == "b" else 5)
    return per_pos


def mega_bound_ms(window, spec, counts) -> tuple:
    """(least ms, what binds, operations per position) of one megascan
    launch over ``window`` whose counts are ``counts``, from work that any
    implementation does.  Bytes: the window read once and the counts
    written once.  Operations, per position: 4 for each 'a' and 'b' group
    (form the packed word, hash it, probe one table, test), 4 (k + 1) for
    each 'x' group, 20 per inspected block for each 'c' group (one block a
    stride); then ceil(m / 4) word compares for each occurrence counted.
    None of it grows with the number of patterns."""
    per_pos = 0.0
    verify = 0
    for g in spec.groups:
        per_pos += {"a": 4, "b": 4, "x": 4 * (g.k + 1)}.get(g.kind, 20 / max(1, g.stride))
        verify += int(counts[g.col : g.col + g.n_patterns].sum()) * -(-g.m // 4)
    n = window.numel()
    ops = n * per_pos + verify
    return (*bound_of(n + 4 * spec.p_total, ops), ops / n)


def time_megascan(torch, port: Port, window, plans, spec, label: str) -> dict:
    out = torch.zeros(spec.p_total, dtype=torch.int32, device=DEVICE)

    def call():
        return port.ms_ops.megascan_count_window(window, plans, spec, out=out.zero_())

    counts = call().clone()
    kernel_ms = time_cuda(torch, call, 20, queued=True)
    call_ms = time_cuda(torch, call, 20)
    n = window.numel()
    plain_ms = time_cuda(torch, lambda: port.ms_plain(window, plans, k=spec.k), 5)
    bound_ms, bound_by, per_pos = mega_bound_ms(window, spec, counts)
    return emit({"phase": "timing", "kernel": "megascan", "window": label, "n": n,
                 "patterns": spec.p_total, "k": spec.k or 0,
                 "groups": "".join(g.kind for g in spec.groups), "kernel_ms": kernel_ms,
                 "call_ms": call_ms, "host_ms": call_ms - kernel_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "ops_per_position": per_pos,
                 "ops_per_position_pr13": mega_ops_first_design(torch, port, window, plans, spec),
                 "counted": int(counts.sum()), "library_ms": None,
                 "GB_per_s": n / (kernel_ms * 1e-3) / 1e9})


def timing_stream_approx(torch, np, port: Port, seed: int, n: int, window_bytes: int,
                         batch: tuple) -> dict:
    """The megascan kernel with the 112-pattern stream set (k = 0 and k = 1)
    at the window the main stream cuts (``window_bytes``, the kernels line's
    row) and on one 64 MiB window, and the approx kernel at (8, 8 MiB, P =
    32, m = 16, k = 2), beside their plain versions and bounds."""
    engine, corpus = port.engine, port.corpus
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 8)
    window = genome_text(torch, n, gen)
    host = window[: 1 << 24].cpu().numpy()
    pats = [p for m in STREAM_LENGTHS for p in corpus.extract_patterns(host, m, 16, seed=400 + m)]
    rows = {}
    for k in (0, 1):
        plans = engine.compile_patterns(pats, k=k, device=DEVICE)
        spec = port.ms_ops.build_mega_spec(plans, k=k or None)
        row = time_megascan(torch, port, window[:window_bytes], plans, spec, "stream")
        rows.setdefault("megascan", row)
        time_megascan(torch, port, window, plans, spec, "64MiB")
    B, nb = batch
    texts = genome_text(torch, B * nb, gen).view(B, nb)
    lengths = torch.full((B,), nb, dtype=torch.int32, device=DEVICE)
    bp = torch.from_numpy(corpus.extract_patterns(texts[0, : 1 << 24].cpu().numpy(), 16, 32,
                                                  seed=900)).to(DEVICE)
    (plan,) = engine.compile_patterns(list(bp.cpu().numpy()), k=2, device=DEVICE)
    lut = plan.relaxed_lut
    P, m = bp.shape
    check(port.ax_kernel.use_pieces(m, 2, P), "the approx batch must take the pigeonhole filter")

    def call(forced=None):
        return port.ax_cuda(texts, plan.patterns, plan.anchors, 2, lut, kbits=plan.kbits,
                            lengths=lengths, _pieces=forced)

    kernel_ms = time_cuda(torch, call, 20, queued=True)
    call_ms = time_cuda(torch, call, 20)
    # the first-word path (the first design) at the same shape, the variant
    first_word_ms = time_cuda(torch, lambda: call(False), 20, queued=True)
    plain_ms = time_cuda(torch, lambda: port.ax_plain(texts, bp, 2, lengths), 5)
    masks = call()
    check(torch.equal(masks, call(False)), "approx: pieces != first-word path at the batch")
    # operations, as for megascan's 'x' groups: 4 (k + 1) a position (form,
    # hash, probe and test each piece's word), then ceil(m / 4) word
    # compares for each match reported; bytes: the texts read, the masks
    # written once
    matches = int(masks.sum())
    del masks
    bound_ms, bound_by = bound_of(B * nb * (P + 1) + P * m + 4 * B,
                                  B * nb * 4 * (2 + 1) + matches * -(-m // 4))
    rows["approx"] = emit({
        "phase": "timing", "kernel": "approx", "B": B, "n": nb, "P": P, "m": m, "k": 2,
        "use_lut": lut is not None, "path": "pieces", "kernel_ms": kernel_ms, "call_ms": call_ms,
        "first_word_kernel_ms": first_word_ms, "plain_ms": plain_ms, "matches": matches,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "GB_per_s": B * nb * (P + 1) / (kernel_ms * 1e-3) / 1e9})
    return rows


def compare_automaton(torch, np, port: Port, seed: int) -> dict:
    """Hold the acscan kernel against its plain version on the card, bit for
    bit: automaton_states with use_kernel=True against use_kernel=False
    (which takes its own segment width, 128 against the kernel's 132).

    Small shapes: the counts mode's table in shared memory (genome, 2048
    patterns), in L2 (english, 8192) and past L2 in HBM (random m = 8,
    10,000), the table in shared memory also forced where it fits (the
    states mode's default is global memory); a dictionary holding byte 0x00;
    max_m = 2000; n in {1, 127, 128, 129, 131, 132, 133, 1 MiB + 7}; 37
    ragged rows; count_automaton with end_min.  The counts mode
    (acscan_counts_cuda against acscan_counts_ref) on the ragged rows with
    and without end_min, in every variant that fits (table in shared or
    global memory, histogram in shared or global memory, 1 or 4 lanes a
    thread), with the uint16 table and its int32 copy.

    The main path's shapes, where on 256 MiB every block of the persistent
    grid loops over several (row, tile)s (checked from the launch's grid):
    each table on 256 MiB, in the states mode every variant that fits over
    the uint16 table and the forced placements over the int32 one; the 0x00
    dictionary and max_m = 2000 on 64 MiB; the english table on blocked's
    (4096, 65536) ragged batch (states and counts); and the windows
    stream_count hands the automaton, captured as it runs.  At each, the
    counts mode in every variant that fits, with end_min on the batch and
    the windows."""
    A, corpus, engine = port.automaton, port.corpus, port.engine
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    genome = genome_text(torch, 4 * MIB, gen)
    ghost = genome.cpu().numpy()
    english = torch.from_numpy(corpus.english(4 * MIB, seed).copy()).to(DEVICE)
    ehost = english.cpu().numpy()

    def with_zeros(text):
        return torch.where(torch.rand(text.numel(), generator=gen, device=DEVICE) < 0.2,
                           torch.zeros_like(text), text)

    zero_text = with_zeros(genome)
    zpats = dict_patterns(np, corpus, zero_text[:MIB].cpu().numpy(), 200, seed + 10)
    zpats += [np.array([0, 65, 0, 67], np.uint8), np.zeros(5, np.uint8), np.array([0], np.uint8)]
    lpats = dict_patterns(np, corpus, ghost, 64, seed + 11) + [ghost[1000:3000].copy()]
    cases = {
        # name: (patterns, text, counts-mode placement wanted by default, forced variants)
        "genome2048": (dict_patterns(np, corpus, ghost, 2048, seed + 12), genome, "shared",
                       ["shared"]),
        "english8192": (dict_patterns(np, corpus, ehost, 8192, seed + 13), english, "global", []),
        "random10k": (random_dictionary(np, seed, 10_000), random_text(torch, 4 * MIB, 256, gen),
                      "global", []),
        "zero_byte": (zpats, zero_text, None, ["shared"]),
        "max_m_2000": (lpats, genome, None, ["shared"]),
    }
    done, max_err, tables, autos = 0, 0, {}, {}

    def hold(got, want, label):
        nonlocal done, max_err
        torch.cuda.synchronize()
        if got.numel():
            max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want)[:4].tolist()
            raise RuntimeError(f"acscan {label}: kernel != plain at {bad}")
        done += 1

    def forced_call(x, auto, table):
        return port.acscan_cuda(x, auto.classes, auto.delta, auto.n_classes, auto.max_m,
                                _table=table)

    counts_seen = []

    def hold_counts(x, lengths, end_min, auto, label, dtypes=False, persistent=False):
        """acscan_counts_cuda in every variant that fits against
        acscan_counts_ref; with ``dtypes`` also over the int32 copy of a
        uint16 table; with ``persistent`` each launch loops its blocks."""
        kt = A.kernel_tables(auto)
        tabs = [kt.counts]
        if dtypes and kt.counts.dtype != torch.int32:
            tabs.append(kt.counts.int())
        args = (auto.classes, kt.counts, auto.n_classes, kt.n_term, auto.max_m, lengths)
        want = port.acscan_counts_ref(x, *args, end_min=end_min)
        for tab in tabs:
            for v in [None] + acscan_variants(auto, kt, tab):
                got = port.acscan_counts_cuda(x, auto.classes, tab, *args[2:], end_min=end_min,
                                              **(v or {}))
                c = dict(port.acscan_counts_cuda.config)
                hold(got, want, f"{label} counts {tab.dtype} {v} end_min={end_min}")
                counts_seen.append((c["table_shared"], c["mode"], c["lanes"], c["entry_bytes"],
                                    c["one_block"]))
                if persistent:
                    tiles = acscan_tiles(x, c)
                    check(tiles >= 2 * c["grid"], f"{label}: {tiles} tiles, grid {c['grid']}")
        del want

    for name, (pats, text, want_table, forced) in cases.items():
        auto = autos[name] = A.compile_automaton(pats, device=DEVICE)
        check(auto is not None, f"{name}: no automaton")
        table_bytes = 4 * auto.n_states * auto.n_classes
        configs = []
        for n in (1, 127, 128, 129, 131, 132, 133, MIB + 7):
            x = text[:n][None, :].contiguous()
            plain = A.automaton_states(x, auto, use_kernel=False)
            hold(A.automaton_states(x, auto, use_kernel=True), plain, f"{name} n={n}")
            configs.append(dict(port.acscan_cuda.config))
            if n == MIB + 7:
                for table in forced:
                    hold(forced_call(x, auto, table), plain, f"{name} n={n} table={table}")
                    configs.append(dict(port.acscan_cuda.config))
                hold(A.count_automaton(x, [n], auto, use_kernel=True),
                     A.count_automaton(x, [n], auto, use_kernel=False), f"{name} n={n} counts")
                placed = dict(port.acscan_counts_cuda.config)
        if want_table is not None:  # where the counts mode, the main path's, puts the table
            check(placed["table_shared"] == (want_table == "shared"),
                  f"{name}: table placement {placed}")
        # B > 1 ragged rows (rows never share a lane), count_automaton with end_min
        B = 37
        L = min(70_001, text.numel() // B - 1)
        rows = text[: B * L].view(B, L)
        lengths = torch.randint(0, L + 1, (B,), generator=gen, device=DEVICE)
        hold(A.automaton_states(rows, auto, use_kernel=True),
             A.automaton_states(rows, auto, use_kernel=False), f"{name} ragged states")
        for end_min in (None, 1000):
            got = A.count_automaton(rows, lengths, auto, end_min=end_min, use_kernel=True)
            want = A.count_automaton(rows, lengths, auto, end_min=end_min, use_kernel=False)
            hold(got, want, f"{name} ragged counts end_min={end_min}")
            hold_counts(rows, lengths, end_min, auto, f"{name} ragged", dtypes=True)
        kt = A.kernel_tables(auto)
        tables[name] = {"states": auto.n_states, "classes": auto.n_classes, "max_m": auto.max_m,
                        "n_term": kt.n_term, "table_bytes": table_bytes,
                        "entry_bytes": kt.counts.element_size(), "placements": sorted(
                            {(c["table_shared"], c["lanes"]) for c in configs})}
    del genome, english, zero_text, cases

    # -- the main path's shapes
    big = []

    def hold_big(x, auto, forced, label):
        """The default and each forced placement on x (the plan's int32
        table), and each variant that fits over the uint16 copy where the
        ids fit, several tiles a block."""
        plain = A.automaton_states(x, auto, use_kernel=False)
        kt = A.kernel_tables(auto)
        calls = [(None, lambda: A.automaton_states(x, auto, use_kernel=True))]
        calls += [(t, lambda t=t: forced_call(x, auto, t)) for t in forced]
        if kt.states.dtype != torch.int32:
            calls += [(v, lambda v=v: port.acscan_cuda(x, auto.classes, kt.states, auto.n_classes,
                                                       auto.max_m, **v))
                      for v in acscan_variants(auto, kt, kt.states, counts=False)]
        for v, call in calls:
            got = call()
            c = dict(port.acscan_cuda.config)
            hold(got, plain, f"{label} states {v}")
            del got
            tiles = acscan_tiles(x, c)
            if x.numel() >= 256 * MIB:
                check(tiles >= 2 * c["grid"], f"{label}: {tiles} tiles for a grid of {c['grid']}")
            big.append({"case": label, "variant": v, "shape": list(x.shape), "tiles": tiles,
                        "grid": c["grid"], "placement": [c["table_shared"], c["lanes"],
                                                         c["threads"], c["entry_bytes"]]})
        del plain

    big_cases = (
        ("english8192", lambda: english_on_card(torch, np, corpus, 256 * MIB, seed), []),
        ("genome2048", lambda: genome_text(torch, 256 * MIB, gen), ["shared"]),
        ("random10k", lambda: random_text(torch, 256 * MIB, 256, gen), []),
        ("zero_byte", lambda: with_zeros(genome_text(torch, 64 * MIB, gen)), ["shared"]),
        ("max_m_2000", lambda: genome_text(torch, 64 * MIB, gen), ["shared"]),
    )
    for name, make, forced in big_cases:
        x = make()[None, :]
        hold_big(x, autos[name], forced, f"{name} n={x.shape[1]}")
        hold_counts(x, [x.shape[1]], None, autos[name], f"{name} n={x.shape[1]}",
                    persistent=x.shape[1] >= 256 * MIB)
        del x
    # blocked's (4096, 65536) ragged batch with the english table
    Bb = 4096
    Lb = 256 * MIB // Bb
    batch = english_on_card(torch, np, corpus, Bb * Lb, seed).view(Bb, Lb).clone()
    lengths = torch.randint(1, Lb + 1, (Bb,), generator=gen, device=DEVICE, dtype=torch.int32)
    batch.masked_fill_(torch.arange(Lb, device=DEVICE)[None, :] >= lengths[:, None], 0)
    auto = autos["english8192"]
    hold_big(batch, auto, [], f"english8192 batch {Bb}x{Lb}")
    for end_min in (None, 1000):
        hold(A.count_automaton(batch, lengths, auto, end_min=end_min, use_kernel=True),
             A.count_automaton(batch, lengths, auto, end_min=end_min, use_kernel=False),
             f"english8192 batch counts end_min={end_min}")
        hold_counts(batch, lengths, end_min, auto, f"english8192 batch {Bb}x{Lb}",
                    dtypes=end_min is None, persistent=True)
    del batch
    # the windows stream_count hands the automaton: main-dict's 8192 english
    # patterns over three full windows and a short fourth of host english
    windows, orig = [], engine._automaton_counts

    def capture(index, auto, end_min=None):
        windows.append((index.text.clone(), index.lengths.clone(), end_min, auto))
        return orig(index, auto, end_min)

    pats = dict_patterns(np, corpus, ehost, 8192, seed + 14)
    chunk = port.stream.auto_chunk_bytes(device=DEVICE)
    engine._automaton_counts = capture
    try:
        n_host = 3 * chunk + 12_345
        port.stream.stream_count(np.tile(ehost, -(-n_host // ehost.size))[:n_host], pats,
                                 chunk_bytes=chunk, device=DEVICE)
    finally:
        engine._automaton_counts = orig
    check(len(windows) >= 3, f"stream: {len(windows)} automaton windows")
    for i, (text, lengths, end_min, auto) in enumerate(windows):
        hold(A.automaton_states(text, auto, use_kernel=True),
             A.automaton_states(text, auto, use_kernel=False), f"stream window {i} states")
        hold(A.count_automaton(text, lengths, auto, end_min=end_min, use_kernel=True),
             A.count_automaton(text, lengths, auto, end_min=end_min, use_kernel=False),
             f"stream window {i} counts end_min={end_min}")
        hold_counts(text, lengths, end_min, auto, f"stream window {i}", dtypes=i == 0)
    stream = [{"shape": list(t.shape), "length": int(ln[0]), "end_min": e}
              for t, ln, e, _ in windows]
    return {"cases": done, "max_abs_err": max_err, "tables": tables, "main_path_shapes": big,
            "stream_windows": stream,
            "counts_variants": [dict(zip(("table_shared", "mode", "lanes", "entry_bytes",
                                          "one_block"), v)) for v in sorted(set(counts_seen))]}


# Shared memory one block of the H100 can opt in to (232,448 bytes)
SMEM_MAX = 232_448


def acscan_tiles(x, config: dict) -> int:
    """The (row, tile)s of one acscan launch over x with ``config``."""
    lanes_row = -(-x.shape[1] // config["seg"])
    return x.shape[0] * -(-lanes_row // (config["lanes"] * config["threads"]))


def acscan_variants(auto, kt, table, counts: bool = True) -> list:
    """The forced variants of the acscan launcher whose shared memory (the
    class map, and the table and the histogram where they are placed there)
    fits one block: table in shared or global memory, histogram in shared
    or global memory (counts mode), 1 or 4 lanes a thread, each at the
    block width the launcher picks for it; and one block an SM (more L1)
    forced on and off."""
    r16 = lambda v: -(-v // 16) * 16
    table_bytes = r16(table.element_size() * table.numel())
    out = []
    for tab in ("shared", "global"):
        for hist in (("shared", "global") if counts else (None,)):
            need = (512 + (table_bytes if tab == "shared" else 0)
                    + (r16(4 * kt.n_term) if hist == "shared" else 0))
            if need <= SMEM_MAX:
                for lanes in (1, 4):
                    v = {"_table": tab, "_lanes": lanes}
                    if counts:
                        v["_hist"] = hist
                    out.append(v)
    return out + ([{"_one_block": True}, {"_one_block": False}] if counts else [])


def dict_patterns(np, corpus, host, P: int, seed: int) -> list:
    """P patterns of lengths 4..15 (as evenly as P allows) extracted from
    ``host``."""
    per = [P // len(DICT_LENGTHS) + (i < P % len(DICT_LENGTHS)) for i in range(len(DICT_LENGTHS))]
    return [p for m, c in zip(DICT_LENGTHS, per) for p in corpus.extract_patterns(host, m, c, seed=seed + m)]


def random_dictionary(np, seed: int, P: int, m: int = 8) -> np.ndarray:
    """benchmarks/run.py bench_dictionary's dictionary: P distinct random
    m-byte patterns, shuffled."""
    rng = np.random.default_rng(seed + P)
    pats = np.unique(rng.integers(0, 256, size=(2 * P, m), dtype=np.uint8), axis=0)
    rng.shuffle(pats)
    return pats[:P]


def english_on_card(torch, np, corpus, n: int, seed: int):
    """The 4 MiB corpus.english text tiled to n bytes, on the card."""
    base = torch.from_numpy(corpus.english(4 * MIB, seed).copy()).to(DEVICE)
    return base.repeat(-(-n // base.numel()))[:n].contiguous()


class AutomatonSpy:
    """Counts the engine's automaton routes (calls of _automaton_counts)
    while installed, to hold the acscan launch counter against."""

    def __init__(self, engine):
        self.engine, self.orig, self.calls = engine, engine._automaton_counts, 0

    def __enter__(self):
        def spy(*a, **kw):
            self.calls += 1
            return self.orig(*a, **kw)

        self.engine._automaton_counts = spy
        return self

    def __exit__(self, *exc):
        self.engine._automaton_counts = self.orig
        return False


def main_dict(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """Dictionary-scale counting at full size, each run between a counter
    reset and a counter read with the engine's automaton routes counted by a
    spy (acscan counts-mode launches must equal them, and nothing else
    launches), each output then checked against
    an independent path: count_many with automaton=False plans on a 16 MiB
    slice, and epsm.count for 16 sampled patterns over the whole text."""
    engine, mp, corpus, epsm = port.engine, port.mp, port.corpus, port.epsm
    n, slice_n = sizes["text"], 16 * MIB
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    launches = {name: 0 for name in port.wrappers}
    report = {}

    def run(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        port.reset_launches()
        with AutomatonSpy(engine) as spy:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = port.launches()
        check(got["acscan_counts"] == spy.calls,
              f"{label}: acscan counts-mode launches {got['acscan_counts']} != automaton "
              f"routes {spy.calls}")
        check(all(v == 0 for k, v in got.items() if k != "acscan_counts"),
              f"{label}: another kernel or mode launched: {got}")
        for k, v in got.items():
            launches[k] += v
        report[label] = {"wall_s": wall, "acscan_counts_launches": got["acscan_counts"],
                         "automaton_routes": spy.calls,
                         "peak_gib": torch.cuda.max_memory_allocated() / GIB}
        return out

    def independent(label, text, plans, flat, pats, counts, order):
        """counts (plan order) against ``flat`` (the same patterns compiled
        with automaton=False) on a 16 MiB slice, when the plans carry an
        automaton, and epsm.count of 16 sampled patterns over the whole
        text."""
        if flat is not None:
            sl = engine.build_index(text[:slice_n])
            route = engine.route_probe(sl, plans)["route"]
            check(engine.plan_order(flat).tolist() == list(order), f"{label}: plan order")
            check(torch.equal(engine.count_many(sl, plans), engine.count_many(sl, flat)),
                  f"{label}: 16 MiB slice != automaton=False plans (slice route {route})")
            report[label]["slice_route"] = route
            del sl
        for row in np.random.RandomState(seed).choice(len(order), 16, replace=False):
            p = torch.from_numpy(np.asarray(pats[order[row]]).copy()).to(DEVICE)
            check(int(counts[row]) == int(epsm.count(text, p)),
                  f"{label}: row {row} != epsm.count")

    # -- english, 8192 patterns of m 4..15 extracted from the text
    english = english_on_card(torch, np, corpus, n, seed)
    ehost = english[: 4 * MIB].cpu().numpy()
    pats = dict_patterns(np, corpus, ehost, 8192, seed + 14)
    ps = mp.PatternSet(pats, device=DEVICE)
    check(all(p.automaton is not None for p in ps.plans), "english8192: plans without automaton")
    counts = run("count_each_english8192", lambda: ps.count_each(english))
    report["count_each_english8192"]["route"] = engine.route_probe(ps.index(english), ps.plans)["route"]
    flat = engine.compile_patterns(pats, automaton=False, device=DEVICE)
    independent("count_each_english8192", english, ps.plans, flat, pats, counts, ps.order)
    check(int(counts.min()) >= 1, "english8192: an extracted pattern not counted")
    # blocked on a (4096, 65536) ragged batch
    Bb, Lb = sizes["batch"]
    batch = english[: Bb * Lb].view(Bb, Lb).clone()
    lengths = torch.randint(1, Lb + 1, (Bb,), generator=gen, device=DEVICE, dtype=torch.int32)
    batch.masked_fill_(torch.arange(Lb, device=DEVICE)[None, :] >= lengths[:, None], 0)
    verdicts = run("blocked_english8192", lambda: ps.blocked(batch, lengths))
    idx = ps.index(batch, lengths)
    report["blocked_english8192"]["route"] = engine.route_probe(idx, ps.plans)["route"]
    del idx
    rows = slice_n // Lb
    sub = engine.build_index(batch[:rows], lengths[:rows])
    check(torch.equal(verdicts[:rows], engine.count_many(sub, flat).sum(-1) > 0),
          "blocked != automaton=False plans on the first 16 MiB of rows")
    report["blocked_english8192"]["blocked"] = int(verdicts.sum())
    del batch, sub, flat
    # -- benchmarks/run.py bench_dictionary at P = 10,000 and 50,000, m = 8,
    # scaled from 1 MB to the full text: average and adversarial textures
    for P in (10_000, 50_000):
        dpats = random_dictionary(np, seed, P)
        rec = port.Recorder(enabled=True, fence=False)
        plans = engine.compile_patterns(list(dpats), bucket=True, recorder=rec, device=DEVICE)
        built = bool(rec.events_named("automaton_built"))
        check(built == (P == 10_000) and bool(rec.events_named("automaton_skipped")) == (P == 50_000),
              f"P={P}: automaton built={built}")
        order = engine.plan_order(plans)
        flat_plans = (engine.compile_patterns(list(dpats), bucket=True, automaton=False,
                                              device=DEVICE) if built else None)
        avg = random_text(torch, n, 256, gen)
        for i in range(0, P, max(1, P // 37)):
            pos = (i * 8191) % (n - 8)
            avg[pos : pos + 8] = torch.from_numpy(dpats[i].copy()).to(DEVICE)
        flat_d = torch.from_numpy(dpats.reshape(-1).copy()).to(DEVICE)
        adv = flat_d.repeat(-(-n // flat_d.numel()))[:n].contiguous()
        for texture, text in (("average", avg), ("adversarial", adv)):
            label = f"dictionary_{texture}_p{P}"
            idx = engine.build_index(text)
            route = engine.route_probe(idx, plans)["route"]
            got = run(label, lambda: engine.count_many(idx, plans))[0]
            report[label]["route"] = route
            del idx
            independent(label, text, plans, flat_plans, list(dpats), got, order)
            if texture == "adversarial":
                check(route == ("automaton" if P == 10_000 else "slot_dense"),
                      f"{label}: route {route}")
        del avg, adv
    # -- stream_count of the english set over host memory: megascan turns
    # the 8192-pattern set away (more than 512 patterns a group), logged, and
    # every window is one acscan counts launch over the set's automaton (an
    # automaton route the spy counts)
    ns = sizes["stream"]
    host = np.tile(ehost, ns // ehost.size)
    events = []
    stream_log = logging.getLogger("repro_torch.stream")
    handler, level = _ListHandler(events), stream_log.level
    stream_log.addHandler(handler)
    stream_log.setLevel(logging.INFO)
    try:
        streamed = run("stream_count_english8192",
                       lambda: port.stream.stream_count(host, pats, device=DEVICE))
    finally:
        stream_log.removeHandler(handler)
        stream_log.setLevel(level)
    check(any("kernel_fallback" in e for e in events), "stream: no kernel_fallback logged")
    # the text is periodic (4 MiB), so the stream's counts are the resident
    # 256 MiB counts times ns / n plus the occurrences across each of the
    # (ns / n - 1) joins of 256 MiB copies
    reps = ns // n
    ov = max(len(p) for p in pats) - 1
    seam = torch.cat([english[n - ov :], english[:ov]])
    whole = ps.count_each(seam).long()
    parts = ps.count_each(english[n - ov :]).long() + ps.count_each(english[:ov]).long()
    want = np.zeros(len(pats), np.int64)
    want[ps.order] = (reps * counts.long() + (reps - 1) * (whole - parts)).cpu().numpy()
    check(np.array_equal(streamed.astype(np.int64), want), "stream_count != resident count_each")
    report["stream_count_english8192"].update(bytes=ns, GB_per_s=ns / report[
        "stream_count_english8192"]["wall_s"] / 1e9)
    del host, english
    for label, row in report.items():
        emit({"phase": "main-dict", "run": label, **row})
    return {"launches": launches, "report": report}


class _ListHandler(logging.Handler):
    def __init__(self, out: list):
        super().__init__(logging.DEBUG)
        self.out = out

    def emit(self, record):
        self.out.append(record.getMessage())


def main_serve(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """A GrepServer on 127.0.0.1 over a QueryPlane on the card: a 256 MiB
    english corpus loaded in-process and a 1 MiB one sent over the wire.  8
    client connections send, all at once, 64 count queries of 64 english
    patterns (16 distinct queries, each 4 times) to the 256 MiB corpus, and
    to it also 3 any and 2 count queries of 1536 patterns each
    (dictionary-scale) and one match query with 2 patterns; 4 count queries
    of 64 patterns go to the 1 MiB corpus.  Every answer is held against
    PatternSet(query patterns).count_each run alone (the match positions
    against epsm.positions); the service trace must pass
    benchmarks/validate_trace.py.

    Coalesced 8 at a time (one in flight per connection), the 64-pattern
    queries make unions under 1024 patterns, which on 256 MiB of english
    overflow the shared budget into the dense fallback; the 1536-pattern
    queries make unions past 1024 that take the automaton."""
    import asyncio

    engine, mp, corpus, qp = port.engine, port.mp, port.corpus, port.qp
    n = sizes["text"]
    english = english_on_card(torch, np, corpus, n, seed)
    ehost = english[: 4 * MIB].cpu().numpy()
    corpus_bytes = english.cpu().numpy()
    small = corpus.english(MIB, seed + 1)
    pool = [bytes(p) for p in dict_patterns(np, corpus, ehost, 8192, seed + 15)]
    rs = np.random.RandomState(seed + 15)
    distinct = [[pool[i] for i in rs.choice(len(pool), 64, replace=False)] for _ in range(16)]
    big = [pool[j * 1536 : (j + 1) * 1536] for j in range(5)]
    jobs = [[("english", "count", distinct[(8 * c + j) % 16]) for j in range(8)] for c in range(8)]
    for c in range(3):
        jobs[c].insert(1, ("english", "any", big[c]))
    for c in (3, 4):
        jobs[c].insert(2, ("english", "count", big[c]))
    jobs[5].insert(1, ("english", "match", [pool[5], pool[4000]]))
    for c in range(4, 8):
        jobs[c].insert(4, ("small", "count", distinct[c]))
    n_jobs = sum(len(j) for j in jobs)
    unions, by_kind = [], {}
    orig_union = qp.canonical_union

    def union_spy(patterns):
        out = orig_union(patterns)
        unions.append(len(out[0]))
        return out

    async def serve():
        rec = port.Recorder(enabled=True, fence=True)
        plane = qp.QueryPlane(qp.ServiceConfig(corpus_budget_bytes=8 * GIB, result_cache_entries=0),
                              recorder=rec, device=DEVICE)
        plane.add_corpus("english", corpus_bytes)
        answers, latencies = [], []
        async with port.GrepServer(plane) as (host, port_no):
            clients = [await port.GrepClient.connect(host, port_no) for _ in range(8)]
            added = await clients[0].add_corpus("small", small.tobytes())
            check(added["ok"], f"add_corpus over the wire: {added}")
            torch.cuda.synchronize()
            port.reset_launches()
            t_all = time.perf_counter()

            async def work(client, mine):
                for cid, mode, pats in mine:
                    t0 = time.perf_counter()
                    resp = await client.query(cid, pats, mode=mode)
                    latencies.append((time.perf_counter() - t0) * 1e3)
                    by_kind.setdefault(f"{cid}/{mode}/{len(pats)}", []).append(latencies[-1])
                    answers.append((cid, mode, pats, resp))

            await asyncio.gather(*[work(c, mine) for c, mine in zip(clients, jobs)])
            wall = time.perf_counter() - t_all
            stats = (await clients[0].stats())["stats"]
            for c in clients:
                await c.close()
        return rec, answers, latencies, wall, stats

    qp.canonical_union = union_spy
    try:
        with AutomatonSpy(engine) as spy:
            rec, answers, latencies, wall, stats = asyncio.run(serve())
    finally:
        qp.canonical_union = orig_union
    got = port.launches()
    routes = spy.calls
    check(got["acscan_counts"] == routes >= 1 and got["acscan"] == 0,
          f"serve: acscan counts-mode launches {got['acscan_counts']} != automaton routes "
          f"{routes} (need >= 1; states mode {got['acscan']})")
    failed = [(cid, mode, r) for cid, mode, _, r in answers if not r["ok"]]
    check(not failed and len(answers) == n_jobs, f"serve: {len(answers)} answers, failed: {failed[:3]}")
    # each answer against the query's patterns counted alone
    small_dev = torch.from_numpy(small.copy()).to(DEVICE)
    alone: dict = {}
    for cid, mode, pats, resp in answers:
        key = (cid, tuple(pats))
        if key not in alone:
            ps = mp.PatternSet(list(pats), device=DEVICE)
            c = ps.count_each(english if cid == "english" else small_dev)
            want = np.zeros(len(pats), np.int64)
            want[ps.order] = c.cpu().numpy()
            alone[key] = want.tolist()
        check(resp["counts"] == alone[key], f"serve {cid} {mode}: answer != count_each alone")
        if mode == "match":
            for p, pos in zip(pats, resp["positions"]):
                want = port.epsm.positions(english, torch.frombuffer(bytearray(p), dtype=torch.uint8)
                                           .to(DEVICE))
                check(np.array_equal(np.asarray(pos, np.int64), want), "serve: match positions")
    trace = ROOT / "build" / "serve_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    rec.export_trace(trace)
    val = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "validate_trace.py"), str(trace)],
                         capture_output=True, text=True, timeout=120)
    check(val.returncode == 0, f"trace validation failed: {val.stdout} {val.stderr}")
    lat = np.asarray(latencies)
    # each engine call of the dispatch thread (fenced): corpus bytes, union size, ms
    dispatch_ms = [[args["n"], args["p_union"], dur * 1e3]
                   for rows in rec.trace.snapshot().values()
                   for _ph, name, _ts, dur, args in sorted(rows, key=lambda r: r[2])
                   if name == "engine_dispatch"]
    return emit({"phase": "main-serve", "queries": len(answers), "dispatches": stats["dispatches"],
                 "coalescing_ratio": stats["coalescing_ratio"], "union_sizes": unions,
                 "automaton_routes": routes, "acscan_counts_launches": got["acscan_counts"],
                 "launches": got, "wall_s": wall, "p50_ms": float(np.percentile(lat, 50)),
                 "p99_ms": float(np.percentile(lat, 99)),
                 "ms_by_kind": {k: {"queries": len(v), "p50": float(np.median(v)), "max": max(v)}
                                for k, v in sorted(by_kind.items())},
                 "dispatch_ms": dispatch_ms,
                 "trace": val.stdout.strip()})


def acscan_bounds(auto, kt, B: int, n: int, transitions: int, mode: str) -> tuple:
    """(least ms, what binds) of one acscan launch, counted as work the same
    whatever implements it.  Bytes: the text of the transitions the
    sequential scan needs read once, the table once at its stored width,
    and the int32 states (4 B n, states mode) or the histogram
    (4 B n_term, counts mode) written once.  Operations: ~4 integer
    operations a transition (class load, multiply-add, table load, and the
    store or the compare) over those transitions."""
    table = kt.counts if mode == "counts" else kt.states
    out = 4 * B * kt.n_term if mode == "counts" else 4 * B * n
    return bound_of(transitions + table.element_size() * table.numel() + out, 4 * transitions)


def timing_acscan(torch, np, port: Port, seed: int, n: int) -> dict:
    """Both modes of the acscan kernel at the main path's shapes: n bytes of
    english with the 8192-pattern table (uint16, in global memory: L2) and
    of genome with the 2048-pattern table (uint16, in shared memory), the
    random 10,000-pattern table (int32, HBM) on bench_dictionary's
    adversarial texture (the dictionary tiled, which main-dict sends to the
    automaton) of n bytes, blocked's
    (4096, 65536) ragged english batch, and one 4 MiB english window of
    the stream with end_min.  For each: the default launch's kernel time
    (queued) and call time, both modes' bounds, every forced variant that
    fits and the int32 copy of a uint16 table (counts mode), and on the
    two n-byte texts the plain versions and
    count_automaton.  Returns the english row (the kernels line: the
    counts mode, which the main path launches)."""
    A, corpus = port.automaton, port.corpus
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 17)
    english = english_on_card(torch, np, corpus, n, seed)
    ehost = english[: 4 * MIB].cpu().numpy()
    e_auto = A.compile_automaton(dict_patterns(np, corpus, ehost, 8192, seed + 14), device=DEVICE)
    genome = genome_text(torch, n, gen)
    g_auto = A.compile_automaton(
        dict_patterns(np, corpus, genome[: 4 * MIB].cpu().numpy(), 2048, seed + 12), device=DEVICE)
    rdict = random_dictionary(np, seed, 10_000)
    flat = torch.from_numpy(rdict.reshape(-1).copy()).to(DEVICE)
    adversarial = flat.repeat(-(-n // flat.numel()))[:n].contiguous()
    Bb, Lb = 4096, n // 4096
    lengths_b = torch.randint(1, Lb + 1, (Bb,), generator=gen, device=DEVICE)
    shapes = (  # name, automaton, text, lengths, end_min, plain versions timed
        ("english8192", e_auto, english[None, :], None, None, True),
        ("genome2048", g_auto, genome[None, :], None, None, True),
        ("random10k", A.compile_automaton(rdict, device=DEVICE), adversarial[None, :], None, None,
         False),
        ("english8192_batch", e_auto, english.view(Bb, Lb), lengths_b, None, False),
        ("english8192_window", e_auto, english[None, : 4 * MIB], None, e_auto.max_m - 1, False),
    )
    rows = {}
    for name, auto, x, lengths, end_min, plain in shapes:
        B, nn = x.shape
        lengths = torch.full((B,), nn, device=DEVICE) if lengths is None else lengths
        kt = A.kernel_tables(auto)
        cargs = (auto.classes, kt.counts, auto.n_classes, kt.n_term, auto.max_m, lengths)

        def counts(table=kt.counts, **v):
            return port.acscan_counts_cuda(x, auto.classes, table, *cargs[2:], end_min=end_min, **v)

        def states(**v):
            return port.acscan_cuda(x, auto.classes, kt.states, auto.n_classes, auto.max_m, **v)

        row = {"phase": "timing", "kernel": "acscan", "table": name, "shape": [B, nn],
               "end_min": end_min, "states": auto.n_states, "classes": auto.n_classes,
               "n_term": kt.n_term, "entry_bytes": kt.counts.element_size()}
        row["counts_ms"] = time_cuda(torch, counts, 20, queued=True)
        row["counts_config"] = dict(port.acscan_counts_cuda.config)
        row["counts_call_ms"] = time_cuda(torch, counts, 20)
        first = max(0, (end_min or 0) - (auto.max_m - 1))
        transitions = int((lengths.clamp(0, nn) - first).clamp(min=0).sum())
        row["counts_bound_ms"], row["counts_bound_by"] = acscan_bounds(
            auto, kt, B, nn, transitions, "counts")
        if end_min is None:
            row["states_ms"] = time_cuda(torch, states, 20, queued=True)
            row["states_config"] = dict(port.acscan_cuda.config)
            row["states_call_ms"] = time_cuda(torch, states, 20)
            row["states_bound_ms"], row["states_bound_by"] = acscan_bounds(
                auto, kt, B, nn, B * nn, "states")
        variants = {}
        for v in acscan_variants(auto, kt, kt.counts):
            variants["counts " + " ".join(f"{k[1:]}={w}" for k, w in v.items())] = time_cuda(
                torch, lambda v=v: counts(**v), 10, queued=True)
        for threads in (128, 256, 512, 1024):
            for one in (False, True):
                variants[f"counts threads={threads} one_block={one}"] = time_cuda(
                    torch, lambda t=threads, o=one: counts(_threads=t, _one_block=o), 10,
                    queued=True)
        if kt.counts.dtype != torch.int32:
            wide = kt.counts.int()
            variants["counts int32 table"] = time_cuda(torch, lambda: counts(wide), 10, queued=True)
            del wide
        if end_min is None:
            for v in acscan_variants(auto, kt, kt.states, counts=False):
                variants["states " + " ".join(f"{k[1:]}={w}" for k, w in v.items())] = time_cuda(
                    torch, lambda v=v: states(**v), 10, queued=True)
        row["variants_ms"] = variants
        if plain:
            row["counts_plain_ms"] = time_cuda(
                torch, lambda: port.acscan_counts_ref(x, *cargs, end_min=end_min), 3)
            row["states_plain_ms"] = time_cuda(
                torch, lambda: port.acscan_states_ref(x, auto.classes, kt.states, auto.n_classes,
                                                      auto.max_m), 3)
            row["count_automaton_ms"] = time_cuda(
                torch, lambda: A.count_automaton(x, lengths, auto, end_min=end_min), 5)
        rows[name] = emit(row)
    del english, genome, adversarial, shapes
    e = rows["english8192"]
    return {"mode": "counts", "kernel_ms": e["counts_ms"], "plain_ms": e["counts_plain_ms"],
            "bound_ms": e["counts_bound_ms"], "bound_by": e["counts_bound_by"]}


def shard_windows(spec, window_bytes: int, step: int) -> int:
    """Windows a clean sharded scan emits: each shard's StreamScanner run
    over its range, its first window carrying the overlap prefix."""
    total = 0
    for (s, e), i in zip(spec.ranges, range(spec.n_shards)):
        carry = s - spec.prefix_range(i)[0]
        if e > s:
            total += 1 + -(-max(0, e - s - (window_bytes - carry)) // step)
    return total


def covered_counts(port: Port, plans, text, covered, chunk):
    """A StreamScanner's counts over each covered range (its overlap prefix
    injected), summed: the answer a partial scan must give."""
    acc = None
    for s, e in covered:
        sc = port.stream.StreamScanner(plans, chunk)
        pre = text[max(0, s - sc.overlap) : s] if s else None
        got = sc.count_many(iter([text[s:e]]), prefix=pre, start=s).astype("int64")
        acc = got if acc is None else acc + got
    return acc


def position_subset(pats):
    """Two patterns of each stream length (14, every group kind): the
    positions runs' plan set, small enough that its masks stay cheap."""
    seen, out = {}, []
    for p in pats:
        if seen.get(len(p), 0) < 2:
            seen[len(p)] = seen.get(len(p), 0) + 1
            out.append(p)
    return out


def compare_shard(torch, np, port: Port, seed: int, host, pats, sizes: dict) -> dict:
    """ShardedStreamScanner, the fault fabric, the remote reader and the
    halo-exchange scan against a single StreamScanner / epsm.find on the
    card, every case equal (exact integers, no tolerance)."""
    engine, stream, ss, fi = port.engine, port.stream, port.shard_stream, port.fi
    chunk = sizes["chunk"]
    plans = engine.compile_patterns(pats, device=DEVICE)
    plans1 = engine.compile_patterns(pats, k=1, device=DEVICE)
    done = {key: 0 for key in ("count", "any", "positions", "k1", "faulted", "partial", "remote",
                               "distributed")}
    steals, fired = 0, 0

    def hold(got, want, what):
        if not np.array_equal(np.asarray(got), np.asarray(want)):
            raise RuntimeError(f"compare-shard {what}: sharded != single")

    def sharded(plans_, n_shards, steal, lanes, **kw):
        return ss.ShardedStreamScanner(plans_, n_shards, chunk, devices=[DEVICE], steal=steal,
                                       steal_workers=lanes, min_steal_bytes=8 * 1024, **kw)

    modes = ((False, None), (True, 1), (True, 2), (True, 4))
    texts = [host[:n].copy() for n in sizes["texts"]]
    for text in texts:
        single = stream.StreamScanner(plans, chunk)
        want = single.count_many(text)
        want_pos = stream.StreamScanner(plans, chunk).positions_many(text)
        for n_shards in (1, 2, 3, 8, 13):
            for steal, lanes in modes:
                what = f"n={len(text)} S={n_shards} steal={steal} lanes={lanes}"
                sc = sharded(plans, n_shards, steal, lanes)
                hold(sc.count_many(text), want, f"count {what}")
                steals += len(sc.steal_events)
                hold(sharded(plans, n_shards, steal, lanes).any_many(text), want > 0, f"any {what}")
                done["count"] += 1
                done["any"] += 1
                if len(text) <= sizes["positions_max"] or n_shards == 13:
                    got = sharded(plans, n_shards, steal, lanes).positions_many(text)
                    for row, (a, b) in enumerate(zip(got, want_pos)):
                        hold(a, b, f"positions {what} row {row}")
                    done["positions"] += 1
        if len(text) <= sizes["positions_max"]:
            want1 = stream.StreamScanner(plans1, chunk, k=1).count_many(text)
            for n_shards in (1, 3, 8, 13):
                for steal, lanes in ((False, None), (True, 2)):
                    hold(sharded(plans1, n_shards, steal, lanes, k=1).count_many(text), want1,
                         f"k=1 n={len(text)} S={n_shards} steal={steal}")
                    done["k1"] += 1
    check(steals > 0, "compare-shard: no steal or shed happened")
    # faults, retried: read errors, truncations, latency spikes, shard crashes
    text = texts[-1]
    want = stream.StreamScanner(plans, chunk).count_many(text)
    for fseed in (0, 1, 2):
        for steal, lanes in ((False, None), (True, 2)):
            plan = fi.FaultPlan(fseed, read_error_rate=0.05, truncate_rate=0.05, latency_rate=0.05,
                                latency_s=0.001, crash_rate=0.3, attempts_per_fault=1)
            sc = sharded(plans, 8, steal, lanes, max_retries=16, fault_plan=plan,
                         backoff=port.ft.BackoffPolicy(base_s=0.0, jitter=0.0))
            hold(sc.count_many(fi.FaultyRangeSource(text, plan, piece_bytes=64 * 1024)), want,
                 f"faulted seed={fseed} steal={steal}")
            fired += len(plan.events)
            done["faulted"] += 1
    check(fired > 0, "compare-shard: the fault plans fired nothing")
    # one range that always fails: missing is that range, the counts are
    # those of the covered complement
    for steal, lanes in ((False, None), (True, 2)):
        sc = sharded(plans, 8, steal, lanes, on_exhausted="partial", max_retries=2)
        bad = sc.shard_spec(len(text)).ranges[3]

        def lossy(s, e, bad=bad, ov=sc.overlap):
            if bad[0] <= s < bad[1] and e - s > ov:  # bodies, never overlap prefixes
                raise IOError(f"range [{s}, {e}) is lost")
            return text[s:e]

        res = sc.count_many(lossy, total_bytes=len(text))
        check(res.missing == (bad,), f"partial steal={steal}: missing {res.missing} != {bad}")
        hold(res.counts, covered_counts(port, plans, text, res.covered, chunk), f"partial steal={steal}")
        done["partial"] += 1
    # a remote range reader over a fake object store with injected faults
    for steal, lanes in ((False, None), (True, 2)):
        store = port.remote.FakeObjectStore(text, plan=fi.FaultPlan(seed, read_error_rate=0.1,
                                                                     truncate_rate=0.1, attempts_per_fault=1))
        reader = store.reader(part_bytes=128 * 1024, retries=3, sleep=lambda s: None)
        hold(sharded(plans, 8, steal, lanes, max_retries=2).count_many(reader), want,
             f"remote steal={steal}")
        check(reader.stats.retries > 0, "compare-shard: the remote store injected no fault")
        done["remote"] += 1
    # the halo-exchange scan, 8 shards on one card, shards narrower than m - 1 too
    gen = np.random.RandomState(seed + 17)
    for text in (torch.from_numpy(host[: sizes["distributed"]].copy()).to(DEVICE),
                 torch.from_numpy(host[:64].copy()).to(DEVICE)):
        find = port.distributed.make_distributed_find([DEVICE] * 8)
        count = port.distributed.make_distributed_count([DEVICE] * 8)
        for m in (2, 3, 4, 8, 9, 16, 17, 32, 64):
            s = int(gen.randint(0, text.numel() - m + 1))
            p = text[s : s + m].clone()
            whole = port.epsm.find(text, p)
            got = find(text, p)
            torch.cuda.synchronize()
            check(torch.equal(got, whole), f"distributed find n={text.numel()} m={m} != epsm.find")
            check(int(count(text, p)) == int(whole.sum()), f"distributed count n={text.numel()} m={m}")
            done["distributed"] += 1
    return {"cases": done, "steal_events": steals, "faults_fired": fired, "max_abs_err": 0}


def gbps(n: int, wall: float) -> float:
    return n / wall / 1e9


def main_shard(torch, np, port: Port, seed: int, host, pats, sizes: dict, smi: str) -> dict:
    """The sharded stream at full size: the main stream's 4 GiB host genome
    and 112 patterns through ShardedStreamScanner at 8 shards on the card
    (static, and stealing at 2 and 4 lanes), faulted, remote and positions
    runs, two processes in one gloo group, and the halo-exchange count on
    1 GiB; every run between a counter reset and a counter read, every
    answer held against a single StreamScanner (or epsm.count)."""
    engine, stream, ss, fi = port.engine, port.stream, port.shard_stream, port.fi
    plans = engine.compile_patterns(pats, device=DEVICE)
    out = {}
    launches = {name: 0 for name in port.wrappers}
    builds = [0]
    build_entry = port.ms_kernel._build_entry

    def counted_build(plans_, spec):
        builds[0] += 1
        return build_entry(plans_, spec)

    def run(label, make, fn, n):
        """make() builds the scanner (its megascan tables counted), fn(sc)
        is timed between a counter reset and a counter read."""
        torch.cuda.synchronize()
        port.reset_launches()
        builds[0] = 0
        sc = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(sc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = port.launches()
        if not label.startswith("single"):  # the single scanner runs are the comparisons
            for name, v in got.items():
                launches[name] += v
        out[label] = {"bytes": n, "wall_s": wall, "GB_per_s": gbps(n, wall), "table_builds": builds[0],
                      "launches": {k: v for k, v in got.items() if v},
                      "dispatch_count": getattr(sc, "dispatch_count", None)}
        return sc, res

    def sharded(n_shards=8, **kw):
        return lambda: ss.ShardedStreamScanner(plans, n_shards, "auto", devices=[DEVICE], **kw)

    port.ms_kernel._build_entry = counted_build
    try:
        n = sizes["genome"]
        single, want = run("single", lambda: stream.StreamScanner(plans, "auto"),
                           lambda sc: sc.count_many(host[:n]), n)
        check(out["single"]["table_builds"] == 1, "single: megascan tables built more than once")
        for label, kw in (("sharded8", {}), ("steal2", {"steal": True, "steal_workers": 2}),
                          ("steal4", {"steal": True, "steal_workers": 4})):
            sc, got = run(label, sharded(**kw), lambda sc: sc.count_many(host[:n]), n)
            check(np.array_equal(got, want), f"{label}: counts != single StreamScanner")
            ms = out[label]["launches"].get("megascan", 0)
            check(ms == sc.dispatch_count, f"{label}: megascan launches {ms} != dispatches {sc.dispatch_count}")
            check(out[label]["table_builds"] == 1, f"{label}: megascan tables built {builds[0]} times")
            out[label]["steal_events"] = len(sc.steal_events)
            if label == "sharded8":
                expect = shard_windows(sc.shard_spec(n), single.window_bytes, single.step_bytes)
                check(ms == expect, f"sharded8: launches {ms} != windows of the shards {expect}")
                out[label]["windows"] = expect
            emit({"phase": "main-shard", "run": label, **out[label], "single_GB_per_s": out["single"]["GB_per_s"],
                  "card": smi})
        # the stealing run, traced with fenced spans, through the validator
        rec = port.Recorder(enabled=True, fence=True)
        sc, got = run("steal4_traced", sharded(steal=True, steal_workers=4, recorder=rec),
                      lambda sc: sc.count_many(host[:n]), n)
        check(np.array_equal(got, want), "traced steal: counts != single")
        done = sorted((e["start"], e["stop"]) for e in rec.events_named("range_done"))
        check(port.sharding.merge_ranges(done) == ((0, n),) and sum(e - s for s, e in done) == n,
              "range_done events do not tile the stream exactly once")
        trace = ROOT / "build" / "shard_trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        rec.export_trace(trace)
        val = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "validate_trace.py"), str(trace)],
                             capture_output=True, text=True, timeout=300)
        check(val.returncode == 0, f"shard trace validation failed: {val.stdout} {val.stderr}")
        emit({"phase": "main-shard", "run": "steal4_traced", **out["steal4_traced"],
              "range_done": len(done), "steal_events": len(sc.steal_events),
              "span_ms": rec.span_totals_ms(), "validate_trace": val.stdout.strip()})
        # 1 GiB through a seeded fault plan, stealing at 4 lanes
        nf = sizes["faulted"]
        _, want_f = run("single_1GiB", lambda: stream.StreamScanner(plans, "auto"),
                        lambda sc: sc.count_many(host[:nf]), nf)
        # every rate applies at every site (open, each 64 KiB piece, each
        # shard attempt): ~3 faults a 128 MiB shard, each rescanning its range
        plan = fi.FaultPlan(seed, read_error_rate=0.0005, truncate_rate=0.0005, latency_rate=0.001,
                            latency_s=0.01, crash_rate=0.0005, attempts_per_fault=1)
        sc, got = run("faulted", sharded(steal=True, steal_workers=4, max_retries=16, fault_plan=plan,
                                         backoff=port.ft.BackoffPolicy(base_s=0.0, jitter=0.0)),
                      lambda sc: sc.count_many(fi.FaultyRangeSource(host[:nf], plan)), nf)
        check(np.array_equal(got, want_f), "faulted: counts != single StreamScanner")
        ms = out["faulted"]["launches"].get("megascan", 0)
        check(ms >= sc.dispatch_count and plan.events, "faulted: launches < dispatches, or no fault fired")
        emit({"phase": "main-shard", "run": "faulted", **out["faulted"], "retries": len(sc.events),
              "faults": plan.counts_by_action(), "steal_events": len(sc.steal_events),
              "single_GB_per_s": out["single_1GiB"]["GB_per_s"]})
        # 1 GiB through a remote range reader over a fake object store
        store = port.remote.FakeObjectStore(host[:nf], plan=fi.FaultPlan(
            seed + 1, read_error_rate=0.01, truncate_rate=0.01, attempts_per_fault=1))
        reader = store.reader(retries=3, sleep=lambda s: None)
        sc, got = run("remote", sharded(max_retries=2), lambda sc: sc.count_many(reader), nf)
        check(np.array_equal(got, want_f), "remote: counts != single StreamScanner")
        emit({"phase": "main-shard", "run": "remote", **out["remote"],
              "reader": vars(reader.stats), "single_GB_per_s": out["single_1GiB"]["GB_per_s"]})
        # positions of 14 of the patterns over 256 MiB
        npos = sizes["positions"]
        subset = position_subset(pats)
        pplans = engine.compile_patterns(subset, device=DEVICE)
        _, want_pos = run("single_positions", lambda: stream.StreamScanner(pplans, "auto"),
                          lambda sc: sc.positions_many(host[:npos]), npos)
        _, got_pos = run("positions", lambda: ss.ShardedStreamScanner(pplans, 8, "auto", devices=[DEVICE]),
                         lambda sc: sc.positions_many(host[:npos]), npos)
        for row, (a, b) in enumerate(zip(got_pos, want_pos)):
            check(np.array_equal(a, b), f"positions row {row}: sharded != single")
        emit({"phase": "main-shard", "run": "positions", "patterns": len(subset), **out["positions"],
              "single_GB_per_s": out["single_positions"]["GB_per_s"],
              "positions": int(sum(len(r) for r in got_pos))})
        # two processes on the one card, one gloo group
        nc = sizes["children"]
        _, want_c = run("single_children", lambda: stream.StreamScanner(plans, "auto"),
                        lambda sc: sc.count_many(host[:nc]), nc)
        kids = shard_children(np, host[:nc], pats, subset, npos)
        for rank, got in enumerate(kids["results"]):
            check(np.array_equal(got["counts"], want_c), f"child {rank}: counts != single StreamScanner")
            for row, (a, b) in enumerate(zip(got["positions"], want_pos)):
                check(np.array_equal(a, b), f"child {rank}: positions row {row} != single")
            check(got["launches"] == got["dispatch_count"], f"child {rank}: launches != dispatches")
            for name, v in got["every"].items():
                launches[name] += v
        spec = ss.ShardedStreamScanner(plans, 8, single.chunk_bytes, devices=[DEVICE]).shard_spec(nc)
        expect = shard_windows(spec, single.window_bytes, single.step_bytes)
        check(sum(g["dispatch_count"] for g in kids["results"]) == expect,
              "two processes: their dispatches are not the windows of the 8 shards")
        emit({"phase": "main-shard", "run": "two_processes", "bytes": nc, "wall_s": kids["wall_s"],
              "scan_s": [g["scan_s"] for g in kids["results"]],
              "GB_per_s": gbps(nc, max(g["scan_s"] for g in kids["results"])),
              "single_GB_per_s": out["single_children"]["GB_per_s"],
              "dispatch_count": [g["dispatch_count"] for g in kids["results"]],
              "megascan_launches": [g["launches"] for g in kids["results"]], "windows": expect,
              "child_launches": [g["every"] for g in kids["results"]]})
    finally:
        port.ms_kernel._build_entry = build_entry
    # the halo-exchange count on 1 GiB: 8 shards on the card, one of each EPSM kernel
    nd = sizes["distributed"]
    text = torch.from_numpy(host[:nd]).to(DEVICE)
    count = port.distributed.make_distributed_count([DEVICE] * 8)
    dist_runs = {}
    for m in (3, 8, 32):
        (q,) = port.corpus.extract_patterns(host[:nd], m, 1, seed=700 + m)
        p = torch.from_numpy(q.copy()).to(DEVICE)
        algo = port.epsm.select_algo(m)
        _, got = run(f"distributed_m{m}", lambda: None, lambda _: count(text, p), nd)
        want = int(port.epsm.count(text, p))
        epsm_launches = out[f"distributed_m{m}"]["launches"]
        check(epsm_launches == {algo: 8}, f"distributed m={m}: launches {epsm_launches} != {{{algo}: 8}}")
        check(int(got) == want >= 1, f"distributed m={m}: {int(got)} != epsm.count {want} (or 0)")
        dist_runs[m] = {"count": want, "wall_s": out[f"distributed_m{m}"]["wall_s"], "launches": epsm_launches}
    emit({"phase": "main-shard", "run": "distributed", "bytes": nd, "shards": 8, "runs": dist_runs})
    del text
    return {"launches": launches, "runs": out}


SHARD_CHILD_TIMEOUT_S = 300


def shard_children(np, text, pats, subset, npos: int) -> dict:
    """Start two children of this script, one gloo group on 127.0.0.1, each
    scanning its shards (i % 2 == rank) of ``text`` (a file they read) on
    the card; returns what each wrote.  A child that fails or outlasts its
    timeout fails the phase; none outlives this call."""
    import socket

    work = ROOT / "build" / "shard_children"
    work.mkdir(parents=True, exist_ok=True)
    (work / "genome.bin").write_bytes(text.tobytes())
    np.savez(work / "patterns.npz", n=len(pats), subset=len(subset), npos=npos,
             **{f"p{i}": p for i, p in enumerate(pats)}, **{f"s{i}": p for i, p in enumerate(subset)})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    t0 = time.perf_counter()
    logs = [open(work / f"rank{rank}.log", "w") for rank in range(2)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--shard-child", str(rank),
                               "--coordinator", f"127.0.0.1:{port_no}", "--child-dir", str(work)],
                              stdout=logs[rank], stderr=subprocess.STDOUT)
             for rank in range(2)]
    try:
        deadline = time.perf_counter() + SHARD_CHILD_TIMEOUT_S
        for rank, proc in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = None
            log = (work / f"rank{rank}.log").read_text()[-4000:]
            check(rc == 0, f"shard child {rank} exited {rc} (None: timed out): {log}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    results = []
    for rank in range(2):
        z = np.load(work / f"rank{rank}.npz")
        results.append({"counts": z["counts"], "positions": np.split(z["positions"], np.cumsum(z["lens"])[:-1]),
                        "launches": int(z["launches"]), "dispatch_count": int(z["dispatch_count"]),
                        "scan_s": float(z["scan_s"]),
                        "every": {str(k): int(v) for k, v in zip(z["names"], z["every"]) if v}})
    for f in work.iterdir():
        f.unlink()
    work.rmdir()
    return {"results": results, "wall_s": wall}


def shard_child(args) -> int:
    """One rank of the two-process run: join the gloo group, scan this
    rank's shards of the genome file (counts, then positions of the subset
    over its first bytes), write the merged answers for the parent."""
    import numpy as np

    port = Port()
    work = Path(args.child_dir)
    z = np.load(work / "patterns.npz")
    pats = [z[f"p{i}"] for i in range(int(z["n"]))]
    subset = [z[f"s{i}"] for i in range(int(z["subset"]))]
    rank, world = port.mesh.init_stream_cluster(args.coordinator, 2, args.shard_child)
    check((rank, world) == (args.shard_child, 2), f"child joined as {(rank, world)}")
    plans = port.engine.compile_patterns(pats, device=DEVICE)
    sc = port.shard_stream.ShardedStreamScanner(plans, 8, "auto", devices=[DEVICE])
    port.reset_launches()
    t0 = time.perf_counter()
    counts = sc.count_many(work / "genome.bin")
    scan_s = time.perf_counter() - t0
    launches = port.launches()["megascan"]
    pplans = port.engine.compile_patterns(subset, device=DEVICE)
    pos = port.shard_stream.ShardedStreamScanner(pplans, 8, "auto", devices=[DEVICE]).positions_many(
        work / "genome.bin", total_bytes=int(z["npos"]))
    every = port.launches()  # the count and the positions runs
    np.savez(work / f"rank{rank}.npz", counts=counts, positions=np.concatenate(pos),
             lens=np.asarray([len(p) for p in pos]), launches=launches, dispatch_count=sc.dispatch_count,
             scan_s=scan_s, names=np.asarray(list(every)), every=np.asarray(list(every.values())))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# The byte-level LM serving path and the data pipeline (compare-lm, main-lm,
# main-pipeline)
# ---------------------------------------------------------------------------

# compare-lm's tolerances, max |card - CPU| <= tol * max |CPU|.  Float32
# with TF32 off on both sides, where only summation order and exp / rsqrt
# differ (readings 1.5-2.5e-6; a TF32 product would miss it by 100x):
LM_TOL = 1e-5
# The int8 decode, each side from its own int8 caches: a value within an ulp
# of a rounding tie lands one int8 step apart, and the PV product casts
# p * v_scale and V to bfloat16 (2^-8 relative), so one ulp of float32 can
# become one of bfloat16 (readings 4.2e-4 to 7.3e-4, about 3x headroom):
LM_TOL_Q8 = 2e-3
LM_PROMPT_BYTES = 128


def lm_config(port: Port, arch: str, **kw):
    """A registered LM architecture at full width, fields replaced by kw."""
    return dataclasses.replace(port.configs.get_arch(arch).make_config(), **kw)


def held(torch, got, want, what: str, tol: float = LM_TOL) -> float:
    """max |card - CPU| / max |CPU| (both read as float32 on the host),
    checked against tol."""
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    check(err <= tol, f"{what}: max |card - cpu| / max |cpu| = {err} > {tol}")
    return err


def greedy_agree(torch, card_logits, cpu_logits, what: str, tol: float) -> int:
    """Equal argmax wherever the CPU's top-2 gap exceeds tol; returns how
    many rows that held for."""
    top2 = cpu_logits.topk(2, dim=-1).values
    scale = float(cpu_logits.abs().max())
    decided = (top2[:, 0] - top2[:, 1]) > tol * scale
    same = card_logits.cpu().argmax(-1) == cpu_logits.argmax(-1)
    check(bool(same[decided].all()), f"{what}: greedy tokens differ where the top-2 gap is wide")
    return int(decided.sum())


def moe_layer0_dispatch(torch, port: Port, params, cfg, tok):
    """Layer 0's MoE dispatch one-hots for the prefill tokens: the routing
    the prefill runs, recomputed from its inputs."""
    tf, moe = port.tf, port.lm_moe
    lp = params["layers"][0]
    h = params["embed"][tok.long()].to(port.lm_common.dtype_of(cfg.dtype))
    h, _ = tf._attn_block(h, lp, cfg, torch.arange(tok.shape[1], device=h.device))
    x = port.lm_common.rmsnorm(h, lp["ln2"], cfg.norm_eps).reshape(-1, cfg.d_model)
    g = min(cfg.moe_group, x.shape[0])
    logits = x.float().reshape(-1, g, cfg.d_model) @ lp["moe"]["router"]
    dispatch, _, _ = moe._route(logits, cfg.moe_cfg, moe.capacity(cfg.moe_cfg, g))
    return dispatch


def lm_compare_one(torch, np, port: Port, label: str, cfg, tokens, steps: int, seed: int) -> dict:
    """Prefill, `steps` decode_steps and `steps` decode_step_q8s of one model
    on the card and on the CPU from the same parameters (drawn on the card
    from `seed`, copied to the host), fed the same tokens (the CPU's greedy
    choice); logits and caches held within LM_TOL, each side's int8 caches
    within one step and its int8 decode, from its own caches, within
    LM_TOL_Q8."""
    tf = port.tf
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, device=DEVICE)
    host = port.lm_common.tree_map(lambda t: t.cpu(), params)
    tok = torch.from_numpy(tokens)
    B, S = tok.shape
    row = {"model": label, "params": port.lm_common.param_count(params), "batch": B, "seq": S}
    lg, kc, vc = tf.prefill(params, cfg, tok.to(DEVICE))
    lh, kh, vh = tf.prefill(host, cfg, tok)
    errs = {"prefill_logits": held(torch, lg, lh, f"{label} prefill logits"),
            "kcache": held(torch, kc, kh, f"{label} prefill kcache"),
            "vcache": held(torch, vc, vh, f"{label} prefill vcache")}
    if cfg.is_moe:
        dc = moe_layer0_dispatch(torch, port, params, cfg, tok.to(DEVICE))
        dh = moe_layer0_dispatch(torch, port, host, cfg, tok)
        check(torch.equal(dc.cpu(), dh), f"{label}: layer-0 MoE dispatch differs")
        dropped = cfg.moe_top_k * B * S - int(dh.sum())
        check(dropped > 0, f"{label}: no token was dropped")
        row["layer0_dropped_assignments"] = dropped
    caches = {}
    for side, dev, k, v in (("card", DEVICE, kc, vc), ("cpu", "cpu", kh, vh)):
        kf, vf = tf.make_cache(cfg, B, S + steps, torch.float32, device=dev)
        kf[:, :, :S], vf[:, :, :S] = k, v
        caches[side] = {"fp": (kf, vf), "q8": tf.quantize_cache(kf, vf)}
    # a value within a few ulps of a rounding tie may land one int8 step
    # apart; each side then decodes from its own int8 caches
    steps_apart = [(caches["card"]["q8"][i]["q"].cpu().int() - caches["cpu"]["q8"][i]["q"].int()).abs()
                   for i in (0, 1)]
    q8_diff = max(int(d.max()) for d in steps_apart)
    check(q8_diff <= 1, f"{label}: quantized prefill caches differ by {q8_diff} steps")
    row["q8_cache_max_step_diff"] = q8_diff
    row["q8_cache_values_apart"] = sum(int((d > 0).sum()) for d in steps_apart)
    row["q8_cache_values"] = sum(d.numel() for d in steps_apart)
    for i, name in ((0, "kscale"), (1, "vscale")):
        held(torch, caches["card"]["q8"][i]["scale"], caches["cpu"]["q8"][i]["scale"],
             f"{label} prefill {name}")
    decided = {}
    for mode, step_fn, tol in (("fp", tf.decode_step, LM_TOL), ("q8", tf.decode_step_q8, LM_TOL_Q8)):
        card_l, cpu_l = lg, lh
        worst, n_decided = 0.0, 0
        (kd, vd), (kcpu, vcpu) = caches["card"][mode], caches["cpu"][mode]
        for step in range(steps):
            nxt = cpu_l.argmax(-1)[:, None]
            card_l, kd, vd = step_fn(params, cfg, nxt.to(DEVICE), S + step, kd, vd)
            cpu_l, kcpu, vcpu = step_fn(host, cfg, nxt, S + step, kcpu, vcpu)
            worst = max(worst, held(torch, card_l, cpu_l, f"{label} {mode} decode step {step}", tol))
            n_decided += greedy_agree(torch, card_l, cpu_l, f"{label} {mode} decode step {step}", tol)
        errs[f"decode_{mode}"] = worst
        decided[mode] = n_decided
    del params, host, caches
    torch.cuda.empty_cache()
    return {**row, "max_rel_err": errs, "greedy_rows_compared": decided,
            "seconds": round(time.perf_counter() - t0, 3)}


def compare_lm(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """The LM path on the card against its own plain run on the CPU: full
    smollm-135m (byte vocab, float32) and phi3.5-moe at full width cut to
    sizes["moe_layers"] layers, B = 4 prompts of 128 english bytes after BOS;
    the MoE's last two rows repeat one byte, so layer 0 routes most of their
    tokens alike and drops past capacity."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    english = port.corpus.english(MIB, seed)
    B, S = 4, LM_PROMPT_BYTES
    rows = np.stack([english[i * 4096 : i * 4096 + S] for i in range(B)]).astype(np.int64)
    tokens = np.concatenate([np.full((B, 1), port.pipeline.BOS), rows], axis=1)
    moe_tokens = tokens.copy()
    moe_tokens[2:, 1:] = ord("e")
    out = [lm_compare_one(torch, np, port, "smollm-135m",
                          lm_config(port, "smollm-135m", vocab=port.pipeline.VOCAB,
                                    dtype="float32", param_dtype="float32"),
                          tokens, sizes["steps"], seed),
           lm_compare_one(torch, np, port, f"phi3.5-moe-42b-a6.6b, {sizes['moe_layers']} layer(s)",
                          lm_config(port, "phi3.5-moe-42b-a6.6b", n_layers=sizes["moe_layers"],
                                    dtype="float32", param_dtype="float32"),
                          moe_tokens, sizes["steps"], seed + 1)]
    return {"models": out, "tolerance": LM_TOL, "tolerance_q8": LM_TOL_Q8}


def profile_units(torch, fn, units: int) -> dict:
    """Where `units` calls of fn spend their time: the host wall a call
    (unprofiled, synchronized), and from one torch.profiler pass over
    `units` more calls the device time, kernel launches and host syncs a
    call, the device's idle share (1 - device / wall) and the operators
    with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(units):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / units
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(units):
            fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    # the device's own events (kernels, copies, fills); an operator's self
    # device time repeats its kernels' and is not summed again
    device_ms = sum(e.self_device_time_total for e in ev
                    if e.device_type == DeviceType.CUDA) / 1e3 / units
    launches = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                     "cuLaunchKernelEx", "cudaLaunchKernelExC"))
    syncs = sum(e.count for e in ev if e.key == "cudaStreamSynchronize")
    top = sorted((e for e in ev if e.device_type != DeviceType.CUDA and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms) if device_ms else None,
            "launches": launches / units, "stream_syncs": syncs / units,
            "top_device_ms": [[e.key[:48], e.count / units, e.self_device_time_total / 1e3 / units]
                              for e in top]}


def first_end(text: bytes, stop: bytes, k: int):
    """The end of the first window of `text` within k mismatches of `stop`
    (k = 0: bytes.find), or None."""
    m = len(stop)
    if k == 0:
        i = text.find(stop)
        return None if i < 0 else i + m
    for e in range(m, len(text) + 1):
        if sum(a != b for a, b in zip(text[e - m : e], stop)) <= k:
            return e
    return None


def stop_oracle(text: bytes, stops, k: int):
    """(end, stop index) of the stop that ends first in `text`, the first
    in stop order on a tie; None if none occurs."""
    best = None
    for si, s in enumerate(stops):
        e = first_end(text, s, k)
        if e is not None and (best is None or e < best[0]):
            best = (e, si)
    return best


def check_stops(base, res, stops, k: int, new: int, what: str) -> int:
    """Each row stopped where the oracle says, on the stop it names; returns
    the decode steps the engine took (the last row's last step + 1).  In
    the run without stops a row ends on BOS (not in its text) or after
    `new` tokens."""
    last = 0
    for b, (r0, r) in enumerate(zip(base, res)):
        hit = stop_oracle(r0.text, stops, k)
        if hit is None:
            check(r.text == r0.text and r.stopped_by is None, f"{what}: row {b} stopped")
            done = min(len(r0.text), new - 1)
        else:
            e, si = hit
            check(r.text == r0.text[:e], f"{what}: row {b} text")
            check(r.stopped_by == stops[si], f"{what}: row {b} stopped by {r.stopped_by!r}")
            done = e - 1
        last = max(last, done)
    return last + 1


def cut_stop(text: bytes, m: int, at: int):
    return None if len(text) < m else text[min(at, len(text) - m) :][:m]


def main_lm(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """ServeEngine.generate on the card at full smollm-135m width (bfloat16,
    byte vocab): 8 requests of 512 english bytes, 256 new tokens, max_len
    1024.  Greedy with no stops; again with each row's own 2-, 6- and
    20-byte substrings as stops (every row must stop at the step and on the
    stop bytes.find names in the first run's output), and with the 6- and
    20-byte ones alone; again with the 6-byte ones one byte changed at
    stop_k = 1 (a Hamming oracle); and twice at temperature 0.7 from one
    seed (equal tokens)."""
    B, new, max_len = sizes["batch"], sizes["new_tokens"], sizes["max_len"]
    cfg = lm_config(port, "smollm-135m", vocab=port.pipeline.VOCAB)
    params = port.tf.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, device=DEVICE)
    eng = port.serve_engine.ServeEngine(params, cfg, max_len=max_len, device=DEVICE)
    english = port.corpus.english(4 * MIB, seed + 2)
    prompts = [english[i * 65536 : i * 65536 + sizes["prompt"]].tobytes() for i in range(B)]
    eng.generate(prompts, max_new_tokens=4)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = eng.generate(prompts, max_new_tokens=new)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    generated = sum(len(r.text) for r in base)

    out = {"phase": "main-lm", "model": "smollm-135m", "dtype": cfg.dtype, "batch": B,
           "prompt_bytes": sizes["prompt"], "new_tokens": new, "max_len": max_len,
           "generated_tokens": generated, "wall_s": wall, "tokens_per_s": generated / wall,
           "peak_device_gib": peak / GIB, "launches": {}}
    runs = {}
    stops = [s for r in base for s in (cut_stop(r.text, 2, 60), cut_stop(r.text, 6, 120),
                                        cut_stop(r.text, 20, 200)) if s is not None]
    fuzzy = []
    for r in base:
        s = cut_stop(r.text, 6, 120)
        if s is not None:
            fuzzy.append(s[:2] + bytes([s[2] ^ 0x20]) + s[3:])
    check(len(stops) > 0 and len(fuzzy) > 0, "main-lm: outputs too short for stop strings")
    # the 2-byte stops tend to fire first; a run without them lets the 6-
    # and 20-byte ones stop rows too
    long_stops = [s for s in stops if len(s) > 2]
    for name, ss, k in (("stops", stops, 0), ("long_stops", long_stops, 0), ("fuzzy", fuzzy, 1)):
        rec = port.Recorder(enabled=True, fence=True)
        port.reset_launches()
        res = eng.generate(prompts, max_new_tokens=new, stop_strings=ss, stop_k=k, recorder=rec)
        launches = port.launches()
        steps = check_stops(base, res, ss, k, new, f"main-lm {name}")
        summ = rec.summary()
        hist = rec.metrics.summary()["histograms"]
        dispatches = summ["metrics"]["counters"]["stop_scan_dispatches"]
        check(dispatches == summ["spans"]["stop_scan"]["count"] == steps,
              f"main-lm {name}: {dispatches} stop scans for {steps} steps")
        # one 'b' group of 6-byte stops: one multipattern (k = 0) or approx
        # (k = 1) launch a scan
        want = {"multipattern": steps if k == 0 else 0, "approx": steps if k else 0}
        got = {key: launches[key] for key in want}
        check(got == want, f"main-lm {name}: launches {got} != {want}")
        for key, v in got.items():
            out["launches"][key] = out["launches"].get(key, 0) + v
        runs[name] = {"stops": len(ss), "k": k, "steps": steps,
                      "stopped_rows": sum(r.stopped_by is not None for r in res),
                      "stopped_by_len": sorted({len(r.stopped_by) for r in res if r.stopped_by}),
                      "prefill_ms": summ["spans"]["prefill"]["total_ms"],
                      "decode_ms_per_step": hist["span/decode"]["p50"] * 1e3,
                      "stop_scan_ms_per_step": hist["span/stop_scan"]["p50"] * 1e3,
                      "stop_scan_ms_mean": summ["spans"]["stop_scan"]["total_ms"] / steps,
                      "launches": launches}
    sampled = [eng.generate(prompts, max_new_tokens=new, temperature=0.7, seed=seed + 3)
               for _ in range(2)]
    check([r.text for r in sampled[0]] == [r.text for r in sampled[1]], "main-lm: sampling repeats")
    check([r.text for r in sampled[0]] != [r.text for r in base], "main-lm: sampling is greedy")
    out.update(runs=runs, sampled_tokens=sum(len(r.text) for r in sampled[0]))

    # where a decode step and a stop scan spend their time: decode_step on
    # the prompts' prefill cache, 16 steps a pass; the stop scan of the
    # first stops run's strings on random bytes
    tf = port.tf
    tok = np.stack([np.concatenate([[port.pipeline.BOS], np.frombuffer(p, np.uint8)])
                    for p in prompts]).astype(np.int64)
    tok = torch.from_numpy(tok).to(DEVICE)
    logits, kc, vc = tf.prefill(params, cfg, tok)
    kf, vf = tf.make_cache(cfg, B, max_len, device=DEVICE)
    S = tok.shape[1]
    kf[:, :, :S], vf[:, :, :S] = kc, vc
    state = {"pos": S, "nxt": logits.argmax(-1)[:, None]}

    def decode():
        if state["pos"] == max_len:  # rewind: the cache past S is rewritten
            state["pos"] = S
        lg, _, _ = tf.decode_step(params, cfg, state["nxt"], state["pos"], kf, vf)
        state["nxt"] = lg.argmax(-1)[:, None]
        state["pos"] += 1

    sc = port.serve_engine.StopScanner(stops, B, new, device=DEVICE)
    rand = np.random.RandomState(seed).randint(0, 256, size=(4096, B)).astype(np.int32)
    step = iter(range(4096))

    def scan():
        i = next(step)
        sc.scan(rand[i], i)

    out["profile"] = {"decode_step": profile_units(torch, decode, 16),
                      "stop_scan": profile_units(torch, scan, 16)}
    del eng, params, kf, vf, kc, vc
    torch.cuda.empty_cache()
    return emit(out)


# ---- main-pipeline ----------------------------------------------------------

PIPE_LENGTHS = tuple(range(4, 33))
PIPE_LIVE = 8  # patterns kept verbatim, and patterns with one byte changed


def pipeline_blocklist(np, text, P: int, seed: int):
    """P english patterns of m 4..32 drawn from `text`, evenly over the
    lengths (141-142 a length at P = 4096, so every EPSMb and EPSMc group is
    bucketed in the batch plans).  All but 2 x PIPE_LIVE of them get one
    byte in each half changed to an uppercase letter, which the english text
    never holds, so they hit nothing at k <= 1; PIPE_LIVE long ones (m >=
    20) stay verbatim (hits at k = 0) and PIPE_LIVE get one such byte (hits
    at k = 1 only)."""
    rng = np.random.RandomState(seed)
    n = len(PIPE_LENGTHS)
    per = {m: P // n + (i < P % n) for i, m in enumerate(PIPE_LENGTHS)}
    pats = []
    for m, count in per.items():
        for s in rng.randint(0, len(text) - m, size=count):
            pats.append(bytearray(text[s : s + m].tobytes()))
    long_ids = [i for i, p in enumerate(pats) if len(p) >= 20]
    live = rng.choice(long_ids, size=2 * PIPE_LIVE, replace=False)
    verbatim, one_typo = set(live[:PIPE_LIVE].tolist()), set(live[PIPE_LIVE:].tolist())
    for i, p in enumerate(pats):
        if i in verbatim:
            continue
        m = len(p)
        p[rng.randint(0, m // 2)] = ord("A") + rng.randint(26)
        if i not in one_typo:
            p[rng.randint(m // 2, m)] = ord("A") + rng.randint(26)
    return [bytes(p) for p in pats], sorted(verbatim), sorted(one_typo)


def pipeline_documents(np, corpus, seed: int, total: int, n_big: int, n_dups: int, plants,
                       max_len: int = 65536):
    """About `total` bytes of english cut into documents of 512 B - max_len
    (log-uniform seeded lengths), `n_big` of 1-4 MiB among them (> the
    pipeline's MAX_FILTER_LEN; two in the first fifth of the documents),
    each holding one of `plants` half a MiB or more in, and `n_dups`
    near-duplicates (a copy of an earlier document with three bytes changed)
    right after their originals.  The text is 16 MiB of corpus.english
    (four seeds) tiled."""
    base = np.concatenate([corpus.english(4 * MIB, seed + i) for i in range(4)])
    text = np.tile(base, -(-(total + 10 * 4 * MIB) // len(base)))
    rng = np.random.RandomState(seed)
    docs, o = [], 0
    while o < total:
        L = int(np.exp(rng.uniform(np.log(512), np.log(max_len))))
        docs.append(text[o : o + L])
        o += L
    spots = np.concatenate([rng.randint(0, len(docs) // 5, size=min(n_big, 2)),
                            rng.randint(0, len(docs), size=max(n_big - 2, 0))])
    for j, at in enumerate(sorted(spots)[::-1]):
        L = int(rng.randint(MIB, 4 * MIB + 1))
        big = text[o : o + L].copy()
        o += L
        p = np.frombuffer(plants[j % len(plants)], np.uint8)
        at_byte = int(rng.randint(MIB // 2, L - len(p)))
        big[at_byte : at_byte + len(p)] = p
        docs.insert(int(at), big)
    for at in sorted(rng.randint(0, len(docs), size=n_dups))[::-1]:
        dup = docs[at].copy()
        dup[rng.randint(0, len(dup), size=3)] ^= 1
        docs.insert(int(at) + 1, dup)
    return docs


def oracle_blocked(np, docs, pats, k: int) -> np.ndarray:
    """Independent host verdicts: document i is blocked iff some pattern
    occurs in it within k mismatches.  k = 0: Python `in` per pattern and
    document; k = 1: a numpy Hamming slide of each pattern over the
    documents joined (the first min(m, 4) bytes, then the whole pattern at
    the windows that pass), windows inside one document only.  A pattern
    holding more than k bytes that occur in no document cannot occur and is
    skipped."""
    present = np.zeros(256, bool)
    for d in docs:
        present |= np.bincount(d, minlength=256) > 0
    live = [p for p in pats if int((~present[np.frombuffer(p, np.uint8)]).sum()) <= k]
    blocked = np.zeros(len(docs), bool)
    if k == 0:
        for i, d in enumerate(docs):
            b = d.tobytes()
            blocked[i] = any(p in b for p in live)
        return blocked
    joined = np.concatenate(docs)
    starts = np.cumsum([0] + [len(d) for d in docs])
    for p in live:
        pa = np.frombuffer(p, np.uint8)
        m = len(pa)
        N = len(joined) - m + 1
        if N <= 0:
            continue
        head = np.zeros(N, np.uint8)
        for j in range(min(m, 4)):
            head += joined[j : j + N] != pa[j]
        cand = np.flatnonzero(head <= k)
        mism = np.zeros(len(cand), np.int64)
        for j in range(m):
            mism += joined[cand + j] != pa[j]
        pos = cand[mism <= k]
        doc = np.searchsorted(starts, pos, side="right") - 1
        inside = pos + m <= starts[doc + 1]
        blocked[doc[inside]] = True
    return blocked


def oracle_duplicates(np, docs, kbits: int) -> np.ndarray:
    """Independent host dedup of `docs`, in order.  A document's signature
    is the set of kbits-bit hashes of its aligned 8-byte blocks, each block
    dotted with fixed odd weights (drawn here again from their seed, 12345,
    as the pipeline's `fingerprint_weights(8)`) in uint64; a document is a
    duplicate when it shares more than 0.9 of its signature with one kept
    before it, of the last 4096 kept (cut to the last 2048 past that); an
    empty signature is never a duplicate and is not kept."""
    rs = np.random.RandomState(12345)
    w = ((rs.randint(1, 2**31 - 1, size=8).astype(np.int64) * 2 + 1) & 0x7FFFFFFF).astype(np.uint64)
    mask = np.uint64((1 << kbits) - 1)
    seen, dup = [], np.zeros(len(docs), bool)
    for i, d in enumerate(docs):
        n = len(d) // 8 * 8
        sig = set(((d[:n].reshape(-1, 8).astype(np.uint64) @ w) & mask).tolist())
        if not sig:
            continue
        if any(len(sig & s) / len(sig) > 0.9 for s in seen):
            dup[i] = True
            continue
        seen.append(sig)
        if len(seen) > 4096:
            seen = seen[-2048:]
    return dup


def repack(np, port: Port, docs, blocked, dedup: bool, seq: int, batch: int):
    """The host's packing of the kept documents, deduplicated by
    oracle_duplicates: (stats, flat tokens of the whole batches)."""
    pl = port.pipeline
    kept = [d for d, b in zip(docs, blocked) if not b]
    dup = oracle_duplicates(np, kept, port.epsm.EPSMC_KBITS) if dedup else np.zeros(len(kept), bool)
    out = [d for d, x in zip(kept, dup) if not x]
    stats = pl.PipelineStats(docs_in=len(docs), docs_blocked=int(blocked.sum()),
                             docs_deduped=len(kept) - len(out), docs_out=len(out))
    flat = np.concatenate([np.concatenate([[pl.BOS], d.astype(np.int32)]) for d in out])
    need = batch * (seq + 1)
    return stats, flat[: len(flat) // need * need].reshape(-1, batch, seq + 1)


class RouteSpies:
    """Counts the engine routes a blocklist dispatch takes while installed."""

    ROUTES = (("engine", "_automaton_counts", "automaton"),
              ("engine", "_b_count_rows_csr", "b_sparse_csr"),
              ("engine", "_count_b_slot_dense", "b_slot_dense"),
              ("engine", "_dense_count", "dense"),
              ("engine", "_c_verify_csr", "c_csr"),
              ("engine", "_c_verify", "c_flat"),
              ("counting", "_approx_verify_counts", "approx_sparse"),
              ("counting", "_dense_count_approx", "approx_dense"))

    def __init__(self, port: Port):
        self.mods = {"engine": port.engine, "counting": port.counting}
        self.calls = {label: 0 for _, _, label in self.ROUTES}
        self.orig = {}

    def __enter__(self):
        for mod, name, label in self.ROUTES:
            fn = getattr(self.mods[mod], name)
            self.orig[mod, name] = fn

            def spy(*a, _fn=fn, _label=label, **kw):
                self.calls[_label] += 1
                return _fn(*a, **kw)

            setattr(self.mods[mod], name, spy)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.orig.items():
            setattr(self.mods[mod], name, fn)
        return False


def record_filter_calls(ps, spies: RouteSpies) -> list:
    """Wraps a pipeline's PatternSet so that each filter call appends
    (kind, verdict, routes the spies saw) to the list returned."""
    calls = []
    orig_blocked, orig_stream = ps.blocked, ps.contains_any_stream

    def blocked(mat, lengths):
        before = dict(spies.calls)
        v = orig_blocked(mat, lengths)
        route = "+".join(r for r in spies.calls if spies.calls[r] > before[r]) or "none"
        calls.append(("batch", v.cpu().numpy(), route))
        return v

    def stream(d, chunk_bytes):
        hit = orig_stream(d, chunk_bytes=chunk_bytes)
        calls.append(("stream", hit, "stream"))
        return hit

    ps.blocked, ps.contains_any_stream = blocked, stream
    return calls


def filter_verdicts(np, pl, docs, calls, what: str) -> np.ndarray:
    """Each document's verdict from the filter calls a pipeline made over
    `docs`, in its order: FILTER_BATCH documents a group, one batch call for
    the group's documents up to MAX_FILTER_LEN, one stream call for each
    larger one."""
    verdict, it = np.zeros(len(docs), bool), iter(calls)
    for lo in range(0, len(docs), pl.FILTER_BATCH):
        group = range(lo, min(lo + pl.FILTER_BATCH, len(docs)))
        small = [i for i in group if len(docs[i]) <= pl.MAX_FILTER_LEN]
        if small:
            verdict[small] = next(it)[1][: len(small)]
        for i in group:
            if len(docs[i]) > pl.MAX_FILTER_LEN:
                verdict[i] = next(it)[1]
    check(next(it, None) is None, f"{what}: unmatched filter calls")
    return verdict


def run_pipeline(torch, np, port: Port, docs, pats, k: int, dedup: bool, seq: int, batch: int):
    """One LMDataPipeline pass on the card; returns its batches, stats, the
    verdict of every document as the filter gave it, the routes of every
    filter dispatch, launches and times."""
    pl = port.pipeline
    t0 = time.perf_counter()
    pipe = pl.LMDataPipeline(iter(docs), seq_len=seq, batch_size=batch, blocklist=pats,
                             dedup=dedup, blocklist_k=k, device=DEVICE)
    compile_s = time.perf_counter() - t0
    ps = pipe.pattern_set
    spies = RouteSpies(port)
    calls = record_filter_calls(ps, spies)
    torch.cuda.synchronize()
    port.reset_launches()
    with spies:
        t0 = time.perf_counter()
        batches = list(pipe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = port.launches()
    # one megascan launch a window of the oversize documents' stream scans
    stream_windows = sum(sc.dispatch_count for sc in ps._scanners.values())
    check(launches["megascan"] == stream_windows,
          f"main-pipeline: megascan {launches['megascan']} != {stream_windows} stream windows")
    stream_groups = len(ps._stream_plans) if ps._stream_plans is not None else 0
    verdict = filter_verdicts(np, pl, docs, calls, "main-pipeline")
    routes = {}
    for _, _, r in calls:
        routes[r] = routes.get(r, 0) + 1
    return {"batches": batches, "stats": pipe.stats, "verdict": verdict, "routes": routes,
            "route_calls": dict(spies.calls), "launches": launches, "wall_s": wall,
            "compile_s": compile_s, "stream_windows": stream_windows,
            "stream_groups": stream_groups}


def main_pipeline(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """LMDataPipeline on the card with a blocklist of 4096 english patterns
    of m 4..32: sizes["text"] of english in documents of 512 B - 64 KiB plus
    8 of 1-4 MiB (megascan through contains_any_stream) and 64
    near-duplicates; then the first sizes["k1_text"] of it at blocklist_k =
    1; then, with dedup, sizes["dedup_text"] in documents of 512 B - 16 KiB
    with 64 near-duplicates.  The first two runs leave dedup off: its 11-bit
    block signatures saturate on documents past ~32 KiB (every later one
    counts as a duplicate), and its host cost grows with documents x kept
    signatures.  Every document's verdict equals an independent host oracle
    (all documents); the stats and the packed batches equal the host's
    re-packing of the kept documents, deduplicated by oracle_duplicates."""
    pl, corpus = port.pipeline, port.corpus
    pats, verbatim, one_typo = pipeline_blocklist(np, corpus.english(4 * MIB, seed + 7), 4096, seed)
    # the oversize documents hold a verbatim pattern (a hit at k = 0) or a
    # one-typo pattern with its uppercase letter made 'e' (a hit at k = 1:
    # one mismatch left)
    plants = []
    for v, t in zip(verbatim, one_typo):
        plants.append(pats[v])
        plants.append(bytes(b if not 65 <= b <= 90 else ord("e") for b in pats[t]))
    t0 = time.perf_counter()
    docs = pipeline_documents(np, corpus, seed + 7, sizes["text"], 8, 64, plants)
    setup_s = time.perf_counter() - t0
    seq, batch = 2048, 8
    out = {"phase": "main-pipeline", "patterns": len(pats), "setup_s": setup_s, "runs": {}}
    k1_docs, total = [], 0
    for d in docs:
        if total >= sizes["k1_text"]:
            break
        k1_docs.append(d)
        total += len(d)
    dedup_docs = pipeline_documents(np, corpus, seed + 7, sizes["dedup_text"], 0, 64, plants,
                                    max_len=16384)
    for name, dd, k, dedup in (("k0", docs, 0, False), ("k1", k1_docs, 1, False),
                               ("dedup", dedup_docs, 0, True)):
        run = run_pipeline(torch, np, port, dd, pats, k, dedup, seq, batch)
        t0 = time.perf_counter()
        want = oracle_blocked(np, dd, pats, k)
        oracle_s = time.perf_counter() - t0
        bad = np.flatnonzero(run["verdict"] != want)
        check(bad.size == 0, f"main-pipeline {name}: {bad.size} verdicts differ from the oracle "
                             f"(first docs {bad[:5].tolist()})")
        check(0 < want.sum() < len(dd), f"main-pipeline {name}: {int(want.sum())} of {len(dd)} blocked")
        stats, flat = repack(np, port, dd, want, dedup, seq, batch)
        check(run["stats"] == stats, f"main-pipeline {name}: stats {run['stats']} != {stats}")
        if dedup:
            check(0 < stats.docs_deduped <= 2 * 64,
                  f"main-pipeline {name}: {stats.docs_deduped} deduplicated, 64 near-duplicates in")
        got = np.stack([np.concatenate([b["tokens"], b["targets"][:, -1:]], axis=1)
                        for b in run["batches"]]) if run["batches"] else flat[:0]
        check(got.shape == flat.shape and np.array_equal(got, flat),
              f"main-pipeline {name}: batches differ from the host re-packing")
        check(all(np.array_equal(b["targets"][:, :-1], b["tokens"][:, 1:]) for b in run["batches"]),
              f"main-pipeline {name}: targets are not the shifted tokens")
        n_bytes = sum(len(d) for d in dd)
        big = [d for d in dd if len(d) > pl.MAX_FILTER_LEN]
        launches = run["launches"]
        check(launches["megascan"] > 0 or not big, f"main-pipeline {name}: megascan never launched")
        # one approx launch a dense k-mismatch count, one acscan counts-mode
        # launch an automaton route
        calls = run["route_calls"]
        check(launches["approx"] == calls["approx_dense"],
              f"main-pipeline {name}: approx {launches['approx']} != {calls['approx_dense']} routes")
        check(launches["acscan_counts"] == calls["automaton"],
              f"main-pipeline {name}: acscan {launches['acscan_counts']} != {calls['automaton']} routes")
        out["runs"][name] = {
            "k": k, "dedup": dedup, "docs": len(dd), "bytes": n_bytes, "oversize_docs": len(big),
            "stats": dataclasses.asdict(run["stats"]), "batches": len(run["batches"]),
            "wall_s": run["wall_s"], "compile_s": run["compile_s"], "oracle_s": oracle_s,
            "docs_per_s": len(dd) / run["wall_s"], "source_GB_per_s": n_bytes / run["wall_s"] / 1e9,
            "routes": run["routes"], "route_calls": run["route_calls"],
            "stream_windows": run["stream_windows"], "stream_groups": run["stream_groups"],
            "launches": {key: launches[key] for key in ("acscan", "acscan_counts", "megascan",
                                                         "approx", "multipattern")}}
    # where a filter dispatch spends its time: PatternSet.blocked on 32
    # documents at a time, as the k = 0 run sends them
    ps = port.mp.PatternSet(pats, device=DEVICE)
    small = [d for d in docs if len(d) <= pl.MAX_FILTER_LEN]
    groups = [small[lo : lo + pl.FILTER_BATCH] for lo in range(0, len(small), pl.FILTER_BATCH)]
    calls = iter(range(1 << 30))

    def dispatch():
        group = groups[next(calls) % len(groups)]
        mat = np.zeros((pl.FILTER_BATCH, pl._bucket_len(max(len(d) for d in group))), np.uint8)
        lengths = np.zeros((pl.FILTER_BATCH,), np.int32)
        for row, d in enumerate(group):
            mat[row, : len(d)] = d
            lengths[row] = len(d)
        ps.blocked(mat, lengths).cpu()

    out["profile"] = {"filter_dispatch": profile_units(torch, dispatch, 8)}
    emit(out)
    total_launches = {}
    for r in out["runs"].values():
        for key, v in r["launches"].items():
            total_launches[key] = total_launches.get(key, 0) + v
    return {"launches": total_launches}


# ---- compare-train / main-train -------------------------------------------

# compare-train: max |card - CPU| / max |CPU| of the loss and of each
# gradient leaf (float32, TF32 off: only the order of the float32 sums and
# the exp / log / rsqrt implementations differ, over 30 layers forward and
# back), and of each parameter and moment after one AdamW update from the
# same gradients (a handful of element-wise float32 ops and one global-norm
# sum)
TRAIN_TOL = 1e-4
ADAM_TOL = 1e-5
TRAIN_BATCH, TRAIN_SEQ = 2, 128


def named_leaves(tree, prefix: str = ""):
    """(dotted path, tensor) of a nest of dicts / lists / NamedTuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from named_leaves(v, f"{prefix}.{k}" if prefix else str(k))


def tree_err(torch, got, want, what: str, tol: float) -> float:
    """The largest max |got - want| / max |want| over the leaves (each
    compared on the card), checked against tol."""
    worst = 0.0
    for (name, g), (wname, w) in zip(named_leaves(got), named_leaves(want)):
        check(name == wname and g.shape == w.shape, f"{what}: trees differ at {name}")
        if not w.numel():
            continue
        g, w = g.to(DEVICE).float(), w.to(DEVICE).float()
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        check(err <= tol, f"{what} {name}: max |card - cpu| / max |cpu| = {err} > {tol}")
        worst = max(worst, err)
    return worst


def same_bits(torch, a, b, what: str) -> int:
    """Checks two trees bit-equal, leaf by leaf; returns the leaf count."""
    n = 0
    for (name, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
        x, y = x.detach(), y.detach().to(x.device)
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        check(x.dtype == y.dtype and torch.equal(x, y), f"{what}: {name} differs")
        n += 1
    check(n > 0, f"{what}: no leaves")
    return n


def train_compare_one(torch, np, port: Port, label: str, cfg, batch, seed: int,
                      traj_steps: int, accum: bool) -> dict:
    """train_loss and every gradient leaf (remat on and off on the card,
    both held against one CPU run: remat recomputes the same float32 ops,
    so the CPU's answer is the same either way), one AdamW update from the
    CPU's gradients and a traj_steps-step make_train_step loss trajectory
    of one model on the card and on the CPU from the same parameters (drawn
    on the card from `seed`, copied to the host); with `accum`,
    grad_accum = 2 against 1 on the card.  `cpu_seconds` is the CPU side's
    share of the row's time."""
    tf, loop, opt, tree_map = port.tf, port.loop, port.opt, port.lm_common.tree_map
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, device=DEVICE)
    host = tree_map(lambda t: t.cpu(), params)
    cb = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    hb = {k: torch.from_numpy(v) for k, v in batch.items()}
    B, S = batch["tokens"].shape
    row = {"model": label, "params": port.lm_common.param_count(params), "batch": B, "seq": S}
    errs = {}
    tc = time.perf_counter()
    lh, grads = loop.value_and_grad(lambda p, b: tf.train_loss(p, cfg, b), host, hb)
    cpu_s = time.perf_counter() - tc
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        fn = lambda p, b, _c=c: tf.train_loss(p, _c, b)
        tag = "remat_on" if remat else "remat_off"
        lc, gc = loop.value_and_grad(fn, params, cb)
        errs[f"loss_{tag}"] = held(torch, lc, lh, f"{label} loss ({tag})", TRAIN_TOL)
        errs[f"grads_{tag}"] = tree_err(torch, gc, grads, f"{label} grad ({tag})", TRAIN_TOL)
        del gc
    if cfg.is_moe:
        tok = cb["tokens"]
        dc = moe_layer0_dispatch(torch, port, params, cfg, tok)
        dh = moe_layer0_dispatch(torch, port, host, cfg, tok.cpu())
        check(torch.equal(dc.cpu(), dh), f"{label}: layer-0 MoE dispatch differs")
        dropped = cfg.moe_top_k * B * S - int(dh.sum())
        check(dropped > 0, f"{label}: no token was dropped")
        row["layer0_dropped_assignments"] = dropped
    # one AdamW update, both sides from the CPU's gradients
    ocfg = opt.AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=traj_steps)
    g_card = tree_map(lambda t: t.to(DEVICE), grads)
    pc, sc, mc = opt.adamw_update(g_card, opt.adamw_init(params), params, ocfg)
    del g_card
    tc = time.perf_counter()
    ph, sh, mh = opt.adamw_update(grads, opt.adamw_init(host), host, ocfg)
    cpu_s += time.perf_counter() - tc
    del grads
    check(float(mc["lr"]) == float(mh["lr"]), f"{label}: AdamW lr differs")
    errs["adamw_grad_norm"] = held(torch, mc["grad_norm"], mh["grad_norm"],
                                   f"{label} AdamW grad norm", ADAM_TOL)
    errs["adamw_params"] = tree_err(torch, pc, ph, f"{label} AdamW params", ADAM_TOL)
    errs["adamw_m"] = tree_err(torch, sc.m, sh.m, f"{label} AdamW m", ADAM_TOL)
    errs["adamw_v"] = tree_err(torch, sc.v, sh.v, f"{label} AdamW v", ADAM_TOL)
    del pc, sc, host
    # the loss trajectory of traj_steps train steps on one batch; on the CPU
    # the first step (value_and_grad, then adamw_update: make_train_step at
    # grad_accum 1) is the update above, so its side goes on from there
    step_fn = loop.make_train_step(lambda p, b: tf.train_loss(p, cfg, b), ocfg)
    traj = {}
    for side, p, st, done, b in (("card", params, opt.adamw_init(params), [], cb),
                                 ("cpu", ph, sh, [float(lh)], hb)):
        tc = time.perf_counter()
        traj[side] = done
        for _ in range(traj_steps - len(done)):
            p, st, m = step_fn(p, st, b)
            traj[side].append(float(m["loss"]))
        del p, st
        if side == "cpu":
            cpu_s += time.perf_counter() - tc
    del ph, sh
    errs["trajectory"] = max(abs(a - b) / abs(b) for a, b in zip(traj["card"], traj["cpu"]))
    check(errs["trajectory"] <= TRAIN_TOL,
          f"{label}: loss trajectory {traj['card']} vs {traj['cpu']} > {TRAIN_TOL}")
    if accum:
        # grad_accum = 2 against 1 on the card: the gradients each step hands
        # to adamw_update (the mean of the microbatches' against the whole
        # batch's) and the loss within TRAIN_TOL; the parameters after the
        # step are a reading: AdamW's first step divides each gradient by its
        # own magnitude plus eps = 1e-8, so a gradient near eps moves its
        # parameter by a share of lr that its last bits decide
        acfg = opt.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
        fn = lambda p, b: tf.train_loss(p, cfg, b)
        st = opt.adamw_init(params)
        seen, real_update = [], loop.adamw_update

        def spy_update(g, *a, **kw):
            seen.append(g)
            return real_update(g, *a, **kw)

        loop.adamw_update = spy_update
        try:
            p1, _, m1 = loop.make_train_step(fn, acfg, grad_accum=1)(params, st, cb)
            p2, _, m2 = loop.make_train_step(fn, acfg, grad_accum=2)(params, st, cb)
        finally:
            loop.adamw_update = real_update
        errs["grad_accum_grads"] = tree_err(torch, seen[1], seen[0], f"{label} grad_accum 2 grads",
                                            TRAIN_TOL)
        errs["grad_accum_loss"] = held(torch, m2["loss"], m1["loss"], f"{label} grad_accum 2 loss",
                                       TRAIN_TOL)
        row["grad_accum_params_max_abs_diff"] = max(
            float((a.float() - b.float()).abs().max())
            for (_, a), (_, b) in zip(named_leaves(p1), named_leaves(p2)))
        row["grad_accum_lr"] = float(m1["lr"])
        del p1, p2, st, seen
    del params
    torch.cuda.empty_cache()
    return {**row, "max_rel_err": errs, "loss_cpu": float(lh), "trajectory": traj,
            "seconds": round(time.perf_counter() - t0, 3), "cpu_seconds": round(cpu_s, 3)}


def compare_train(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """The training path on the card against its own run on the CPU in
    float32 (TF32 off): full smollm-135m (byte vocab 257) and phi3.5-moe at
    full width cut to sizes["moe_layers"] layer(s); B = 2 rows of BOS + 128
    bytes; the MoE's second row repeats one byte, so its tokens route alike
    and drop past capacity on both sides."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pl = port.pipeline
    english = port.corpus.english(MIB, seed + 5)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    rows = np.stack([english[i * 8192 : i * 8192 + S] for i in range(B)]).astype(np.int32)
    seqs = np.concatenate([np.full((B, 1), pl.BOS, np.int32), rows], axis=1)
    dense = {"tokens": seqs[:, :-1].copy(), "targets": seqs[:, 1:].copy()}
    moe_seqs = seqs.copy()
    moe_seqs[1, 1:] = ord("e")
    moe = {"tokens": moe_seqs[:, :-1].copy(), "targets": moe_seqs[:, 1:].copy()}
    f32 = dict(dtype="float32", param_dtype="float32")
    out = [train_compare_one(torch, np, port, "smollm-135m",
                             lm_config(port, "smollm-135m", vocab=pl.VOCAB, **f32),
                             dense, seed, sizes["steps"], accum=True),
           train_compare_one(torch, np, port, f"phi3.5-moe-42b-a6.6b, {sizes['moe_layers']} layer",
                             lm_config(port, "phi3.5-moe-42b-a6.6b", n_layers=sizes["moe_layers"],
                                       **f32),
                             moe, seed + 1, sizes["steps"], accum=False)]
    return {"models": out, "tolerance": TRAIN_TOL, "tolerance_adamw": ADAM_TOL}


def loss_at(logs, step: int) -> float:
    """The loss train() logged at `step`."""
    for line in logs:
        if line.startswith(f"step {step}: loss="):
            return float(line.split("loss=")[1].split()[0])
    raise RuntimeError(f"chip_smoke check failed: main-train logged no loss at step {step}")


def main_train(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """train.loop.train at full smollm-135m width in bfloat16 (its own
    dtype), B x S tokens a step, AdamW (peak 3e-3, warmup 20), over
    LMDataPipeline on the card with a 64-pattern english blocklist at
    blocklist_k = 1 (documents of 512 B - 64 KiB and two planted ones of
    1-4 MiB, which stream through megascan): async checkpoints every
    sizes["ckpt_every"] steps, a fault injected at sizes["fault_at"], then a
    second train resuming from the last checkpoint.  Verdicts against the
    host oracle, approx launches = filter dispatches x length groups,
    megascan launches = stream windows, the restored state bit-equal to a
    copy held at that step.  Then the step's time, profile and peak memory
    (remat on and off), checkpoint save / restore times, and the entry
    points: launch.train --reduced with checkpoints, then launch.serve
    --ckpt-dir restoring its last one."""
    tf, loop, opt, ck, pl = port.tf, port.loop, port.opt, port.ckpt, port.pipeline
    tree_map = port.lm_common.tree_map
    B, S, steps = sizes["batch"], sizes["seq"], sizes["steps"]
    every, fault_at = sizes["ckpt_every"], sizes["fault_at"]
    resume_at = fault_at // every * every
    cfg = lm_config(port, "smollm-135m", vocab=pl.VOCAB, ce_chunk=512)
    work = ROOT / "build" / "train_smoke"
    shutil.rmtree(work, ignore_errors=True)
    ckdir = work / "ckpt"
    text = port.corpus.english(4 * MIB, seed + 11)
    pats, verbatim, one_typo = pipeline_blocklist(np, text, 64, seed)
    plants = []
    for v, t in zip(verbatim, one_typo):
        plants.append(pats[v])
        plants.append(bytes(b if not 65 <= b <= 90 else ord("e") for b in pats[t]))
    docs = pipeline_documents(np, port.corpus, seed + 11, sizes["text"], 2, 0, plants)
    check(sum(len(d) >= MIB for d in docs[: pl.FILTER_BATCH]) == 2,
          "main-train: the oversize documents are not in the first filter group")

    ocfg = opt.AdamWConfig(peak_lr=3e-3, warmup_steps=20, total_steps=steps)
    tc = loop.TrainConfig(steps=steps, log_every=1, ckpt_every=every, ckpt_dir=str(ckdir),
                          keep_ckpts=3, async_checkpoint=True, opt=ocfg)
    loss_fn = lambda p, b: tf.train_loss(p, cfg, b)
    params0 = tf.init_params(torch.Generator(device=DEVICE).manual_seed(seed), cfg, device=DEVICE)
    held_copy = {}
    real_save = ck.save

    def spy_save(tree, directory, step, **kw):
        if step == resume_at:
            held_copy["state"] = tree_map(lambda t: t.detach().clone(), tree)
        return real_save(tree, directory, step, **kw)

    spies = RouteSpies(port)
    pipes, calls, logs = [], [], []

    def pipeline():
        pipe = pl.LMDataPipeline(iter(docs), seq_len=S, batch_size=B, blocklist=pats,
                                 blocklist_k=1, device=DEVICE)
        pipes.append(pipe)
        calls.append(record_filter_calls(pipe.pattern_set, spies))
        return pipe

    out = {"phase": "main-train", "model": "smollm-135m", "dtype": cfg.dtype, "batch": B,
           "seq": S, "ce_chunk": cfg.ce_chunk, "steps": steps, "params":
           port.lm_common.param_count(params0), "patterns": len(pats), "blocklist_k": 1}
    torch.cuda.synchronize()
    port.reset_launches()
    ck.save = spy_save
    try:
        with spies:
            t0 = time.perf_counter()
            try:
                loop.train(loss_fn, params0, pipeline(), tc, fault_at_step=fault_at,
                           log=logs.append, device=DEVICE)
                check(False, "main-train: the injected fault did not surface")
            except port.ft.InjectedFault:
                pass
            first_s = time.perf_counter() - t0
            check(ck.latest_step(ckdir) == resume_at,
                  f"main-train: latest checkpoint {ck.latest_step(ckdir)} != {resume_at}")
            restored, at = ck.restore((params0, opt.adamw_init(params0)), ckdir, device=DEVICE)
            check(at == resume_at, f"main-train: restored step {at}")
            out["restored_leaves_bit_equal"] = same_bits(torch, restored, held_copy.pop("state"),
                                                         "main-train restored state")
            del restored
            t0 = time.perf_counter()
            params, state, hist = loop.train(loss_fn, params0, pipeline(), tc, log=logs.append,
                                             device=DEVICE)
            torch.cuda.synchronize()
            resumed_s = time.perf_counter() - t0
        launches = port.launches()
    finally:
        ck.save = real_save
    check(f"resumed from step {resume_at}" in logs, "main-train: the second run did not resume")
    check(len(hist) == steps - resume_at, f"main-train: {len(hist)} resumed steps")
    check(ck.latest_step(ckdir) == steps and not list(ckdir.glob(".tmp_*")),
          f"main-train: step {steps} not published, or a .tmp_* left")
    losses = {"0": loss_at(logs, 0), str(every): loss_at(logs, every), str(steps - 1): hist[-1]}
    check(all(np.isfinite(v) for v in hist) and hist[-1] < losses["0"],
          f"main-train: losses {losses}")
    # the data plane: verdicts, stream windows and dispatches of both pipelines
    n_in = max(p.stats.docs_in for p in pipes)
    want = oracle_blocked(np, docs[:n_in], pats, 1)
    dispatches, windows, groups = 0, 0, len(pipes[0].pattern_set.plans)
    for pipe, cs in zip(pipes, calls):
        n = pipe.stats.docs_in
        got = filter_verdicts(np, pl, docs[:n], cs, "main-train")
        bad = np.flatnonzero(got != want[:n])
        check(bad.size == 0, f"main-train: {bad.size} verdicts differ from the oracle")
        dispatches += sum(kind == "batch" for kind, _, _ in cs)
        windows += sum(sc.dispatch_count for sc in pipe.pattern_set._scanners.values())
    big_blocked = [bool(v) for d, v in zip(docs[:n_in], want) if len(d) > pl.MAX_FILTER_LEN]
    check(big_blocked and all(big_blocked), f"main-train: oversize verdicts {big_blocked}")
    check(launches["megascan"] == windows > 0,
          f"main-train: megascan {launches['megascan']} != {windows} stream windows")
    check(launches["approx"] == dispatches * groups == spies.calls["approx_dense"],
          f"main-train: approx {launches['approx']} != {dispatches} dispatches x {groups} groups")
    out.update(first_run_s=first_s, resumed_run_s=resumed_s, resumed_steps=len(hist),
               resumed_tokens_per_s=len(hist) * B * S / resumed_s, loss=losses,
               docs_filtered=n_in, docs_blocked=int(want.sum()), filter_dispatches=dispatches,
               length_groups=groups, stream_windows=windows,
               launches={k: launches[k] for k in ("approx", "megascan", "multipattern",
                                                  "acscan", "acscan_counts")})

    # one step's time, profile and peak memory, on one batch of the documents
    small = [d for d in docs if len(d) < MIB]
    batch = loop.batch_to(next(pl.LMDataPipeline(iter(small), seq_len=S, batch_size=B,
                                                 device=DEVICE)), DEVICE)
    cur = {"p": params, "s": state}

    def step_with(step_fn):
        cur["p"], cur["s"], _ = step_fn(cur["p"], cur["s"], batch)

    train_step = loop.make_train_step(loss_fn, ocfg)
    step_with(train_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_with(train_step)
    torch.cuda.synchronize()
    out["fenced_step_ms"] = (time.perf_counter() - t0) * 1e3
    out["profile"] = {"train_step": profile_units(torch, lambda: step_with(train_step), 3)}
    out["tokens_per_s"] = B * S / out["profile"]["train_step"]["wall_ms"] * 1e3
    peaks = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        fn = loop.make_train_step(lambda p, b, _c=c: tf.train_loss(p, _c, b), ocfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_bytes = torch.cuda.memory_allocated()
        step_with(fn)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        peaks["remat_on" if remat else "remat_off"] = {"peak_gib": peak / GIB,
                                                       "above_state_gib": (peak - held_bytes) / GIB}
    out["peak_memory"] = peaks

    # checkpoint save (async) and restore of the full state
    d = work / "timing"
    state_tree = (cur["p"], cur["s"])
    t0 = time.perf_counter()
    writer = ck.save(state_tree, d, steps + 1, async_=True)
    return_s = time.perf_counter() - t0
    writer.join()
    write_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in (d / f"step_{steps + 1:08d}").iterdir())
    t0 = time.perf_counter()
    back, _ = ck.restore(state_tree, d, device=DEVICE)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_bits(torch, back, state_tree, "main-train checkpoint round trip")
    out["checkpoint"] = {"bytes": size, "async_return_s": return_s, "write_s": write_s,
                         "restore_s": restore_s}
    del back, state_tree, params, state, params0, cur, batch
    torch.cuda.empty_cache()

    # the entry points: the launcher trains with checkpoints, the server
    # restores its last one
    d = work / "entry"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lt_params, lt_state = port.launch_train.main(
            ["--reduced", "--steps", "30", "--seq", "128", "--batch", "8", "--ckpt-dir", str(d),
             "--ckpt-every", "10"])
        results, served, step = port.launch_serve.main(["--ckpt-dir", str(d)])
    printed = buf.getvalue().splitlines()
    check(step == 30 and "restored step 30" in printed and int(lt_state.step) == 30,
          f"main-train: the server restored step {step}")
    ck_params, _ = ck.restore((served, opt.adamw_init(served)), d, device=DEVICE)[0]
    same_bits(torch, served, ck_params, "main-train served parameters against the checkpoint")
    same_bits(torch, served, lt_params, "main-train served parameters against the launcher's")
    out["entry_points"] = {"launcher_lines": [l for l in printed if l.startswith(("mesh", "step", "done"))],
                           "served": len(results), "restored_step": step,
                           "server_line": next(l for l in printed if l.startswith("served"))}
    del lt_params, lt_state, served, ck_params
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    emit(out)
    return {"launches": out["launches"]}


RECSYS_ARCHS = ("din", "dien", "bst", "dcn-v2")
RECSYS_TOL = 1e-5


def no_string_kernels(port: Port, what: str) -> None:
    """The recsys and GNN paths reach no Pallas kernel: none of the
    string-matching kernels launches in them."""
    launched = {k: v for k, v in port.launches().items() if v}
    check(not launched, f"{what}: string kernels launched {launched}")


def fenced_ms(torch, fn, calls: int) -> list:
    """ms of each of `calls` calls of fn, each ended by a synchronize."""
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def with_peak(torch, fn):
    """(fn(), peak GiB allocated while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / GIB


class TimedBatches:
    """`steps` batches make(i), the host seconds each one took."""

    def __init__(self, make, steps: int):
        self.make, self.steps, self.seconds = make, steps, []

    def __iter__(self):
        for i in range(self.steps):
            t0 = time.perf_counter()
            batch = self.make(i)
            self.seconds.append(time.perf_counter() - t0)
            yield batch


def recsys_candidates(np, port: Port, cfg, C: int, seed: int):
    """C candidates: item ids (sequence models) or sparse rows (DCN-v2)."""
    if cfg.kind == "dcn":
        return port.recsys_data.dcn_batch(cfg, C, seed)["sparse"]
    return np.random.RandomState(seed).randint(0, cfg.item_vocab, size=C).astype(np.int32)


# Threads drawing main-recsys's host batches: make_batch draws 6.5 M zipf
# values for a sequence model's batch of 65,536 (~1.3 s of one core), and
# numpy's generators let go of the interpreter lock while they draw
HOST_THREADS = 6

def compare_recsys(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """The four recsys archs at their published widths on the card against
    their own run on the CPU (float32, TF32 off), from one seeded init
    drawn on the card and copied to the host."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs, data, loop = port.recsys, port.recsys_data, port.loop
    out = []
    port.reset_launches()
    for i, arch in enumerate(RECSYS_ARCHS):
        t0 = time.perf_counter()
        cfg = port.configs.get_arch(arch).make_config()
        params = rs.init_params(torch.Generator(device=DEVICE).manual_seed(seed + i), cfg,
                                device=DEVICE)
        host = port.lm_common.tree_map(lambda t: t.cpu(), params)
        batch = data.make_batch(cfg, sizes["batch"], seed=seed + i)
        cb, hb = loop.batch_to(batch, DEVICE), loop.batch_to(batch, "cpu")
        lh = rs.logits(host, cfg, hb)
        errs = {"logits": held(torch, rs.logits(params, cfg, cb), lh, f"{arch} logits", RECSYS_TOL)}
        sc = rs.serve_scores(params, cfg, batch, device=DEVICE).cpu()
        sh = rs.serve_scores(host, cfg, batch, device="cpu")
        errs["serve_scores"] = float((sc - sh).abs().max()) / float(lh.abs().max())
        check(errs["serve_scores"] <= RECSYS_TOL,
              f"{arch} serve_scores: {errs['serve_scores']} of max |logit| > {RECSYS_TOL}")
        loss_fn = lambda p, b, _c=cfg: rs.train_loss(p, _c, b)
        loss_c, grads_c = loop.value_and_grad(loss_fn, params, cb)
        loss_h, grads_h = loop.value_and_grad(loss_fn, host, hb)
        errs["loss"] = held(torch, loss_c, loss_h, f"{arch} loss", TRAIN_TOL)
        errs["grads"] = tree_err(torch, grads_c, grads_h, f"{arch} grad", TRAIN_TOL)
        del grads_c, grads_h
        user = data.make_batch(cfg, 1, seed=seed + 100 + i, with_label=False)
        cands = recsys_candidates(np, port, cfg, sizes["candidates"], seed + 200 + i)
        errs["retrieval"] = held(torch, rs.retrieval_scores(params, cfg, user, cands, device=DEVICE),
                                 rs.retrieval_scores(host, cfg, user, cands, device="cpu"),
                                 f"{arch} retrieval_scores", RECSYS_TOL)
        out.append({"arch": arch, "params": port.lm_common.param_count(params),
                    "batch": sizes["batch"], "candidates": sizes["candidates"],
                    "loss": float(loss_h), "max_rel_err": errs,
                    "seconds": round(time.perf_counter() - t0, 3)})
        del params, host, cb, hb
        torch.cuda.empty_cache()
    no_string_kernels(port, "compare-recsys")
    return {"models": out, "tolerance": RECSYS_TOL, "tolerance_grads": TRAIN_TOL}


def reddit_graph(np, port: Port, seed: int):
    """The minibatch_lg base graph: a Reddit-sized synthetic graph (232,965
    nodes, average degree 492, d_feat 602, 41 classes) on the host."""
    meta = port.configs.GNN_SHAPES["minibatch_lg"].meta
    return port.graph_data.synthetic_graph(
        meta["base_nodes"], round(meta["base_edges"] / meta["base_nodes"]), meta["d_feat"],
        meta["n_classes"], seed=seed)


def sampled_batch(np, port: Port, graph, seed: int) -> dict:
    """One minibatch_lg subgraph: 1024 seed nodes, fanout (15, 10), padded."""
    meta = port.configs.GNN_SHAPES["minibatch_lg"].meta
    seeds = np.random.RandomState(seed).choice(graph.n_nodes, meta["batch_nodes"], replace=False)
    return port.graph_data.sample_subgraph(graph, seeds, meta["fanout"], seed=seed)


def gnn_case(np, port: Port, shape: str, seed: int, reddit):
    """(config, numpy batch, n_graphs) of a GatedGCN shape at full width."""
    cfg = port.configs.get_arch("gatedgcn").make_config(shape)
    meta = port.configs.GNN_SHAPES[shape].meta
    if shape == "molecule":
        return cfg, port.graph_data.batched_molecules(
            meta["n_graphs"], meta["nodes_per_graph"], meta["edges_per_graph"], meta["d_feat"],
            meta["d_edge_feat"], seed=seed), meta["n_graphs"]
    if shape == "minibatch_lg":
        return cfg, sampled_batch(np, port, reddit, seed), 0
    g = port.graph_data.synthetic_graph(meta["n_nodes"], round(meta["n_edges"] / meta["n_nodes"]),
                                        meta["d_feat"], meta["n_classes"], seed=seed)
    return cfg, {"nodes": g.feats, "edges": port.graph_data.edge_list(g), "labels": g.labels}, 0


GNN_SHAPES_RUN = ("full_graph_sm", "molecule", "minibatch_lg")


def widened(torch, port: Port, cfg, params, batch):
    """The GNN config, parameters and batch in float64 (the layer norms and
    the loss stay float32, as the reference computes them)."""
    wide = lambda t: t.double() if t.is_floating_point() else t
    return (dataclasses.replace(cfg, dtype="float64", param_dtype="float64"),
            port.lm_common.tree_map(wide, params), {k: wide(v) for k, v in batch.items()})


def compare_gnn(torch, np, port: Port, seed: int, reddit) -> dict:
    """GatedGCN at full width on the card against the CPU from one seeded
    init, remat on and off: the float32 loss, and the loss and every
    gradient leaf of a float64 run, within TRAIN_TOL of the CPU's float64
    run (the layer norms and the loss stay float32 in it, as the reference
    computes them).  The float32 gradients, the card's and the CPU's, are
    readings against that run: on the larger graphs the CPU's own float32
    run is further than TRAIN_TOL from it, so two float32 runs that sum in
    other orders cannot be held to TRAIN_TOL.  The CPU runs each dtype once
    (its remat on and off are bit-equal, tests/test_torch_gnn.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gnn, loop = port.gnn, port.loop
    out = []
    port.reset_launches()
    for i, shape in enumerate(GNN_SHAPES_RUN):
        t0 = time.perf_counter()
        cfg, batch, n_graphs = gnn_case(np, port, shape, seed + i, reddit)
        params = gnn.init_params(torch.Generator(device=DEVICE).manual_seed(seed + i), cfg,
                                 device=DEVICE)
        host = port.lm_common.tree_map(lambda t: t.cpu(), params)
        cb, hb = loop.batch_to(batch, DEVICE), loop.batch_to(batch, "cpu")
        loss = lambda c: (lambda p, b: gnn.train_loss(p, c, b, n_graphs))
        c64, h64, hb64 = widened(torch, port, dataclasses.replace(cfg, remat=False), host, hb)
        cpu64_loss, cpu64_grads = loop.value_and_grad(loss(c64), h64, hb64)
        del h64, hb64
        _, cpu32_grads = loop.value_and_grad(loss(dataclasses.replace(cfg, remat=False)), host, hb)
        readings = {"cpu": tree_err(torch, cpu32_grads, cpu64_grads, "a reading", float("inf"))}
        del cpu32_grads
        errs, losses = {}, {"cpu_float64": float(cpu64_loss)}
        for remat in (True, False):
            tag = "remat_on" if remat else "remat_off"
            c = dataclasses.replace(cfg, remat=remat)
            lc, gc = loop.value_and_grad(loss(c), params, cb)
            errs[f"loss_{tag}"] = held(torch, lc, cpu64_loss, f"gatedgcn {shape} loss ({tag})",
                                       TRAIN_TOL)
            readings[f"card_{tag}"] = tree_err(torch, gc, cpu64_grads, "a reading", float("inf"))
            losses[tag] = float(lc)
            del gc
            c64, p64, cb64 = widened(torch, port, c, params, cb)
            lc, gc = loop.value_and_grad(loss(c64), p64, cb64)
            errs[f"loss_float64_{tag}"] = held(torch, lc, cpu64_loss,
                                               f"gatedgcn {shape} float64 loss ({tag})", TRAIN_TOL)
            errs[f"grads_float64_{tag}"] = tree_err(torch, gc, cpu64_grads,
                                                    f"gatedgcn {shape} float64 grad ({tag})",
                                                    TRAIN_TOL)
            del gc, p64, cb64
        row = {"shape": shape, "params": port.lm_common.param_count(params),
               "nodes": int(batch["nodes"].shape[0]), "edges": int(batch["edges"].shape[1]),
               "d_feat": cfg.d_feat, "readout": cfg.readout, "loss": losses, "max_rel_err": errs,
               "float32_grads_against_cpu_float64": readings,
               "seconds": round(time.perf_counter() - t0, 3)}
        if "edge_mask" in batch:
            row["padding_edges"] = int((batch["edge_mask"] == 0).sum())
        out.append(row)
        del params, host, cb, hb, cpu64_grads
        torch.cuda.empty_cache()
    no_string_kernels(port, "compare-gnn")
    return {"graphs": out, "tolerance": TRAIN_TOL}


def serve_rows(np, cfg, user: dict, cands, n: int) -> dict:
    """The batch serve_scores takes for the first n (user, candidate) pairs:
    what retrieval_scores scores in one batched forward."""
    if cfg.kind == "dcn":
        return {"dense": np.repeat(user["dense"], n, axis=0), "sparse": cands[:n]}
    rep = {k: np.repeat(user[k], n, axis=0) for k in ("hist_items", "hist_cates", "hist_mask")}
    return {**rep, "target_item": cands[:n], "target_cate": cands[:n] % cfg.cate_vocab}


def main_recsys(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """Serving, retrieval and training of each recsys arch at full width
    (float32, the configs' own dtype; TF32 off, as the compare phases
    leave it).  Each arch's host batches (serve_bulk's, one a train step)
    and its candidates are drawn first, by HOST_THREADS threads at once, so
    no host work runs beside the card's timed calls."""
    work = ROOT / "build" / "recsys_smoke"
    shutil.rmtree(work, ignore_errors=True)
    out = []
    port.reset_launches()
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        for i, arch in enumerate(RECSYS_ARCHS):
            row = recsys_arch(torch, np, port, pool, seed, i, arch, sizes, work)
            emit({"phase": "main-recsys", **row})
            out.append(row)
    no_string_kernels(port, "main-recsys")
    shutil.rmtree(work, ignore_errors=True)
    return {"archs": [r["arch"] for r in out]}


def recsys_arch(torch, np, port: Port, pool, seed: int, i: int, arch: str, sizes: dict,
                work) -> dict:
    rs, data, loop, opt, ck = port.recsys, port.recsys_data, port.loop, port.opt, port.ckpt
    t_arch = time.perf_counter()
    cfg = port.configs.get_arch(arch).make_config()
    B_bulk, C = sizes["bulk_batch"], sizes["candidates"]
    B, steps = sizes["train_batch"], sizes["train_steps"]
    t0 = time.perf_counter()
    bulk_job = pool.submit(data.make_batch, cfg, B_bulk, seed + 20 + i, False)
    cand_job = pool.submit(recsys_candidates, np, port, cfg, C, seed + 40 + i)
    train_jobs = [pool.submit(data.make_batch, cfg, B, seed + 1000 * i + s) for s in range(steps)]
    bulk_batch, cands = bulk_job.result(), cand_job.result()
    train_batches = [job.result() for job in train_jobs]
    host_s = time.perf_counter() - t0
    params = rs.init_params(torch.Generator(device=DEVICE).manual_seed(seed + i), cfg,
                            device=DEVICE)
    row = {"arch": arch, "params": port.lm_common.param_count(params),
           "host_batches_s": host_s, "host_threads": HOST_THREADS}
    # serve_p99: fenced calls from a host batch (the copy included)
    batch = data.make_batch(cfg, sizes["serve_batch"], seed=seed + 10 + i, with_label=False)
    serve = lambda b=batch: rs.serve_scores(params, cfg, b, device=DEVICE)
    fenced_ms(torch, serve, 3)
    ms = fenced_ms(torch, serve, sizes["serve_calls"])
    scores = serve()
    check(scores.shape == (sizes["serve_batch"],) and bool(torch.isfinite(scores).all()),
          f"main-recsys {arch}: serve scores")
    row["serve_p99"] = {"batch": sizes["serve_batch"], "calls": len(ms),
                        "p50_ms": float(np.percentile(ms, 50)),
                        "p99_ms": float(np.percentile(ms, 99)), "max_ms": max(ms)}
    # serve_bulk
    serve = lambda b=bulk_batch: rs.serve_scores(params, cfg, b, device=DEVICE)
    ms, peak = with_peak(torch, lambda: fenced_ms(torch, serve, sizes["bulk_calls"]))
    scores = serve()
    check(scores.shape == (B_bulk,) and bool(torch.isfinite(scores).all()),
          f"main-recsys {arch}: bulk scores")
    row["serve_bulk"] = {"batch": B_bulk, "calls": len(ms), "median_ms": statistics.median(ms),
                         "rows_per_s": B_bulk / statistics.median(ms) * 1e3, "peak_gib": peak}
    del bulk_batch, scores
    # retrieval_cand: one user against C candidates
    user = data.make_batch(cfg, 1, seed=seed + 30 + i, with_label=False)
    retrieve = lambda: rs.retrieval_scores(params, cfg, user, cands, device=DEVICE)
    (scores, ms), peak = with_peak(torch, lambda: (retrieve(), fenced_ms(torch, retrieve, 3)))
    check(scores.shape == (C,) and bool(torch.isfinite(scores).all()),
          f"main-recsys {arch}: retrieval scores")
    n = 8
    direct = rs.serve_scores(params, cfg, serve_rows(np, cfg, user, cands, n), device=DEVICE)
    agree = held(torch, scores[:n], direct, f"main-recsys {arch}: retrieval against serve",
                 RECSYS_TOL)
    row["retrieval_cand"] = {"candidates": C, "block": rs.RETRIEVAL_BLOCK,
                             "median_ms": statistics.median(ms),
                             "candidates_per_s": C / statistics.median(ms) * 1e3,
                             "peak_gib": peak, "rel_err_against_serve_rows": agree}
    del scores, cands
    torch.cuda.empty_cache()
    # train_batch: train.loop.train, a fresh make_batch a step
    ocfg = opt.AdamWConfig()
    loss_fn = lambda p, b: rs.train_loss(p, cfg, b)
    feed = iter(train_batches)
    tc = loop.TrainConfig(steps=steps, log_every=1, opt=ocfg)
    t0 = time.perf_counter()
    (params, state, hist), peak = with_peak(
        torch, lambda: loop.train(loss_fn, params, feed, tc, log=lambda line: None, device=DEVICE))
    train_s = time.perf_counter() - t0
    del train_batches
    check(len(hist) == steps and all(np.isfinite(hist)), f"main-recsys {arch}: losses {hist}")
    cur = {"p": params, "s": state}
    batch = loop.batch_to(data.make_batch(cfg, B, seed=seed + 999), DEVICE)
    step_fn = loop.make_train_step(loss_fn, ocfg)

    def step():
        cur["p"], cur["s"], _ = step_fn(cur["p"], cur["s"], batch)

    step()
    row["train_batch"] = {
        "batch": B, "steps": steps, "train_s": train_s, "examples_per_s": steps * B / train_s,
        "fenced_step_ms": fenced_ms(torch, step, 1)[0],
        "loss": {"0": hist[0], str(steps - 1): hist[-1]}, "peak_gib": peak,
        "profile": profile_units(torch, step, 1)}
    del params, state, batch
    # fault 6's path on the card: towers, blocks, cross and tables
    if arch in ("bst", "dcn-v2"):
        d = work / arch
        tree = (cur["p"], cur["s"])
        t0 = time.perf_counter()
        ck.save(tree, d, steps)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in (d / f"step_{steps:08d}").iterdir())
        t0 = time.perf_counter()
        back, at = ck.restore(tree, d, device=DEVICE)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(at == steps, f"main-recsys {arch}: restored step {at}")
        row["checkpoint"] = {"bytes": size, "save_s": save_s, "restore_s": restore_s,
                             "leaves_bit_equal": same_bits(torch, back, tree,
                                                           f"main-recsys {arch} checkpoint")}
        del back, tree
        shutil.rmtree(d, ignore_errors=True)
    del cur
    torch.cuda.empty_cache()
    row["seconds"] = round(time.perf_counter() - t_arch, 3)
    return row


def main_gnn(torch, np, port: Port, seed: int, reddit, sizes: dict) -> dict:
    """GatedGCN training at full width through train.loop.train (AdamW at
    the reference's defaults): minibatch_lg on fresh sampled subgraphs of
    the Reddit-sized graph, molecule on fresh batches, full_graph_sm
    full-batch; one checkpoint saved and restored."""
    gnn, loop, opt, ck = port.gnn, port.loop, port.opt, port.ckpt
    work = ROOT / "build" / "gnn_smoke"
    shutil.rmtree(work, ignore_errors=True)
    out = []
    port.reset_launches()
    saved = None
    for i, shape in enumerate(GNN_SHAPES_RUN[::-1]):
        t_shape = time.perf_counter()
        cfg, first, n_graphs = gnn_case(np, port, shape, seed + 50 + i, reddit)
        steps = sizes["steps"][shape]
        if shape == "full_graph_sm":
            make = lambda s, _b=first: _b
        else:
            make = lambda s, _shape=shape: gnn_case(np, port, _shape, seed + 60 + s, reddit)[1]
        params = gnn.init_params(torch.Generator(device=DEVICE).manual_seed(seed + 50 + i), cfg,
                                 device=DEVICE)
        loss_fn = lambda p, b, _c=cfg, _n=n_graphs: gnn.train_loss(p, _c, b, _n)
        ocfg = opt.AdamWConfig()
        feed = TimedBatches(make, steps)
        tc = loop.TrainConfig(steps=steps, log_every=1, opt=ocfg)
        t0 = time.perf_counter()
        (params, state, hist), peak = with_peak(
            torch, lambda: loop.train(loss_fn, params, feed, tc, log=lambda s: None, device=DEVICE))
        train_s = time.perf_counter() - t0
        check(len(hist) == steps and all(np.isfinite(hist)), f"main-gnn {shape}: losses {hist}")
        cur = {"p": params, "s": state}
        batch = loop.batch_to(first, DEVICE)
        step_fn = loop.make_train_step(loss_fn, ocfg)

        def step():
            cur["p"], cur["s"], _ = step_fn(cur["p"], cur["s"], batch)

        step()
        row = {"shape": shape, "params": port.lm_common.param_count(params),
               "nodes": int(first["nodes"].shape[0]), "edges": int(first["edges"].shape[1]),
               "steps": steps, "train_s": train_s, "steps_per_s": steps / train_s,
               "host_batch_ms": statistics.median(feed.seconds) * 1e3,
               "step_ms_without_host_batch": (train_s - sum(feed.seconds)) / steps * 1e3,
               "fenced_step_ms": fenced_ms(torch, step, 1)[0],
               "loss": {"0": hist[0], str(steps - 1): hist[-1]}, "peak_gib": peak,
               "profile": profile_units(torch, step, 2)}
        if shape == "minibatch_lg":
            row["padding_edges_first_batch"] = int((first["edge_mask"] == 0).sum())
            d = work / shape
            tree = (cur["p"], cur["s"])
            ck.save(tree, d, steps)
            back, at = ck.restore(tree, d, device=DEVICE)
            check(at == steps, f"main-gnn: restored step {at}")
            saved = same_bits(torch, back, tree, "main-gnn checkpoint")
            row["checkpoint_leaves_bit_equal"] = saved
            del back, tree
        del params, state, batch, cur
        torch.cuda.empty_cache()
        row["seconds"] = round(time.perf_counter() - t_shape, 3)
        emit({"phase": "main-gnn", **row})
        out.append(row)
    check(saved, "main-gnn: no checkpoint was checked")
    no_string_kernels(port, "main-gnn")
    shutil.rmtree(work, ignore_errors=True)
    meta = port.configs.GNN_SHAPES["ogb_products"].meta
    edge_state = meta["n_edges"] * 70 * 4
    emit({"phase": "main-gnn", "shape": "ogb_products", "run": False,
          "reason": f"one (E, d_hidden) float32 edge-state tensor is {edge_state / 1e9:.1f} GB "
                    f"({meta['n_edges']} edges x 70); a layer holds several at once and remat "
                    f"keeps one a layer (16 x {edge_state / 1e9:.1f} GB): more than one 80 GB "
                    "card, so it waits for the four-card slice"})
    return {"shapes": [r["shape"] for r in out]}


# --------------------------------------------------------------------------
# The paper's baselines: four segmented device loops
# --------------------------------------------------------------------------

BASELINE_LOOPS = ("shift_or", "kmp_dfa", "hash3", "bndm")
# the reference's FULL_M (benchmarks/paper_tables.py:39), the paper's m range
BASELINE_M = (2, 4, 6, 8, 12, 16, 20, 24, 28, 32)
# each loop's pattern lengths (hash3 below 3 is packed_naive, no loop)
BASELINE_LIMITS = {"shift_or": (1, 32), "kmp_dfa": (1, 1 << 20), "hash3": (3, 1 << 20),
                   "bndm": (1, 31)}
# Integer operations a step of each loop, read from csrc/baselines.cu: a
# Shift-Or byte shifts, ors and tests a bit (4 with the loop's compare); a
# KMP byte forms the row index, compares the state and loops (3); a HASH3
# iteration forms its hash (2 shifts, 2 adds, a mask), tests and adds the
# shift and loops (9, verification of candidates left out); a BNDM inner
# step ands, decrements, tests top, tests j, shifts, tests D and forms the
# address (7).  Table and text loads are not counted.
BASELINE_OPS = {"shift_or": 4, "kmp_dfa": 3, "hash3": 9, "bndm": 7}
BASELINE_SWEEP_SEGS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
BASELINE_SWEEP_M = (4, 8, 16, 32)


def baseline_corpora(np, port: Port, n: int, seed: int) -> dict:
    """The paper's three corpora (data/corpus.py) at n bytes, on the host."""
    corpus = port.corpus
    return {"genome": corpus.genome(n, seed), "protein": corpus.protein(n, seed),
            "english": np.ascontiguousarray(corpus.english(n, seed))}


def loop_lengths(name: str, lengths) -> list:
    lo, hi = BASELINE_LIMITS[name]
    return [m for m in lengths if lo <= m <= hi]


def fault7_case(torch, np, port: Port, seed: int, n: int) -> dict:
    """ROADMAP §3 fault 7 on the card: PatternSet.contains_any_stream with a
    2056-byte pattern, a set megascan refuses (EPSMc stride + m > its tile),
    answers as the reference does (any occurrence of any pattern; here by
    bytes.find on the host) and raises nothing.  Every window must be one
    acscan counts-mode launch over the set's automaton, and no other kernel
    may launch."""
    text = port.corpus.genome(n, seed + 7)
    pats = [text[1000:3056].copy(), text[50:58].copy()]
    absent = np.frombuffer(text.tobytes().lower(), np.uint8).copy()  # acgt: no occurrence
    planted = absent.copy()
    seam = n // 4
    planted[seam - 1000 : seam + 1056] = pats[0]  # across a window seam
    docs = {"present": text, "absent": absent, "planted": planted}
    ps = port.mp.PatternSet(pats, device=DEVICE)
    port.reset_launches()
    got = {}
    for name, doc in docs.items():
        got[name] = bool(ps.contains_any_stream(doc, chunk_bytes=n // 4))
    torch.cuda.synchronize()
    launches = {k: v for k, v in port.launches().items() if v}
    want = {name: any(doc.tobytes().find(p.tobytes()) >= 0 for p in pats)
            for name, doc in docs.items()}
    (sc,) = ps._scanners.values()
    out = emit({"phase": "fault7", "n": n, "m": [len(p) for p in pats], "verdicts": got,
                "oracle": want, "megascan_spec": sc.spec is not None, "windows": sc.dispatch_count,
                "launches": launches})
    check(got == want == {"present": True, "absent": False, "planted": True},
          f"fault7: verdicts {got} != {want}")
    check(sc.spec is None and sc.dispatch_count >= 3
          and launches == {"acscan_counts": sc.dispatch_count},
          f"fault7: launches {launches} != one acscan counts launch for each of the "
          f"{sc.dispatch_count} windows")
    return out


def compare_baselines(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """The four loops through core.baselines' entry points on the paper's
    three corpora at sizes['n'] (the main path: counters reset just before,
    read just after), then each mask held bit for bit against the loop's
    plain version on the card (same seg), packed_naive on the card and
    epsm.find (the EPSM kernels); rabin_karp against packed_naive; the edge
    cases and the raises."""
    bl, plain, corpus = port.baselines, port.bl_plain, port.corpus
    n, per_m = sizes["n"], sizes["patterns"]
    hosts = baseline_corpora(np, port, n, seed)
    texts = {c: torch.from_numpy(h.copy()).to(DEVICE) for c, h in hosts.items()}
    cases = []
    for c, host in hosts.items():
        for m in BASELINE_M:
            starts = corpus.pattern_starts(n, m, per_m, seed=500 + m)
            for i, p in enumerate(corpus.extract_patterns(host, m, per_m, seed=500 + m)):
                cases.append((c, m, i, torch.from_numpy(p.copy()).to(DEVICE), int(starts[i])))
    torch.cuda.synchronize()
    expected = {name: 0 for name in port.wrappers}
    masks = {}
    port.reset_launches()
    t0 = time.perf_counter()
    for c, m, i, p, _ in cases:
        for name in BASELINE_LOOPS:
            if m in loop_lengths(name, (m,)):
                masks[name, c, m, i] = bl.BASELINES[name](texts[c], p)
                expected[name] += 1
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = port.launches()
    check(launches == expected, f"compare-baselines: launches {launches} != calls {expected}")
    # every mask against the plain version, packed_naive and epsm.find
    max_err = {name: 0 for name in BASELINE_LOOPS}
    held = {"plain": 0, "packed_naive": 0, "epsm_find": 0, "rabin_karp": 0}
    hits = 0
    for c, m, i, p, start in cases:
        text = texts[c]
        naive = bl.packed_naive(text, p)
        find = port.epsm.find(text, p)
        check(torch.equal(naive, find), f"{c} m={m} #{i}: packed_naive != epsm.find")
        check(bool(naive[start]), f"{c} m={m} #{i}: the extracted occurrence at {start}")
        check(torch.equal(bl.rabin_karp(text, p), naive), f"{c} m={m} #{i}: rabin_karp")
        held["epsm_find"] += 1
        held["rabin_karp"] += 1
        hits += int(naive.sum())
        for name in BASELINE_LOOPS:
            got = masks.pop((name, c, m, i), None)
            if got is None:
                continue
            want = getattr(plain, f"{name}_ref")(text, p, bl.loop_table(name, p, DEVICE),
                                                 bl.SEG[name])
            err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
            max_err[name] = max(max_err[name], err)
            check(torch.equal(got, want), f"{name} {c} m={m} #{i}: kernel != plain")
            check(torch.equal(got, naive), f"{name} {c} m={m} #{i}: kernel != packed_naive")
            held["plain"] += 1
            held["packed_naive"] += 1
    edges = baseline_edges(torch, np, port, seed)
    return emit({"phase": "compare-baselines", "n": n, "patterns_per_m": per_m, "m": BASELINE_M,
                 "launches": {k: launches[k] for k in BASELINE_LOOPS}, "main_path_s": main_s,
                 "held": held, "hits": hits, "edges": edges, "max_abs_err": max_err,
                 "equal": True})


def baseline_edges(torch, np, port: Port, seed: int) -> dict:
    """Edge cases of the seam rule on the card, each loop's kernel against
    its plain version at the same seg and the host oracle (bytes.find's
    twin, naive_np, for short texts; packed_naive for long ones)."""
    bl, plain = port.baselines, port.bl_plain
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 22)
    done = 0

    def hold(name, text, p, seg, oracle, what):
        nonlocal done
        got = bl._loop(name, text, p, seg)
        want = getattr(plain, f"{name}_ref")(text, p, bl.loop_table(name, p, DEVICE), seg) \
            if text.numel() >= p.numel() else torch.zeros_like(got)
        check(torch.equal(got, want), f"{name} {what} m={p.numel()} seg={seg}: kernel != plain")
        check(torch.equal(got, oracle), f"{name} {what} m={p.numel()} seg={seg}: != oracle")
        done += 1

    def naive_mask(text, p):
        return torch.from_numpy(bl.naive_np(text, p)).to(DEVICE)

    # the periodic text [7, 7, 9] tiled, at the default seg and narrow ones
    periodic = torch.tensor([7, 7, 9], dtype=torch.uint8, device=DEVICE).repeat(MIB // 3 + 1)
    for m in (3, 6, 9, 12, 30):
        p = periodic[:m].clone()
        oracle = bl.packed_naive(periodic, p)
        for name in BASELINE_LOOPS:
            if m in loop_lengths(name, (m,)):
                for seg in (None, 1, m - 1, m, 7):
                    hold(name, periodic, p, seg or bl.SEG[name], oracle, "periodic")
    # 1-byte texts, and texts of seg + 1 bytes (a second segment of one byte)
    for name in BASELINE_LOOPS:
        seg = bl.SEG[name]
        for n, m in ((1, 1), (seg + 1, 1), (seg + 1, 3), (seg + 1, 8), (seg + 1, 31), (3, 8)):
            if m not in loop_lengths(name, (m,)):
                continue
            text = random_text(torch, n, 2, gen)
            p = text[max(0, n - m):].clone() if n >= m else random_text(torch, m, 2, gen)
            hold(name, text, p, seg, naive_mask(text, p), f"n={n}")
    # segments narrower than the pattern, on 64 KiB of genome
    genome = random_text(torch, 64 * 1024, 4, gen, port.corpus.GENOME_ALPHABET)
    for name in BASELINE_LOOPS:
        for m, seg in ((16, 5), (31, 1), (31, 30), (8, 2)):
            p = genome[4000 : 4000 + m].clone()
            hold(name, genome, p, seg, bl.packed_naive(genome, p), "narrow")
    # the raises at the reference's limits
    raised = {}
    for name, m in (("shift_or", 33), ("bndm", 32)):
        try:
            bl.BASELINES[name](genome, genome[:m].clone())
        except ValueError:
            raised[name] = m
    check(raised == {"shift_or": 33, "bndm": 32}, f"baselines: raises {raised}")
    return {"cases": done, "raised": raised}


def warp_efficiency(torch, steps) -> float:
    """Share of a warp's lane-steps that do work: the lanes' steps over 32
    times the longest lane's, summed over warps (one thread a segment, 32
    consecutive segments a warp; the last warp's missing lanes idle)."""
    s = steps.double().cpu()
    s = torch.nn.functional.pad(s, (0, (-s.numel()) % 32))
    return float(s.sum() / (32 * s.view(-1, 32).max(1).values.sum()))


def timing_baselines(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """Each loop at sizes['n'] a corpus, m = 8 and 16: the kernel (CUDA
    events, median of 20, queued behind a device sleep) and the entry
    point's call, its plain version, epsm.find at the same shape (queued,
    and a call), packed_naive and rabin_karp (fenced wall),
    the bound, and the warp lane efficiency of the skip loops (from the
    plain version's steps a segment); then a sweep of seg over the paper's
    m range, whose best per loop is printed beside the default."""
    bl, plain, epsm, corpus = port.baselines, port.bl_plain, port.epsm, port.corpus
    n = sizes["n"]
    hosts = baseline_corpora(np, port, n, seed)
    rows, summary = [], {}
    for c, host in hosts.items():
        text = torch.from_numpy(host.copy()).to(DEVICE)
        for m in (8, 16):
            p = torch.from_numpy(corpus.extract_patterns(host, m, 1, seed=600 + m)[0].copy()).to(
                DEVICE)
            # epsm.find's device time (queued) and its call's time with the host's
            find_ms = time_cuda(torch, lambda: epsm.find(text, p), 20, queued=True)
            find_call_ms = time_cuda(torch, lambda: epsm.find(text, p), 20)
            naive_ms = statistics.median(fenced_ms(torch, lambda: bl.packed_naive(text, p), 5))
            rk_ms = statistics.median(fenced_ms(torch, lambda: bl.rabin_karp(text, p), 5))
            for name in BASELINE_LOOPS:
                seg, table = bl.SEG[name], bl.loop_table(name, p, DEVICE)
                wrapper, ref = port.wrappers[name], getattr(plain, f"{name}_ref")
                kernel_ms = time_cuda(torch, lambda: wrapper(text, p, table, seg), 20, queued=True)
                # the entry point's call: host table build, upload, launch
                call_ms = time_cuda(torch, lambda: bl.BASELINES[name](text, p), 20)
                plain_ms = time_cuda(torch, lambda: ref(text, p, table, seg), 3)
                steps = plain.lane_steps(name, text, p, table, seg)
                ops = float(steps.sum()) * BASELINE_OPS[name]
                bound_ms, bound_by = bound_of(2 * n, ops)
                row = emit({"phase": "timing-baselines", "kernel": name, "corpus": c, "n": n,
                            "m": m, "seg": seg, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                            "steps_per_byte": float(steps.sum()) / n,
                            "warp_efficiency": warp_efficiency(torch, steps),
                            "call_ms": call_ms, "epsm_find_ms": find_ms,
                            "epsm_find_call_ms": find_call_ms, "packed_naive_ms": naive_ms,
                            "rabin_karp_ms": rk_ms, "GB_per_s": n / (kernel_ms * 1e-3) / 1e9})
                rows.append(row)
                summary.setdefault(name, row)  # genome, m = 8 goes in the kernels line
    # the seg sweep: median ms of a queued launch at each seg, summed over
    # corpora and m
    sweep = {name: {} for name in BASELINE_LOOPS}
    for c, host in hosts.items():
        text = torch.from_numpy(host.copy()).to(DEVICE)
        for m in BASELINE_SWEEP_M:
            p = torch.from_numpy(corpus.extract_patterns(host, m, 1, seed=700 + m)[0].copy()).to(
                DEVICE)
            for name in BASELINE_LOOPS:
                lo, hi = BASELINE_LIMITS[name]
                if m < lo:
                    continue
                q = p[: min(m, hi)]  # bndm's 32 becomes its limit, 31
                table, wrapper = bl.loop_table(name, q, DEVICE), port.wrappers[name]
                for seg in BASELINE_SWEEP_SEGS:
                    ms = time_cuda(torch, lambda: wrapper(text, q, table, seg), 5, queued=True)
                    sweep[name].setdefault(seg, {})[f"{c}/m={m}"] = ms
    best = {}
    for name, by_seg in sweep.items():
        totals = {seg: sum(v.values()) for seg, v in by_seg.items()}
        best[name] = min(totals, key=totals.get)
        emit({"phase": "timing-baselines", "sweep": name, "ms_summed": totals,
              "best_seg": best[name], "default_seg": bl.SEG[name], "per_case": by_seg})
    emit({"phase": "timing-baselines", "best_seg": best, "default_seg": dict(bl.SEG)})
    return summary


# ---------------------------------------------------------------------------
# The multi-device layer (main-dist)
# ---------------------------------------------------------------------------

# main-dist's two children share the one card under gloo, which carries CUDA
# tensors for all_reduce, all_gather and all_to_all_single on the H100
# machine (torch 2.11); NCCL refuses two ranks on one card
DIST_CHILD_TIMEOUT_S = 240
# the children's reduced LM run and the one-rank run held against it
DIST_SMALL = {"arch": "smollm-135m", "batch": 4, "seq": 64, "steps": 3}
DIST_TOL = 1e-5  # two ranks against one: a mean of two row-halves in float32
# the children's exchange: a table of V rows, n ids
DIST_CHILD_TABLE = (1 << 20, 16)
DIST_CHILD_IDS = 65_536


def reduced_lm(port: Port):
    """The launcher's --reduced smollm-135m at DIST_SMALL's sequence."""
    seq = DIST_SMALL["seq"]
    return dataclasses.replace(port.configs.reduced_config(DIST_SMALL["arch"]),
                               vocab=port.pipeline.VOCAB, q_chunk=seq, kv_chunk=seq, ce_chunk=seq)


def launcher_run(torch, port: Port, cfg, mesh, dev: str, batches, strategy: str = "tp_sp"):
    """launch.train's step over ``mesh`` from its seed-0 state, one batch a
    step: ((params, opt_state) as DTensors, losses, fenced ms a step)."""
    lt = port.launch_train
    B, S = batches[0]["tokens"].shape
    ocfg = port.opt.AdamWConfig(peak_lr=3e-3, warmup_steps=20, total_steps=len(batches))
    step, pspecs = lt.make_step(cfg, mesh, B, S, ocfg, strategy)
    params, state = lt.init_state(cfg, mesh, pspecs, torch.device(dev))
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, state, m = step(params, state, port.loop.batch_to(b, dev))
        losses.append(float(m["loss"]))  # a sync
        ms.append((time.perf_counter() - t0) * 1e3)
    return (params, state), losses, ms


def whole_state(port: Port, state):
    whole = port.loop.whole
    return port.lm_common.tree_map(whole, state[0]), type(state[1])(
        *port.lm_common.tree_map(whole, tuple(state[1])))


def rank_grads(torch, rank: int):
    """Rank ``rank``'s gradient-like leaves for the children's compression."""
    gen = torch.Generator(device=DEVICE).manual_seed(100 + rank)
    return {"w": torch.randn(1024, 256, generator=gen, device=DEVICE),
            "b": torch.randn(4096, generator=gen, device=DEVICE) * 1e-3}


def start_dist_children(work: Path) -> tuple:
    """Two children of this script, one gloo group on 127.0.0.1 (torchrun's
    environment), both on the one card."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_no = s.getsockname()[1]
    logs, procs = [], []
    for rank in range(2):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port_no),
               "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank)}
        logs.append(open(work / f"rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-child", str(rank),
             "--child-dir", str(work)], env=env, stdout=logs[rank], stderr=subprocess.STDOUT))
    return procs, logs


def wait_children(procs, logs, work: Path, deadline: float) -> None:
    """Wait for the children; one that fails or outlives the deadline fails
    the phase, and none outlives this call."""
    try:
        for rank, proc in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = None
            log = (work / f"rank{rank}.log").read_text()[-4000:]
            check(rc == 0, f"dist child {rank} exited {rc} (None: timed out): {log}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()


def dist_child(args) -> int:
    """One rank of main-dist's two-rank run, both ranks on the one card in
    one gloo group: a reduced LM through the launcher's step on a (2, 1)
    CPU mesh under zero_dp, its checkpoint written by rank 0; then on the
    card quantized_psum over "data", the exchange over a (1, 2) mesh (both
    paths) and the launcher's step on a (2, 1) card mesh."""
    import numpy as np
    import torch

    port = Port()
    work = Path(args.child_dir)
    compat, lt = port.compat, port.launch_train
    rank, world = compat.init_process_group(DEVICE, backend="gloo")
    check((rank, world) == (args.dist_child, 2), f"dist child joined as {(rank, world)}")
    z = np.load(work / "batches.npz")
    batches = [{"tokens": z[f"tokens{i}"], "targets": z[f"targets{i}"]}
               for i in range(DIST_SMALL["steps"])]
    cfg = reduced_lm(port)
    names = ("data", "model")
    keep = {}
    # the CPU run under zero_dp (parameters and moments sharded over data)
    cpu_mesh = compat.make_mesh((2, 1), names, device="cpu")
    state, losses, _ = launcher_run(torch, port, cfg, cpu_mesh, "cpu", batches, "zero_dp")
    port.ckpt.save(state, work / "ckpt", DIST_SMALL["steps"])
    for path, leaf in port.ckpt._flatten(whole_state(port, state)):  # gathers: every rank
        t = torch.stack(leaf) if isinstance(leaf, list) else leaf
        keep[f"ckpt/{port.ckpt._name(path)}"] = t.float().numpy()
    keep["cpu_losses"] = np.asarray(losses)
    # on the card: int8 compression over the data axis of two ranks
    mesh = compat.make_mesh((2, 1), names, device=DEVICE)
    g = rank_grads(torch, rank)
    run = compat.shard_map(lambda g, r: port.compression.quantized_psum(g, r, "data"), mesh=mesh,
                           in_specs=(compat.P(), compat.P()), out_specs=(compat.P(), compat.P()))
    out, res = run(g, port.compression.zeros_residuals(g))
    for k in g:
        keep[f"out/{k}"] = out[k].to_local().cpu().numpy()
        keep[f"res/{k}"] = res[k].to_local().cpu().numpy()
    # the exchange over a table axis of two ranks, each path timed: the
    # all-to-all, an overflow (one id for all at capacity factor 1) on the
    # reference's psum path, and the ranks holding different ids (rank 0
    # one id, rank 1 uniform ones) on the gathered psum path
    ex = port.exchange
    tmesh = compat.make_mesh((1, 2), names, device=DEVICE)
    V, d = DIST_CHILD_TABLE
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    table = torch.randn(V, d, generator=gen, device=DEVICE)
    uniform = torch.randint(0, V, (DIST_CHILD_IDS,), generator=gen, device=DEVICE)
    one_id = torch.full_like(uniform, 7)
    for name, ids, cf in (("uniform", uniform, 2.0), ("one_id", one_id, 1.0),
                          ("mixed", one_id if rank == 0 else uniform, 1.0)):
        lk = ex.make_alltoall_lookup(tmesh, "model", ("data",), capacity_factor=cf)
        ex.reset_path_counts()
        got = lk(table, ids)
        keep[f"exchange/{name}/equal"] = np.asarray(torch.equal(got.to_local(), table[ids]))
        keep[f"exchange/{name}/paths"] = np.asarray([ex.PATH_COUNTS[p] for p in ex.PATH_COUNTS])
        keep[f"exchange/{name}/ms"] = np.asarray(fenced_ms(torch, lambda: lk(table, ids), 5))
    # the launcher's step on the card
    state, losses, ms = launcher_run(torch, port, cfg, mesh, DEVICE, batches)
    keep["card_losses"] = np.asarray(losses)
    keep["card_ms"] = np.asarray(ms)
    for path, leaf in port.ckpt._flatten(whole_state(port, state)[0]):
        t = torch.stack(leaf) if isinstance(leaf, list) else leaf
        keep[f"params/{port.ckpt._name(path)}"] = t.float().cpu().numpy()
    np.savez(work / f"rank{rank}.npz", **keep)
    torch.distributed.destroy_process_group()
    return 0


def main_dist(torch, np, port: Port, seed: int, sizes: dict) -> dict:
    """The multi-device layer on the card, on a (1, 1) ("data", "model")
    mesh of this process (a one-rank group: NCCL for the card's tensors,
    gloo for the host's), and on two children in one gloo group."""
    compat, sh, lt, ck, loop, tf = (port.compat, port.sharding, port.launch_train, port.ckpt,
                                    port.loop, port.tf)
    import torch.distributed as dist

    t_phase = time.perf_counter()
    work = ROOT / "build" / "dist_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {"phase": "main-dist"}
    B, S, steps = sizes["batch"], sizes["seq"], sizes["steps"]
    # the launcher's data pipeline, counted: the parity run's batches and the
    # children's reduced ones
    port.reset_launches()
    pipe = lt.pipeline(S, B, DEVICE)
    batches = [next(pipe) for _ in range(steps)]
    small_pipe = lt.pipeline(DIST_SMALL["seq"], DIST_SMALL["batch"], DEVICE)
    small = [next(small_pipe) for _ in range(DIST_SMALL["steps"])]
    # (its one 9-byte blocklist pattern at k = 0 over 4 KiB documents takes
    # the engine's sparse count, plain PyTorch as the reference's jnp: no
    # kernel launches on this path; the counts are read all the same)
    launches = port.launches()
    out["pipeline_launches"] = {k: v for k, v in launches.items() if v}
    np.savez(work / "batches.npz", **{f"{k}{i}": b[k] for i, b in enumerate(small)
                                     for k in ("tokens", "targets")})
    children = start_dist_children(work)
    deadline = time.perf_counter() + DIST_CHILD_TIMEOUT_S
    try:
        rank, world = compat.init_process_group(DEVICE)
        check((rank, world) == (0, 1), f"main-dist: joined as {(rank, world)}")
        mesh = port.mesh.make_local_mesh(("data", "model"), device=DEVICE)
        check(compat.mesh_axes(mesh) == {"data": 1, "model": 1} and mesh.device_type == DEVICE,
              f"main-dist: mesh {mesh}")
        out["backend"] = str(dist.get_backend())

        # 1. launcher parity: the mesh step against make_train_step, step by
        # step in turns (one device, mesh, mesh, one device, ...)
        cfg = dataclasses.replace(port.configs.get_arch("smollm-135m").make_config(),
                                  vocab=port.pipeline.VOCAB)
        ocfg = port.opt.AdamWConfig(peak_lr=3e-3, warmup_steps=20, total_steps=steps)
        mesh_step, pspecs = lt.make_step(cfg, mesh, B, S, ocfg)
        state = lt.init_state(cfg, mesh, pspecs, torch.device(DEVICE))
        p1 = tf.init_params(torch.Generator(device=DEVICE).manual_seed(0), cfg, device=DEVICE)
        s1 = port.opt.adamw_init(p1)
        plain_step = loop.make_train_step(lambda p, b: tf.train_loss(p, cfg, b), ocfg)
        mesh_losses, mesh_ms, one_losses, one_ms = [], [], [], []

        def run_mesh(b):
            nonlocal state
            t0 = time.perf_counter()
            *state, m = mesh_step(*state, b)
            mesh_losses.append(float(m["loss"]))  # a sync
            mesh_ms.append((time.perf_counter() - t0) * 1e3)

        def run_one(b):
            nonlocal p1, s1
            t0 = time.perf_counter()
            p1, s1, m = plain_step(p1, s1, b)
            one_losses.append(float(m["loss"]))
            one_ms.append((time.perf_counter() - t0) * 1e3)

        for i, b in enumerate(batches):
            b = loop.batch_to(b, DEVICE)
            for run_step in ((run_one, run_mesh) if i % 2 == 0 else (run_mesh, run_one)):
                run_step(b)
        state = tuple(state)
        whole = whole_state(port, state)
        bit_equal = mesh_losses == one_losses
        try:
            same_bits(torch, whole, (p1, s1), "main-dist mesh state")
        except RuntimeError:
            bit_equal = False
        parity = {"model": "smollm-135m", "dtype": cfg.dtype, "batch": B, "seq": S,
                  "steps": steps, "bit_equal": bit_equal, "mesh_losses": mesh_losses,
                  "one_device_losses": one_losses,
                  "mesh_step_ms_median": statistics.median(mesh_ms[1:]),
                  "one_device_step_ms_median": statistics.median(one_ms[1:]),
                  "mesh_step_ms": mesh_ms, "one_device_step_ms": one_ms}
        if not bit_equal:
            parity["loss_max_rel_diff"] = max(abs(a - b) / abs(b)
                                              for a, b in zip(mesh_losses, one_losses))
            check(parity["loss_max_rel_diff"] <= TRAIN_TOL, f"main-dist losses {parity}")
            parity["state_max_rel_err"] = tree_err(torch, whole, (p1, s1), "main-dist mesh state",
                                                   TRAIN_TOL)
        out["launcher"] = parity
        grads = loop.value_and_grad(lambda p, b: tf.train_loss(p, cfg, b), p1,
                                    loop.batch_to(batches[0], DEVICE))[1]
        del p1, s1

        # 2. placement: every arch's tables on the mesh, three archs placed
        tables = {}
        for arch in port.configs.ARCH_IDS:
            spec = port.configs.get_arch(arch)
            if spec.family == "lm":
                acfg = spec.make_config()
                ps = sh.lm_param_specs(acfg, mesh)
                sh.tree_to_shardings(mesh, sh.opt_state_specs(ps))
                sh.lm_activation_table(acfg, mesh, "lm_train", B)
                sh.lm_batch_specs("lm_train", mesh, B)
            elif spec.family == "gnn":
                ps = sh.gnn_param_specs(port.gnn.param_shapes(spec.make_config("full_graph_sm")))
                sh.gnn_activation_table(mesh)
            else:
                acfg = spec.make_config()
                ps = sh.recsys_param_specs(acfg, mesh, port.recsys.param_shapes(acfg))
            tables[arch] = sum(1 for _ in named_leaves(sh.tree_to_shardings(mesh, ps)))
        out["spec_tables_leaves"] = tables
        placed = {}
        dcn_cfg = port.configs.get_arch("dcn-v2").make_config()
        gen = lambda: torch.Generator(device=DEVICE).manual_seed(seed)
        dcn = port.recsys.init_params(gen(), dcn_cfg, device=DEVICE)
        gnn = port.gnn.init_params(
            gen(), port.configs.get_arch("gatedgcn").make_config("full_graph_sm"), device=DEVICE)
        for name, whole_tree, specs in (
                ("smollm-135m", whole[0], sh.lm_param_specs(cfg, mesh)),
                ("dcn-v2", dcn, sh.recsys_param_specs(dcn_cfg, mesh, dcn)),
                ("gatedgcn", gnn, sh.gnn_param_specs(gnn))):
            dt = sh.distribute_tree(whole_tree, mesh, specs)
            n = 0
            for (path, d), (_, w) in zip(named_leaves(dt), named_leaves(whole_tree)):
                check(d.to_local().device.type == DEVICE and torch.equal(d.to_local(), w),
                      f"main-dist: {name} {path} local shard differs from the whole tensor")
                n += 1
            placed[name] = n
        out["placed_leaves"] = placed
        del gnn, dt

        # 3. int8 compression of smollm's gradient tree (float32, as the
        # launcher's all-reduce carries it), on the card and on the CPU
        g32 = port.lm_common.tree_map(lambda g: g.float(), grads)
        del grads
        P = compat.P

        def compress(m, g):
            run = compat.shard_map(lambda g, r: port.compression.quantized_psum(g, r, "data"),
                                   mesh=m, in_specs=(P(), P()), out_specs=(P(), P()))
            o, r = run(g, port.compression.zeros_residuals(g))
            return ({k: v.to_local() for k, v in named_leaves(o)},
                    {k: v.to_local() for k, v in named_leaves(r)})

        got, res = compress(mesh, g32)
        ms = fenced_ms(torch, lambda: compress(mesh, g32), 5)
        worst_err, worst_recon = 0.0, 0.0
        for name, g in named_leaves(g32):
            gmax = float(g.abs().max())
            err = float((got[name] - g).abs().max()) / max(gmax, 1e-30)
            recon = float((got[name] + res[name] - g).abs().max())
            check(err < 1e-2 and recon <= 1e-6,
                  f"main-dist compression {name}: error {err} of the max, reconstruction {recon}")
            worst_err, worst_recon = max(worst_err, err), max(worst_recon, recon)
        cpu_mesh = compat.make_mesh((1, 1), ("data", "model"), device="cpu")
        cpu_got, cpu_res = compress(cpu_mesh,
                                    port.lm_common.tree_map(lambda g: g.cpu(), g32))
        diff = max(max(float((got[k].cpu() - cpu_got[k]).abs().max()),
                       float((res[k].cpu() - cpu_res[k]).abs().max())) for k in got)
        differing = sum(int((got[k].cpu() != cpu_got[k]).sum()) for k in got)
        out["compression"] = {"leaves": len(got), "elements": sum(g.numel() for g in got.values()),
                              "max_err_of_leaf_max": worst_err, "max_reconstruction": worst_recon,
                              "ms_median": statistics.median(ms), "ms": ms,
                              "cpu_bit_equal": diff == 0.0, "cpu_max_abs_diff": diff,
                              "cpu_outputs_differing": differing}
        del g32, got, res, cpu_got, cpu_res

        # 4. the exchange on DCN-v2's largest table, both paths
        ex = port.exchange
        table = max(dcn["tables"], key=lambda t: t.shape[0])
        V, n = table.shape[0], sizes["ids"]
        rng = np.random.RandomState(seed)
        ids = {"uniform": torch.randint(0, V, (n,), generator=gen(), device=DEVICE),
               "zipf": torch.from_numpy((rng.zipf(1.3, n) - 1) % V).to(DEVICE),
               "one_id": torch.full((n,), 7, dtype=torch.int64, device=DEVICE)}
        exchange = {"table_rows": V, "dim": table.shape[1], "ids": n}
        ex.reset_path_counts()
        timed = 5
        # on a table axis of one rank every id is local: the capacity factor
        # alone picks the path (below 1 the bucket overflows)
        for cf, path in ((2.0, "alltoall"), (0.5, "psum")):
            lk = ex.make_alltoall_lookup(mesh, "model", ("data",), capacity_factor=cf)
            for name, x in ids.items():
                check(torch.equal(lk(table, x).to_local(), table[x]),
                      f"main-dist: exchange {name} at capacity {cf} differs from table[ids]")
            exchange[f"{path}_ms_median"] = statistics.median(
                fenced_ms(torch, lambda: lk(table, ids["uniform"]), timed))
        counts = dict(ex.PATH_COUNTS)
        check(counts == {"alltoall": len(ids) + timed, "psum": len(ids) + timed,
                         "psum_gathered": 0},
              f"main-dist: exchange paths {counts}")
        exchange["path_counts"] = counts
        out["exchange"] = exchange
        del dcn, table, ids

        # 5. elastic restore onto the card's mesh: the mesh run's state,
        # saved by this rank, and (below) the children's CPU checkpoint
        shardings = (sh.tree_to_shardings(mesh, sh.lm_param_specs(cfg, mesh)),
                     sh.tree_to_shardings(mesh, sh.opt_state_specs(sh.lm_param_specs(cfg, mesh))))
        t0 = time.perf_counter()
        ck.save(state, work / "card_ckpt", steps)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, at = ck.restore(state, work / "card_ckpt", shardings=shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(at == steps, f"main-dist: restored step {at}")
        same_bits(torch, whole_state(port, back), whole, "main-dist restored state")
        out["restore"] = {"save_s": save_s, "restore_s": restore_s, "leaves": sum(
            1 for _ in named_leaves(whole))}
        del back, state, whole

        # 6. the one-rank run the children are held against
        small_cfg = reduced_lm(port)
        small_state, small_losses, _ = launcher_run(torch, port, small_cfg, mesh, DEVICE, small)
        small_params = whole_state(port, small_state)[0]
        wait_children(*children, work, deadline)
        out["two_ranks"] = dist_results(torch, np, port, work, small_cfg, mesh, small_params,
                                        small_losses)
    finally:
        procs, logs = children
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds_in_phase"] = time.perf_counter() - t_phase
    emit(out)
    return {"launches": launches}


def dist_results(torch, np, port: Port, work: Path, cfg, mesh, params, losses) -> dict:
    """The two children's results against this process's: the compression
    against the same sum formed here, the exchange, the launcher's losses
    and parameters against the one-rank run, and their CPU checkpoint
    restored onto the card's mesh."""
    sh, ck = port.sharding, port.ckpt
    z = [np.load(work / f"rank{r}.npz") for r in range(2)]
    # int8 compression: one grid (the max amax of the two), an exact sum
    g = [rank_grads(torch, r) for r in range(2)]
    for k in g[0]:
        amax = torch.maximum(g[0][k].abs().max(), g[1][k].abs().max())
        scale = torch.clamp(amax / torch.full((), 127.0, device=DEVICE), min=1e-30)
        q = [torch.clamp(torch.round(x[k] / scale), -127, 127) for x in g]
        total = ((q[0].to(torch.int32) + q[1].to(torch.int32)).float() * scale).cpu().numpy()
        for r in range(2):
            check(np.array_equal(z[r][f"out/{k}"], total),
                  f"main-dist: rank {r}'s compressed sum of {k} differs")
            check(np.array_equal(z[r][f"res/{k}"], (g[r][k] - q[r] * scale).cpu().numpy()),
                  f"main-dist: rank {r}'s residual of {k} differs")
    paths = {"uniform": [1, 0, 0], "one_id": [0, 1, 0], "mixed": [0, 0, 1]}
    for r in range(2):
        for name, want in paths.items():
            check(bool(z[r][f"exchange/{name}/equal"])
                  and list(z[r][f"exchange/{name}/paths"]) == want,
                  f"main-dist: rank {r}'s exchange {name}")
    # rank 0's times, each path's 5 calls (this process's phase runs on
    # the card meanwhile)
    exchange_ms = {}
    for name in paths:
        ms = z[0][f"exchange/{name}/ms"].tolist()
        exchange_ms.update({f"{name}_ms_median": statistics.median(ms), f"{name}_ms": ms})
    # the launcher's step on two ranks of the card against one
    want = {ck._name(p): (torch.stack(l) if isinstance(l, list) else l).float().cpu().numpy()
            for p, l in ck._flatten(params)}
    worst = max(abs(a - b) / abs(b) for r in range(2)
                for a, b in zip(z[r]["card_losses"], losses))
    for r in range(2):
        for name, w in want.items():
            err = float(np.abs(z[r][f"params/{name}"] - w).max()) / max(float(np.abs(w).max()), 1e-30)
            worst = max(worst, err)
    check(worst <= DIST_TOL, f"main-dist: two ranks against one {worst} > {DIST_TOL}")
    # the CPU checkpoint (zero_dp, rank 0 wrote it) restored onto the card
    pspecs = sh.lm_param_specs(cfg, mesh, "zero_dp")
    like = port.tf.param_shapes(cfg)
    back, at = ck.restore((like, port.opt.adamw_init(like)), work / "ckpt",
                          shardings=(sh.tree_to_shardings(mesh, pspecs),
                                     sh.tree_to_shardings(mesh, sh.opt_state_specs(pspecs))))
    n = 0
    for path, leaf in ck._flatten(whole_state(port, back)):
        t = torch.stack(leaf) if isinstance(leaf, list) else leaf
        check(t.device.type == DEVICE and np.array_equal(t.float().cpu().numpy(),
                                                         z[0][f"ckpt/{ck._name(path)}"]),
              f"main-dist: the two-rank CPU checkpoint's {ck._name(path)} differs on the card")
        n += 1
    return {"ranks": 2, "backend": "gloo", "max_rel_err_against_one_rank": worst,
            "tolerance": DIST_TOL, "card_step_ms": z[0]["card_ms"].tolist(),
            "cpu_checkpoint_leaves_restored": n, "checkpoint_step": at,
            "exchange_table_axis_2": {"table_rows": DIST_CHILD_TABLE[0],
                                      "dim": DIST_CHILD_TABLE[1], "ids": DIST_CHILD_IDS,
                                      **exchange_ms}}


# Every phase, in the order a bare run takes them; env and build always run
PHASES = ("compare", "compare-multi", "compare-stream", "compare-approx", "compare-automaton",
          "main", "main-multi", "main-stream", "main-approx", "main-dict", "main-serve",
          "compare-shard", "main-shard", "compare-lm", "main-lm", "main-pipeline",
          "compare-train", "main-train", "main-dist", "compare-recsys", "compare-gnn", "main-recsys",
          "main-gnn", "fault7", "compare-baselines", "timing-baselines", "timing")
# Phases that read another phase's result run it too: the main stream's host
# genome and patterns (the sharded phases), its window (megascan's timing),
# the counted main path of the baselines (their kernels-line launches)
NEEDS = {"compare-shard": ("main-stream",), "main-shard": ("main-stream",),
         "timing": ("main-stream",), "timing-baselines": ("compare-baselines",)}


def selected_phases(arg) -> list:
    """The phases of ``--phases a,b``, with what they need, in run order."""
    if not arg:
        return list(PHASES)
    asked = [p.strip() for p in arg.split(",") if p.strip()]
    unknown = sorted(set(asked) - set(PHASES))
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; known: {', '.join(PHASES)}")
    chosen = set(asked)
    for p in asked:
        chosen.update(NEEDS.get(p, ()))
    return [p for p in PHASES if p in chosen]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (default: all of them); a phase that "
                         "needs another's result runs it too: " + ", ".join(PHASES))
    # the two-process run of main-shard starts this script twice with these
    ap.add_argument("--shard-child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--child-dir", help=argparse.SUPPRESS)
    # and main-dist's two-rank run with these
    ap.add_argument("--dist-child", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.shard_child is not None:
        return shard_child(args)
    if args.dist_child is not None:
        return dist_child(args)
    run = selected_phases(args.phases)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    port = Port()
    smi = nvidia_smi()
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "phases": run})

    t0 = time.perf_counter()
    libs = port.build.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": sorted(p.name for p in libs.values())})

    compared = {"max_abs_err": {}}
    if "compare" in run:
        t0 = time.perf_counter()
        compared = compare_kernels(torch, port, args.seed,
                                   (1, 4095, 4096, 4097, 1_000_003, 64 * MIB), 16 * MIB)
        emit({"phase": "compare", **compared, "equal": True,
              "seconds": round(time.perf_counter() - t0, 3)})
    for phase, fn, name in (("compare-multi", compare_multipattern, "multipattern"),
                            ("compare-stream", compare_megascan, "megascan"),
                            ("compare-approx", compare_approx, "approx"),
                            ("compare-automaton", compare_automaton, "acscan")):
        if phase in run:
            t0 = time.perf_counter()
            got = fn(torch, np, port, args.seed)
            emit({"phase": phase, **got, "equal": True,
                  "seconds": round(time.perf_counter() - t0, 3)})
            compared["max_abs_err"][name] = got["max_abs_err"]

    launches = {name: 0 for name in port.wrappers}
    if "main" in run:
        launches = main_path(torch, np, port, args.seed, GIB, 256 * MIB)
    if "main-multi" in run:
        t0 = time.perf_counter()
        multi = main_multi(torch, np, port, args.seed,
                           {"genome": 64 * MIB, "english": 256 * MIB, "batch": (4096, 65536),
                            "mp_batch": (8, 8 * MIB)})
        emit({"phase": "main-multi", "seconds": round(time.perf_counter() - t0, 3)})
        launches["multipattern"] += multi["launches"]
    streamed = None
    if "main-stream" in run:
        t0 = time.perf_counter()
        streamed = main_stream(torch, np, port, args.seed,
                               {"genome": 4 * GIB, "traced": GIB, "kmismatch": 256 * MIB,
                                "english": 256 * MIB, "protein": 256 * MIB})
        emit({"phase": "main-stream", "seconds": round(time.perf_counter() - t0, 3)})
        launches["megascan"] += streamed["launches"]["megascan"]
    if "main-approx" in run:
        t0 = time.perf_counter()
        approx = main_approx(torch, np, port, args.seed,
                             {"protein": 256 * MIB, "english": 64 * MIB, "batch": (8, 8 * MIB)})
        emit({"phase": "main-approx", "seconds": round(time.perf_counter() - t0, 3)})
        launches["approx"] += approx["launches"]
    # the main path launches acscan's counts mode (count_automaton)
    if "main-dict" in run:
        t0 = time.perf_counter()
        dicts = main_dict(torch, np, port, args.seed,
                          {"text": 256 * MIB, "batch": (4096, 65536), "stream": GIB})
        emit({"phase": "main-dict", "seconds": round(time.perf_counter() - t0, 3)})
        launches["acscan"] += dicts["launches"]["acscan_counts"]
    if "main-serve" in run:
        t0 = time.perf_counter()
        served = main_serve(torch, np, port, args.seed, {"text": 256 * MIB})
        emit({"phase": "main-serve", "seconds": round(time.perf_counter() - t0, 3)})
        launches["acscan"] += served["acscan_counts_launches"]
    if "compare-shard" in run:
        t0 = time.perf_counter()
        compared_sh = compare_shard(torch, np, port, args.seed, streamed["host"], streamed["pats"],
                                    {"texts": (40, 203, MIB + 7, 6 * MIB + 13),
                                     "chunk": 256 * 1024, "positions_max": 2 * MIB,
                                     "distributed": 8 * MIB})
        emit({"phase": "compare-shard", **compared_sh, "equal": True,
              "seconds": round(time.perf_counter() - t0, 3)})
    if "main-shard" in run:
        t0 = time.perf_counter()
        sharded = main_shard(torch, np, port, args.seed, streamed["host"], streamed["pats"],
                             {"genome": 4 * GIB, "faulted": GIB, "positions": 256 * MIB,
                              "children": 512 * MIB, "distributed": GIB}, smi)
        emit({"phase": "main-shard", "launches": sharded["launches"],
              "seconds": round(time.perf_counter() - t0, 3)})
        # every launch of the sharded path: megascan a count window, multipattern
        # for the 'b' groups of a positions window, EPSM 8 a distributed count
        for name, v in sharded["launches"].items():
            launches["acscan" if name == "acscan_counts" else name] += v
    if streamed is not None:
        del streamed["host"]
    if "compare-lm" in run:
        t0 = time.perf_counter()
        compared_lm = compare_lm(torch, np, port, args.seed, {"steps": 8, "moe_layers": 1})
        emit({"phase": "compare-lm", **compared_lm,
              "seconds": round(time.perf_counter() - t0, 3)})
    if "main-lm" in run:
        t0 = time.perf_counter()
        lm = main_lm(torch, np, port, args.seed,
                     {"batch": 8, "prompt": 512, "new_tokens": 256, "max_len": 1024})
        emit({"phase": "main-lm", "seconds": round(time.perf_counter() - t0, 3)})
        # the stop scan's multipattern ('b' stops) and approx (fuzzy stops)
        for name, v in lm["launches"].items():
            launches[name] += v
    if "main-pipeline" in run:
        t0 = time.perf_counter()
        piped = main_pipeline(torch, np, port, args.seed,
                              {"text": 128 * MIB, "k1_text": 32 * MIB, "dedup_text": 4 * MIB})
        emit({"phase": "main-pipeline", "launches": piped["launches"],
              "seconds": round(time.perf_counter() - t0, 3)})
        # the pipeline's megascan (oversize documents), approx (dense
        # k-mismatch counts) and acscan (automaton routes)
        for name, v in piped["launches"].items():
            if name != "acscan":
                launches["acscan" if name == "acscan_counts" else name] += v
    if "compare-train" in run:
        t0 = time.perf_counter()
        compared_tr = compare_train(torch, np, port, args.seed, {"steps": 2, "moe_layers": 1})
        emit({"phase": "compare-train", **compared_tr,
              "seconds": round(time.perf_counter() - t0, 3)})
    if "main-train" in run:
        t0 = time.perf_counter()
        trained = main_train(torch, np, port, args.seed,
                             {"batch": 8, "seq": 1024, "steps": 60, "ckpt_every": 20,
                              "fault_at": 45, "text": 2 * MIB})
        emit({"phase": "main-train", "launches": trained["launches"],
              "seconds": round(time.perf_counter() - t0, 3)})
        # the training data plane's filter: approx a length group a dispatch
        # (k = 1), megascan a window of the oversize documents
        for name in ("approx", "megascan"):
            launches[name] += trained["launches"][name]
    if "main-dist" in run:
        t0 = time.perf_counter()
        distd = main_dist(torch, np, port, args.seed,
                          {"batch": 8, "seq": 1024, "steps": 10, "ids": 1 << 20})
        emit({"phase": "main-dist", "launches": {k: v for k, v in distd["launches"].items() if v},
              "seconds": round(time.perf_counter() - t0, 3)})
        # the launcher's data pipeline
        for name, v in distd["launches"].items():
            launches["acscan" if name == "acscan_counts" else name] += v
    if "compare-recsys" in run:
        t0 = time.perf_counter()
        compared_rs = compare_recsys(torch, np, port, args.seed,
                                     {"batch": 256, "candidates": 4096})
        emit({"phase": "compare-recsys", **compared_rs,
              "seconds": round(time.perf_counter() - t0, 3)})
    reddit = None
    if "compare-gnn" in run or "main-gnn" in run:
        t0 = time.perf_counter()
        reddit = reddit_graph(np, port, args.seed)
        emit({"phase": "reddit-graph", "nodes": reddit.n_nodes, "edges": reddit.n_edges,
              "d_feat": int(reddit.feats.shape[1]),
              "seconds": round(time.perf_counter() - t0, 3)})
    if "compare-gnn" in run:
        t0 = time.perf_counter()
        compared_gnn = compare_gnn(torch, np, port, args.seed, reddit)
        emit({"phase": "compare-gnn", **compared_gnn,
              "seconds": round(time.perf_counter() - t0, 3)})
    if "main-recsys" in run:
        t0 = time.perf_counter()
        main_recsys(torch, np, port, args.seed,
                    {"serve_batch": 512, "serve_calls": 50, "bulk_batch": 262_144,
                     "bulk_calls": 5, "candidates": 1_000_000,
                     "train_batch": 65_536, "train_steps": 20})
        emit({"phase": "main-recsys", "seconds": round(time.perf_counter() - t0, 3)})
    if "main-gnn" in run:
        t0 = time.perf_counter()
        main_gnn(torch, np, port, args.seed, reddit,
                 {"steps": {"minibatch_lg": 10, "molecule": 20, "full_graph_sm": 20}})
        emit({"phase": "main-gnn", "seconds": round(time.perf_counter() - t0, 3)})
    del reddit
    if "fault7" in run:
        t0 = time.perf_counter()
        fault7_case(torch, np, port, args.seed, 4 * MIB)
        emit({"phase": "fault7", "seconds": round(time.perf_counter() - t0, 3)})
    if "compare-baselines" in run:
        t0 = time.perf_counter()
        compared_bl = compare_baselines(torch, np, port, args.seed, {"n": 4 * MIB, "patterns": 2})
        emit({"phase": "compare-baselines", "seconds": round(time.perf_counter() - t0, 3)})
        compared["max_abs_err"].update(compared_bl["max_abs_err"])
        # the baselines' main path: their entry points on the three corpora
        for name in BASELINE_LOOPS:
            launches[name] += compared_bl["launches"][name]
    rows = {}
    if "timing-baselines" in run:
        t0 = time.perf_counter()
        rows.update(timing_baselines(torch, np, port, args.seed, {"n": 4 * MIB}))
        emit({"phase": "timing-baselines", "seconds": round(time.perf_counter() - t0, 3)})
    if "timing" in run:
        rows.update(timing(torch, port, args.seed, GIB))
        rows["multipattern"] = timing_multipattern(torch, port, args.seed, 8, 8 * MIB, 32)
        rows.update(timing_stream_approx(torch, np, port, args.seed, 64 * MIB,
                                         streamed["window_bytes"], (8, 8 * MIB)))
        rows["acscan"] = timing_acscan(torch, np, port, args.seed, 256 * MIB)

    # one entry a kernel whose timing ran (every kernel in a bare run)
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        if name not in rows:
            continue
        row = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": compared["max_abs_err"].get(name), "match": True,
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": None, **({"mode": row["mode"]} if "mode" in row else {})})
    if run == list(PHASES):
        check(len(kernels) == len(KERNEL_SOURCES), f"{len(kernels)} kernels timed")
        check(all(k["launches"] > 0 for k in kernels),
              f"a kernel never launched on its path: {[k['name'] for k in kernels if not k['launches']]}")
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0

if __name__ == "__main__":
    sys.exit(main())
