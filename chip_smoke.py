#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one CUDA card.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py [--seed S]

Phases, one JSON line each:

  env      torch / CUDA versions and the card's name and power limit;
  build    nvcc builds the three kernels from src/repro_torch/kernels/csrc;
  compare  each kernel's wrapper against its plain PyTorch version on the card,
           bit for bit (torch.equal on the whole mask: the outputs are exact);
  main     epsm.find / count / positions with algo="auto" on device texts of
           1 GiB genome, 256 MiB protein and 256 MiB english, with the kernels'
           launch counters set to 0 just before and read just after;
  timing   median kernel time (CUDA events) at the 1 GiB genome text beside
           the plain version's time, the memory bound, and the times of
           epsm.find and epsm.count around the kernel.

Then one line {"kernels": [...]}, the card's name and power limit as
nvidia-smi prints them, and last {"ok": true, "device": {...}}.  Any failed
check raises, so the script exits nonzero and prints no result.  It also exits
nonzero when no CUDA device is available or the port's package is missing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
GIB = 1 << 30
MIB = 1 << 20
DEVICE = "cuda"
MAIN_LENGTHS = (2, 3, 4, 8, 12, 16, 24, 32, 64)
PATTERNS_PER_LENGTH = 16
KERNEL_SOURCES = {
    "epsma": ("src/repro_torch/kernels/csrc/epsma.cu", "src/repro/kernels/epsma/epsma.py:28"),
    "epsmb": ("src/repro_torch/kernels/csrc/epsmb.cu", "src/repro/kernels/epsmb/epsmb.py:43"),
    "epsmc": ("src/repro_torch/kernels/csrc/epsmc.cu", "src/repro/kernels/epsmc/epsmc.py:47"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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

        self.epsm, self.corpus, self.build = epsm, corpus, _build
        self.wrappers = {"epsma": epsma_cuda, "epsmb": epsmb_cuda, "epsmc": epsmc_cuda}
        self.plain = {"epsma": epsma_ref, "epsmb": epsmb_ref, "epsmc": epsmc_filter_ref}


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
    for wrapper in port.wrappers.values():
        wrapper.launches = 0
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
    launches = {name: w.launches for name, w in port.wrappers.items()}
    emit({"phase": "main", "texts": per_text, "launches": launches, "expected": expected})
    check(launches == expected, f"launch counts {launches} != calls {expected}")
    check(all(v > 0 for v in launches.values()), "a kernel of the path never launched")
    del texts
    return launches


def time_cuda(torch, fn, reps: int) -> float:
    """Median milliseconds of `reps` runs of fn, each between CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
        kernel_ms = time_cuda(torch, lambda: port.wrappers[name](text, p, **kw), 20)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    port = Port()
    smi = nvidia_smi()
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "nvidia_smi": smi})

    t0 = time.perf_counter()
    libs = port.build.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": sorted(p.name for p in libs.values())})

    t0 = time.perf_counter()
    compared = compare_kernels(torch, port, args.seed,
                               (1, 4095, 4096, 4097, 1_000_003, 64 * MIB), 16 * MIB)
    emit({"phase": "compare", **compared, "equal": True,
          "seconds": round(time.perf_counter() - t0, 3)})

    launches = main_path(torch, np, port, args.seed, GIB, 256 * MIB)
    rows = timing(torch, port, args.seed, GIB)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        row = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": compared["max_abs_err"][name], "match": True,
                        "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": "bytes", "library_ms": None})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
