#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one CUDA card.

Run from the repository root, with one card and no arguments:

    python3 chip_smoke.py [--seed S]

Phases, one JSON line each (two for main-multi):

  env           torch / CUDA versions and the card's name and power limit;
  build         nvcc builds the four kernels from src/repro_torch/kernels/csrc,
                one nvcc per source, all at once;
  compare       each EPSM kernel's wrapper against its plain PyTorch version on
                the card, bit for bit (torch.equal on the whole mask: the
                outputs are exact);
  compare-multi the multi-pattern kernel against its plain version the same
                way: n, B, P, m, alphabet, flood, trailing 0x00, unaligned row
                views, LUT widths 17..22 bits, and end_min through the engine;
  main          epsm.find / count / positions with algo="auto" on device texts of
                1 GiB genome, 256 MiB protein and 256 MiB english, with the kernels'
                launch counters set to 0 just before and read just after;
  main-multi    the engine and multi-pattern API at full size (find_multi on a
                64 MiB genome, PatternSet.count_each on 256 MiB english with a
                64- and a 512-pattern set, PatternSet.blocked on a (4096, 65536)
                batch, multipattern_batched on an (8, 8 MiB) batch), each run
                between counter resets, each output checked against an
                independent path on the card afterwards;
  timing        median kernel times (CUDA events) beside the plain versions'
                times and the memory bounds, and the times of epsm.find and
                epsm.count around the EPSM kernels.

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
    "multipattern": ("src/repro_torch/kernels/csrc/multipattern.cu",
                     "src/repro/kernels/multipattern/multipattern.py:53"),
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
        from repro_torch.core import engine, multipattern
        from repro_torch.kernels.multipattern import ops as mp_ops
        from repro_torch.kernels.multipattern.multipattern import multipattern_cuda
        from repro_torch.kernels.multipattern.ref import multipattern_batched_ref

        self.epsm, self.corpus, self.build = epsm, corpus, _build
        self.engine, self.mp, self.mp_ops = engine, multipattern, mp_ops
        self.mp_cuda, self.mp_plain = multipattern_cuda, multipattern_batched_ref
        self.wrappers = {"epsma": epsma_cuda, "epsmb": epsmb_cuda, "epsmc": epsmc_cuda,
                         "multipattern": multipattern_cuda}
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
            lengths=lengths), 20)
        plain_ms = time_cuda(torch, lambda: port.mp_plain(texts, ps, lengths), 5)
        bound_ms = mp_bound_ms(B, n, P, m, plan.kbits)
        row = {"phase": "timing", "kernel": "multipattern", "B": B, "n": n, "P": P, "m": m,
               "use_lut": use_lut, "kbits": plan.kbits, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "library_ms": None, "GB_per_s": B * n * (P + 1) / (kernel_ms * 1e-3) / 1e9}
        emit(row)
        rows.append(row)
    return rows[0]


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
    t0 = time.perf_counter()
    compared_mp = compare_multipattern(torch, np, port, args.seed)
    emit({"phase": "compare-multi", **compared_mp, "equal": True,
          "seconds": round(time.perf_counter() - t0, 3)})
    compared["max_abs_err"]["multipattern"] = compared_mp["max_abs_err"]

    launches = main_path(torch, np, port, args.seed, GIB, 256 * MIB)
    t0 = time.perf_counter()
    multi = main_multi(torch, np, port, args.seed,
                       {"genome": 64 * MIB, "english": 256 * MIB, "batch": (4096, 65536),
                        "mp_batch": (8, 8 * MIB)})
    emit({"phase": "main-multi", "seconds": round(time.perf_counter() - t0, 3)})
    launches["multipattern"] = multi["launches"]
    rows = timing(torch, port, args.seed, GIB)
    rows["multipattern"] = timing_multipattern(torch, port, args.seed, 8, 8 * MIB, 32)

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
