"""repro_torch.core.shard_stream against repro.core.shard_stream, bit for bit.

Mirrors tests/test_shard_stream.py: sharded counts and positions equal the
reference's single-host StreamScanner for shard counts 1..13 and k in
{0, 1}, on the PyTorch steps and on the megascan path (its plain version on
the CPU); every shard-seam phase; shards narrower than the overlap and
empty shards; the range functions against the reference's over a seeded
sweep; path / file / callable / tensor sources; retry, fatal errors and
short reads; the multi-device cases on a repeated CPU device list; the
count merge.  Beyond the reference: device errors are never retried, the
sharded scanner builds one scanner, spec and table set a device, the
kernel build and megascan's table cache are safe under threads.  The port
runs with ``devices=["cpu"]``; the reference side runs its
StreamScanner(use_kernel=False).  No tolerance.
"""

import os
import pathlib
import stat
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import engine as R
from repro.core import stream as RS
from repro.dist import sharding as RSh
from repro_torch.core import engine as E
from repro_torch.core import shard_stream as SS
from repro_torch.core.shard_stream import (
    ShardedStreamScanner,
    ShortRangeRead,
    open_range,
    read_range,
    shard_stream_count,
    source_total_bytes,
)
from repro_torch.core.stream import Compressed, StreamScanner
from repro_torch.dist import sharding as Sh
from repro_torch.dist.compat import process_allgather_ragged, process_allsum, sum_across_devices
from repro_torch.dist.fault_tolerance import FatalScanError, InjectedFault
from repro_torch.kernels import _build
from repro_torch.kernels.megascan import megascan as MK
from repro_torch.kernels.megascan.ops import build_mega_spec

from conftest import make_text

CPU = ["cpu"]
LENGTHS = (2, 4, 8, 13, 16, 32)
SHARDS = (1, 2, 3, 4, 8, 13)
CHUNK = 997  # odd: window seams land mid-beta-block after rounding


@pytest.fixture
def rng():
    return np.random.RandomState(0x5A4D)


def _patterns(rng, text):
    """One extracted (guaranteed-hit) pattern per length, plus one random."""
    pats = []
    for m in LENGTHS:
        s = rng.randint(0, len(text) - m + 1)
        pats.append(text[s : s + m].copy())
        pats.append(rng.randint(0, 5, size=m).astype(np.uint8))
    return pats


def _plans(pats, **kw):
    return E.compile_patterns(pats, device="cpu", **kw)


def _assert_rows_equal(got, want, msg=""):
    assert len(got) == len(want)
    for r, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} row {r}")


@pytest.mark.parametrize("k", [0, 1])
def test_sharded_bit_identical_to_reference_single_host(rng, k):
    """The acceptance property: sharded count/positions equal the
    reference's single-host StreamScanner for every shard count."""
    n = int(rng.randint(3000, 6000))
    text = make_text(rng, n, 4)
    pats = _patterns(rng, text)
    rp = R.compile_patterns(pats, k=k)
    want = RS.StreamScanner(rp, CHUNK, k=k).count_many(text)
    want_pos = RS.StreamScanner(rp, CHUNK, k=k).positions_many(text)
    plans = _plans(pats, k=k)
    for S in SHARDS:
        got = ShardedStreamScanner(plans, S, CHUNK, k=k, devices=CPU).count_many(text)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} S={S}")
        pos = ShardedStreamScanner(plans, S, CHUNK, k=k, devices=CPU).positions_many(text)
        _assert_rows_equal(pos, want_pos, f"k={k} S={S}")


def test_sharded_megascan_path_bit_identical(rng):
    """use_kernel=True: every shard window goes through the megascan op (its
    plain version on the CPU) and equals the reference's two-pass scan."""
    text = make_text(rng, int(rng.randint(3000, 6000)), 4)
    pats = _patterns(rng, text)
    want = RS.StreamScanner(R.compile_patterns(pats), CHUNK, fused=False).count_many(text)
    plans = _plans(pats)
    for S in (1, 3, 13):
        sc = ShardedStreamScanner(plans, S, CHUNK, use_kernel=True, devices=CPU)
        assert sc._scanner(0).spec is not None  # the megascan path really engaged
        np.testing.assert_array_equal(sc.count_many(text), want, err_msg=f"S={S}")


def test_planted_matches_straddle_every_shard_seam_phase():
    """Occurrences planted across every shard boundary at every straddle
    phase are found exactly once, counts and positions."""
    for S in (2, 4, 8):
        for m in LENGTHS:
            pat = np.full(m, 9, np.uint8)  # alphabet disjoint from the text
            plans = _plans([pat])
            sc = ShardedStreamScanner(plans, S, 256, devices=CPU)
            text = make_text(np.random.RandomState(100 * S + m), 4096 + 13, 4)
            starts = []
            for s_i, _ in sc.shard_spec(len(text)).ranges[1:]:
                starts += [s_i - m + 1 + j for j in range(m + 1)]
            planted, last_end = [], -1
            for s in sorted({s for s in starts if 0 <= s <= len(text) - m}):
                if s > last_end:  # gaps keep runs of 9s from adding occurrences
                    text[s : s + m] = pat
                    planted.append(s)
                    last_end = s + m
            assert sc.count_many(text).tolist() == [len(planted)], f"S={S} m={m}"
            pos = ShardedStreamScanner(plans, S, 256, devices=CPU).positions_many(text)
            np.testing.assert_array_equal(pos[0], np.asarray(planted), err_msg=f"S={S} m={m}")


def test_shard_narrower_than_overlap_and_empty_shards():
    """Shards narrower than max_m - 1 and fully empty shards stay exact."""
    m = 32
    text = make_text(np.random.RandomState(7), 64, 4)
    text[5 : 5 + m] = 9  # spans shards of width 8 entirely
    plans = _plans([np.full(m, 9, np.uint8)])
    rp = R.compile_patterns([np.full(m, 9, np.uint8)])
    assert RS.StreamScanner(rp, 256).count_many(text).tolist() == [1]
    for S in (2, 8, 16, 64):
        assert ShardedStreamScanner(plans, S, 256, devices=CPU).count_many(text).tolist() == [1]
        pos = ShardedStreamScanner(plans, S, 256, devices=CPU).positions_many(text)
        np.testing.assert_array_equal(pos[0], [5], err_msg=f"S={S}")
    assert ShardedStreamScanner(plans, 8, 256, devices=CPU).count_many(text[:5].copy()).tolist() == [0]


def test_range_functions_equal_the_reference_over_a_seeded_sweep():
    """range_partition, merge_ranges, complement_ranges and the shard spec
    equal the reference's, empty and degenerate ranges included."""
    rng = np.random.RandomState(11)
    cases = [(1000, 4, 8), (7, 3, 8), (0, 2, 8), (8192, 8, 8), (5, 64, 8), (1, 1, 1), (0, 1, 1)]
    cases += [(int(rng.randint(0, 10**6)), int(rng.randint(1, 70)), int(rng.choice([1, 8, 64])))
              for _ in range(200)]
    for total, S, align in cases:
        got = Sh.range_partition(total, S, align=align)
        assert got == RSh.range_partition(total, S, align=align), (total, S, align)
        assert len(got) == S and got[0][0] == 0 and got[-1][1] == total
        ov = align * int(rng.randint(0, 5))
        spec = Sh.make_stream_shard_spec(total, S, overlap=ov, align=align)
        rspec = RSh.make_stream_shard_spec(total, S, overlap=ov, align=align)
        assert (spec.ranges, spec.overlap, spec.align, spec.n_shards) == (
            rspec.ranges, rspec.overlap, rspec.align, rspec.n_shards)
        assert [spec.prefix_range(i) for i in range(S)] == [rspec.prefix_range(i) for i in range(S)]
    for _ in range(300):
        n = int(rng.randint(0, 12))
        rs = [tuple(sorted(rng.randint(-2, 60, size=2).tolist())) for _ in range(n)]
        rs += [(5, 5), (9, 3)]  # empty and inverted ranges drop
        assert Sh.merge_ranges(rs) == RSh.merge_ranges(rs)
        total = int(rng.randint(0, 70))
        assert Sh.complement_ranges(rs, total) == RSh.complement_ranges(rs, total)
    for bad in ((-1, 2, 8), (10, 0, 8), (10, 2, 0)):
        for mod in (Sh, RSh):
            with pytest.raises(ValueError):
                mod.range_partition(bad[0], bad[1], align=bad[2])
    for mod in (Sh, RSh):
        with pytest.raises(ValueError):
            mod.make_stream_shard_spec(1000, 4, overlap=33, align=8)  # misaligned overlap


def test_sources_path_file_callable_tensor_agree(rng, tmp_path):
    text = make_text(rng, 20_000, 4)
    pats = [text[70:78].copy(), text[10:26].copy()]
    plans = _plans(pats)
    want = RS.StreamScanner(R.compile_patterns(pats), 2048).count_many(text)
    p = pathlib.Path(tmp_path) / "corpus.bin"
    p.write_bytes(text.tobytes())

    def scan(source, **kw):
        return ShardedStreamScanner(plans, 4, 2048, devices=CPU).count_many(source, **kw).tolist()

    opens = []

    def ranged(start, stop):
        opens.append((start, stop))
        return text[start:stop]

    with open(p, "rb") as f:
        got_file = scan(f)
    assert scan(p) == got_file == scan(ranged, total_bytes=len(text)) == want.tolist()
    assert scan(torch.from_numpy(text.copy())) == want.tolist()
    assert len(opens) == 7  # 4 shard bodies + 3 overlap prefixes
    assert source_total_bytes(p) == len(text)
    with pytest.raises(TypeError):
        source_total_bytes(Compressed(b"xx"))  # no random access


def test_shard_stream_count_original_order(rng):
    text = make_text(rng, 10_000, 4)
    pats = [text[70:102].copy(), text[10:12].copy(), text[500:508].copy()]
    got = shard_stream_count(text, pats, n_shards=4, chunk_bytes=1024, devices=CPU)
    want = RS.stream_count(text, pats, chunk_bytes=1024)
    assert got.tolist() == want.tolist()
    got = shard_stream_count(text, pats, n_shards=3, chunk_bytes=1024, devices=CPU * 2, steal=True)
    assert got.tolist() == want.tolist()


def test_fault_injection_retry_and_exhaustion(rng):
    text = make_text(rng, 16_000, 4)
    plans = _plans([text[70:78].copy()])
    want = StreamScanner(plans, 2048).count_many(text)
    fails = {"n": 0}

    def flaky(start, stop):
        if 8000 <= start < 12000 and fails["n"] == 0:
            fails["n"] += 1
            raise InjectedFault("shard node died")
        return text[start:stop]

    sc = ShardedStreamScanner(plans, 4, 2048, max_retries=1, devices=CPU)
    assert sc.count_many(flaky, total_bytes=len(text)).tolist() == want.tolist()
    assert [e.shard for e in sc.events] == [2] and sc.events[0].attempt == 0

    def dead(start, stop):
        raise InjectedFault("gone for good")

    sc2 = ShardedStreamScanner(plans, 4, 2048, max_retries=2, devices=CPU)
    with pytest.raises(InjectedFault):
        sc2.count_many(dead, total_bytes=len(text))
    assert len(sc2.events) == 3  # every attempt logged, then re-raised


def test_fatal_errors_bypass_the_shard_retry_budget(rng):
    text = make_text(rng, 16_000, 4)
    plans = _plans([text[70:78].copy()])
    want = StreamScanner(plans, 2048).count_many(text)
    for exc in (FatalScanError("object gone"), TypeError("bad plan")):
        calls = {"n": 0}

        def fatal(start, stop, _exc=exc):
            calls["n"] += 1
            raise _exc

        sc = ShardedStreamScanner(plans, 2, 2048, max_retries=5, devices=CPU)
        with pytest.raises(type(exc)):
            sc.count_many(fatal, total_bytes=len(text))
        assert calls["n"] == 1 and len(sc.events) == 1

    heal = {"n": 0}

    def flaky_value(start, stop):
        heal["n"] += 1
        if heal["n"] == 1:
            raise ValueError("transiently malformed")
        return text[start:stop]

    sc = ShardedStreamScanner(plans, 2, 2048, max_retries=2, devices=CPU,
                              is_retryable=lambda e: isinstance(e, ValueError))
    assert sc.count_many(flaky_value, total_bytes=len(text)).tolist() == want.tolist()


@pytest.mark.parametrize("steal", [False, True])
def test_device_errors_are_never_retried_nor_lost(rng, steal):
    """A kernel launch failure or a CUDA error is the card's, not the
    source's: it raises on the first attempt, whatever the classifier
    says, and even under on_exhausted="partial"."""
    text = make_text(rng, 16_000, 4)
    plans = _plans([text[70:78].copy()])
    for exc in (_build.KernelLaunchError("megascan kernel launch failed"),
                RuntimeError("CUDA error: an illegal memory access was encountered")):
        calls = {"n": 0}

        def broken(start, stop, _exc=exc):
            calls["n"] += 1
            raise _exc

        sc = ShardedStreamScanner(plans, 2, 2048, max_retries=5, devices=CPU, steal=steal,
                                  on_exhausted="partial", is_retryable=lambda e: True)
        with pytest.raises(type(exc)):
            sc.count_many(broken, total_bytes=len(text))
        assert calls["n"] <= 2 and len(sc.events) == calls["n"]  # one attempt a range


def test_a_lane_that_dies_outside_its_items_fails_the_scan(rng, monkeypatch):
    """A lane that raises outside a work item's retry scope (here while it
    tries to steal) fails the whole scan instead of leaving its share
    unscanned."""
    text = make_text(rng, 16_000, 4)
    plans = _plans([text[70:78].copy()])
    bounds = ShardedStreamScanner(plans, 2, 2048, devices=CPU).shard_spec(len(text)).ranges

    def slow_second_shard(start, stop):
        if start == bounds[1][0]:
            time.sleep(0.5)  # lane 1 stays active while lane 0 runs dry
        return text[start:stop]

    def broken_shed(self, min_shed):
        raise RuntimeError("lane broke while stealing")

    monkeypatch.setattr(SS._StealableScan, "try_shed", broken_shed)
    sc = ShardedStreamScanner(plans, 2, 2048, devices=CPU, steal=True, steal_workers=2)
    with pytest.raises(RuntimeError, match="lane broke"):
        sc.count_many(slow_second_shard, total_bytes=len(text))


def test_short_range_read_is_loud_not_an_undercount(rng):
    text = make_text(rng, 16_000, 4)
    plans = _plans([text[70:78].copy()])
    want = StreamScanner(plans, 2048).count_many(text)
    flaky = {"n": 0}

    def short_once(start, stop):
        if 8000 <= start < 12000 and flaky["n"] == 0:
            flaky["n"] += 1
            return text[start : stop - 100]
        return text[start:stop]

    sc = ShardedStreamScanner(plans, 4, 2048, max_retries=1, devices=CPU)
    assert sc.count_many(short_once, total_bytes=len(text)).tolist() == want.tolist()
    assert len(sc.events) == 1 and "ShortRangeRead" in sc.events[0].error
    with pytest.raises(ShortRangeRead):
        ShardedStreamScanner(plans, 4, 2048, max_retries=1, devices=CPU).count_many(
            lambda s, e: text[s : max(s, e - 7)], total_bytes=len(text))
    with pytest.raises(ShortRangeRead):
        ShardedStreamScanner(plans, 2, 2048, devices=CPU).count_many(
            lambda s, e: text[s : min(e, 9000)], total_bytes=len(text))


def test_open_range_views_do_not_copy(rng):
    text = make_text(rng, 1024, 4)
    view = open_range(text, 64, 512)
    assert isinstance(view, np.ndarray) and view.base is not None
    np.testing.assert_array_equal(read_range(text, 8, 16), text[8:16])
    np.testing.assert_array_equal(read_range(torch.from_numpy(text.copy()), 8, 16), text[8:16])


def test_repeated_device_list_placement_and_merge(rng):
    """The multi-device case on a repeated CPU device list (one card holding
    several shards is the same layout): n_shards defaults to the listed
    devices, one plan copy and one prototype scanner a distinct device."""
    text = make_text(rng, 100_000, 4)
    pats = [text[11:19].copy(), text[500:532].copy()]
    rp = R.compile_patterns(pats)
    want = RS.StreamScanner(rp, 8192).count_many(text)
    want_pos = RS.StreamScanner(rp, 8192).positions_many(text)
    plans = _plans(pats)
    sc = ShardedStreamScanner(plans, None, 8192, devices=CPU * 8)
    assert sc.n_shards == 8
    np.testing.assert_array_equal(sc.count_many(text), want)
    assert len(sc._protos) == 1
    assert sc._scanner(3).plans is sc._protos[torch.device("cpu")].plans
    _assert_rows_equal(ShardedStreamScanner(plans, None, 8192, devices=CPU * 8).positions_many(text),
                       want_pos)


def test_no_card_and_no_device_listed_raises(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plans = _plans([b"abcd"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedStreamScanner(plans, 2, 1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shard_stream_count(b"xabcdx", [b"abcd"], n_shards=2, chunk_bytes=1024)


def test_collectives_single_process():
    parts = [torch.full((3,), i + 1, dtype=torch.int32) for i in range(5)]
    got = sum_across_devices(parts)
    assert got.dtype == np.int32 and got.tolist() == [15, 15, 15]
    with pytest.raises(ValueError):
        sum_across_devices([])
    x = np.arange(4, dtype=np.int32)
    assert process_allsum(x) is not None and process_allsum(x).tolist() == [0, 1, 2, 3]
    (g,) = process_allgather_ragged(np.asarray([5, 1 << 40], np.int64))
    assert g.tolist() == [5, 1 << 40]


def test_lanes_share_one_spec_and_plan_copy_a_device(rng):
    """Every shard and lane scanner of a device shares its prototype's plans
    and megascan spec (built once), each with its own ring and count."""
    text = make_text(rng, 40_000, 4)
    pats = _patterns(rng, text)
    plans = _plans(pats)
    sc = ShardedStreamScanner(plans, 8, 2048, use_kernel=True, devices=CPU * 4, steal=True,
                              steal_workers=4, min_steal_bytes=512)
    a, b = sc._scanner(0), sc._scanner(5)
    assert a.spec is b.spec is sc._protos[torch.device("cpu")].spec and a.spec is not None
    assert a.plans is b.plans and a._ring is None and a.lane == "shard0"
    want = RS.StreamScanner(R.compile_patterns(pats), 2048).count_many(text)
    np.testing.assert_array_equal(sc.count_many(text), want)
    assert len(sc._protos) == 1


def test_held_megascan_entries_survive_eviction_and_build_once_under_threads(rng, monkeypatch):
    """megascan's table cache: an entry someone holds is never rebuilt nor
    dropped, however many others pass through the LRU; eight threads asking
    for one entry build it once."""
    text = make_text(rng, 4000, 4)
    plans = _plans([text[5:13].copy(), text[40:43].copy()])
    builds = []
    orig = MK._build_entry

    def counting(plans_, spec_):
        builds.append(id(spec_))
        return orig(plans_, spec_)

    monkeypatch.setattr(MK, "_build_entry", counting)
    spec = build_mega_spec(plans)
    held = MK.kernel_entry(plans, spec)
    others = [build_mega_spec(plans) for _ in range(3 * MK._TABLES_MAX)]
    for s in others:
        MK.kernel_entry(plans, s)
    assert MK.kernel_entry(plans, spec) is held and builds.count(id(spec)) == 1
    fresh = build_mega_spec(plans)
    got, barrier = [], threading.Barrier(8)

    def ask():
        barrier.wait()
        got.append(MK.kernel_entry(plans, fresh))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is got[0] for g in got) and builds.count(id(fresh)) == 1


def test_kernel_build_is_once_per_process_under_threads(tmp_path, monkeypatch):
    """A stand-in nvcc (g++ making an empty shared library, slowly) first on
    PATH: eight threads loading one kernel compile it once and share one
    handle."""
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        "sleep 0.3\n"
        'exec g++ -shared -fPIC -x c /dev/null -o "$out"\n'
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LIBS", {})
    got, barrier = [], threading.Barrier(8)

    def load():
        barrier.wait()
        got.append(_build.load("megascan"))

    threads = [threading.Thread(target=load) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert len(log.read_text().splitlines()) == 1  # one compile
    assert not list((tmp_path / "kernels").glob("*.tmp"))


def test_launch_counters_lose_no_update_under_threads():
    """Sixteen threads count 5000 launches each on one wrapper, with the
    interpreter switching threads as often as it can: no update is lost."""
    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(wrapper) for _ in range(5000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 5000
