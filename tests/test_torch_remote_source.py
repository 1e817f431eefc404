"""repro_torch.core.remote_source against repro.core.remote_source.

Mirrors tests/test_remote_source.py: parts, bounded prefetch, per-part
timeouts, classified retry with the seeded backoff, and the sharded scan
over the remote protocol.  Every faulted read runs the port's reader and
the reference's over the same bytes and fault plan: equal bytes, equal
RemoteReadStats, equal fired faults.  The scans run with
``devices=["cpu"]`` against the reference's StreamScanner.  No tolerance.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from repro.core import engine as R
from repro.core import remote_source as RR
from repro.core import stream as RS
from repro.dist import fault_injection as RFI
from repro.dist import fault_tolerance as RFT
from repro_torch.core import engine as E
from repro_torch.core.remote_source import FakeObjectStore, RangeReadTimeout, RemoteRangeReader
from repro_torch.core.shard_stream import ShardedStreamScanner, source_total_bytes
from repro_torch.dist.fault_injection import FaultPlan, InjectedReadError
from repro_torch.dist.fault_tolerance import BackoffPolicy, FatalScanError

from conftest import make_text


@pytest.fixture
def rng():
    return np.random.RandomState(0x4E40)


def _drain(it):
    return np.concatenate([np.asarray(c) for c in it] or [np.zeros(0, np.uint8)])


def _both(data, plan_kw, seed, reader_kw, start=0, stop=None):
    """Drain [start, stop) through the port's reader and the reference's,
    each over its own store and a fresh plan of the same seed; returns
    (bytes, stats, fired faults, backoff delays) of each side."""
    out = []
    for store_cls, plan_cls, bo in ((FakeObjectStore, FaultPlan, BackoffPolicy),
                                    (RR.FakeObjectStore, RFI.FaultPlan, RFT.BackoffPolicy)):
        plan = plan_cls(seed, **plan_kw)
        kw = dict(reader_kw)
        delays = []
        if "backoff_seed" in kw:
            kw["backoff"] = bo(base_s=0.01, jitter=0.5, seed=kw.pop("backoff_seed"))
        reader = store_cls(data, plan=plan).reader(sleep=delays.append, **kw)
        got = _drain(reader(start, len(data) if stop is None else stop))
        out.append((got, dataclasses.asdict(reader.stats), [(e.action, e.kind, e.key) for e in plan.events],
                    delays))
    return out


def test_reader_delivers_exact_bytes_in_parts(rng):
    data = make_text(rng, 10_000, 7)
    store = FakeObjectStore(data)
    reader = store.reader(part_bytes=1024, prefetch=3)
    np.testing.assert_array_equal(_drain(reader(100, 7300)), data[100:7300])
    assert (reader.stats.parts, reader.stats.gets, reader.stats.bytes, reader.stats.retries) == (8, 8, 7200, 0)
    assert source_total_bytes(reader) == len(data)
    assert len(_drain(reader(50, 50))) == 0
    ref = RR.FakeObjectStore(data).reader(part_bytes=1024, prefetch=3)
    _drain(ref(100, 7300))
    assert dataclasses.asdict(reader.stats) == dataclasses.asdict(ref.stats)


def test_reader_is_reopenable_and_bad_ranges_raise(rng):
    data = make_text(rng, 4_000, 5)
    reader = FakeObjectStore(data).reader(part_bytes=512)
    np.testing.assert_array_equal(_drain(reader(0, 2000)), _drain(reader(0, 2000)))
    for bad in ((100, 5000), (-1, 10)):
        with pytest.raises(ValueError):
            reader(*bad)
    with pytest.raises(ValueError):
        RemoteRangeReader(lambda s, e: b"")  # no total_bytes anywhere


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_transient_faults_retry_with_the_reference_stats_and_backoff(rng, seed):
    """Injected 5xx-style errors heal after one failure each: the port's
    stats, fired faults and backoff delays equal the reference's."""
    data = make_text(rng, 8_192, 4)
    (got, stats, events, delays), (rgot, rstats, revents, rdelays) = _both(
        data, dict(read_error_rate=0.3, attempts_per_fault=1), seed,
        dict(part_bytes=1024, retries=3, backoff_seed=7))
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, rgot)
    assert stats == rstats and sorted(events) == sorted(revents) and delays == rdelays
    n_faults = len([e for e in events if e[0] == "read_error"])
    assert stats["retries"] == n_faults == len(delays)
    ref = BackoffPolicy(base_s=0.01, jitter=0.5, seed=7)
    assert delays == [ref.delay_s(0) for _ in delays]  # every failed part is its attempt 0


@pytest.mark.parametrize("seed", [11, 12])
def test_short_response_is_retryable_never_delivered(rng, seed):
    data = make_text(rng, 4_096, 4)
    (got, stats, events, _), (rgot, rstats, revents, _) = _both(
        data, dict(truncate_rate=0.4, attempts_per_fault=1), seed, dict(part_bytes=512, retries=2))
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(rgot, data)
    assert stats == rstats and sorted(events) == sorted(revents)
    n_trunc = len([e for e in events if e[0] == "truncate"])
    assert n_trunc > 0 and stats["retries"] >= n_trunc


def test_permanent_fault_exhausts_retries(rng):
    data = make_text(rng, 2_048, 4)
    plan = FaultPlan(5, read_error_rate=1.0, attempts_per_fault=None)
    reader = FakeObjectStore(data, plan=plan).reader(part_bytes=512, retries=2, sleep=lambda s: None)
    with pytest.raises(InjectedReadError):
        _drain(reader(0, 1024))
    assert reader.stats.retries == 2


def test_fatal_errors_skip_the_retry_budget():
    calls = []

    def fetch(s, e):
        calls.append((s, e))
        raise FatalScanError("object gone")

    fetch.total_bytes = 4096
    reader = RemoteRangeReader(fetch, retries=5, part_bytes=1024)
    with pytest.raises(FatalScanError):
        _drain(reader(0, 1024))
    assert len(calls) == 1 and reader.stats.retries == 0


def test_timeout_abandons_the_attempt_and_retries():
    data = bytes(range(256)) * 16
    slow_once = {"left": 1}
    lock = threading.Lock()

    def fetch(s, e):
        with lock:
            slow = slow_once["left"] > 0
            slow_once["left"] -= 1
        if slow:
            time.sleep(0.25)
        return data[s:e]

    fetch.total_bytes = len(data)
    reader = RemoteRangeReader(fetch, part_bytes=1024, prefetch=1, timeout_s=0.05, retries=2,
                               sleep=lambda s: None)
    np.testing.assert_array_equal(_drain(reader(0, len(data))), np.frombuffer(data, np.uint8))
    assert reader.stats.timeouts == 1 and reader.stats.retries == 1


def test_timeout_exhaustion_raises_range_read_timeout():
    def fetch(s, e):
        time.sleep(0.2)
        return b"x" * (e - s)

    fetch.total_bytes = 1024
    reader = RemoteRangeReader(fetch, part_bytes=1024, timeout_s=0.02, retries=1, sleep=lambda s: None)
    with pytest.raises(RangeReadTimeout):
        _drain(reader(0, 1024))
    assert reader.stats.timeouts == 2


def test_prefetch_is_bounded(rng):
    data = make_text(rng, 8_192, 4)
    store = FakeObjectStore(data)
    it = store.reader(part_bytes=1024, prefetch=2)(0, len(data))
    next(it)
    assert store.gets <= 3
    _drain(it)
    assert store.gets == 8


def test_sharded_scan_over_remote_reader_is_exact(rng):
    """ShardedStreamScanner over the remote protocol with transient faults
    in the store equals the reference's local scan, counts and positions,
    with the steal path too."""
    text = make_text(rng, 60_000, 4)
    pats = [text[37:45].copy(), text[1003:1007].copy(), b"zz"]
    rp = R.compile_patterns(pats)
    want = RS.StreamScanner(rp, 4096).count_many(text)
    want_pos = RS.StreamScanner(rp, 4096).positions_many(text)
    plans = E.compile_patterns(pats, device="cpu")

    def reader():
        plan = FaultPlan(2, read_error_rate=0.1, truncate_rate=0.1, attempts_per_fault=1)
        return FakeObjectStore(text, plan=plan).reader(part_bytes=4096, retries=3, sleep=lambda s: None)

    for steal in (False, True):
        sc = ShardedStreamScanner(plans, 4, 4096, max_retries=2, steal=steal, devices=["cpu"])
        np.testing.assert_array_equal(sc.count_many(reader()), want)
        got_pos = ShardedStreamScanner(plans, 4, 4096, max_retries=2, steal=steal,
                                       devices=["cpu"]).positions_many(reader())
        for a, b in zip(got_pos, want_pos):
            np.testing.assert_array_equal(a, b)
