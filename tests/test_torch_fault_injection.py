"""repro_torch's fault fabric against repro's, bit for bit.

Mirrors tests/test_fault_injection.py and the retry/backoff cases of
tests/test_substrate.py: a FaultPlan fires the same (action, kind, key)
events as the reference's for each seed, in isolation and through a
faulted sharded scan; faulted, stolen and partial scans equal the
reference's clean StreamScanner(use_kernel=False) for every FAULT_SEEDS
value and shard count; the watchdog, the retry classifier and the backoff
schedule (equal delays for equal seeds); the copied constants equal the
reference's.  The port runs with ``devices=["cpu"]``.  No tolerance.

Extend the sweep with FAULT_SEEDS=0,1,2,... as for the reference.
"""

import inspect
import os
import time

import numpy as np
import pytest

from repro.core import engine as R
from repro.core import remote_source as RR
from repro.core import shard_stream as RSS
from repro.core import stream as RS
from repro.dist import fault_injection as RFI
from repro.dist import fault_tolerance as RFT
from repro.dist.sharding import complement_ranges as r_complement
from repro.dist.sharding import merge_ranges as r_merge
from repro_torch.core import engine as E
from repro_torch.core import remote_source as PR
from repro_torch.core.shard_stream import PartialScanResult, ShardedStreamScanner
from repro_torch.dist import fault_injection as FI
from repro_torch.dist import fault_tolerance as FT
from repro_torch.dist.fault_injection import FaultPlan, FaultyChunkSource, FaultyRangeSource
from repro_torch.dist.fault_tolerance import BackoffPolicy

from conftest import make_text

FAULT_SEEDS = [int(s) for s in os.environ.get("FAULT_SEEDS", "0,1,2").split(",")]
SHARD_COUNTS = [1, 2, 4, 8]
CPU = ["cpu"]
FAULTS = dict(read_error_rate=0.08, truncate_rate=0.08, crash_rate=0.12, attempts_per_fault=1)


def _pats(text, n):
    return [text[501:509].copy(), text[777:779].copy(), text[n // 2 : n // 2 + 32].copy(), b"zzzz"]


@pytest.fixture(scope="module")
def corpus():
    """The 120 kB corpus and its four patterns, with the reference's clean
    single-host counts and positions (computed once for the module)."""
    text = make_text(np.random.RandomState(0xFA17), 120_000, 4)
    pats = _pats(text, len(text))
    clean = RS.StreamScanner(R.compile_patterns(pats), 4096, use_kernel=False)
    return text, E.compile_patterns(pats, device="cpu"), clean.count_many(text), clean.positions_many(text)


def _rows_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _events(plan):
    return [(e.action, e.kind, e.key) for e in plan.events]


# -- the copied constants and the plan's draws ------------------------------


def test_copied_constants_equal_the_reference():
    assert FI._FAULT_PIECE_BYTES == RFI._FAULT_PIECE_BYTES
    assert PR.DEFAULT_PART_BYTES == RR.DEFAULT_PART_BYTES
    assert [t.__name__ for t in FT._NON_RETRYABLE] == [t.__name__ for t in RFT._NON_RETRYABLE]
    def defaults(cls):  # every default but the injected sleep and recorder
        return {k: v.default for k, v in inspect.signature(cls).parameters.items()
                if k not in ("sleep", "recorder")}

    for mine, theirs in ((FT.BackoffPolicy, RFT.BackoffPolicy), (FT.StepWatchdog, RFT.StepWatchdog),
                         (FI.FaultPlan, RFI.FaultPlan), (PR.RemoteRangeReader, RR.RemoteRangeReader)):
        assert defaults(mine) == defaults(theirs), mine.__name__


def test_fault_plan_fires_the_reference_events():
    """The same seed fires the same faults at the same sites as the
    reference's plan, in any order; a different seed fires others."""
    kw = dict(read_error_rate=0.3, truncate_rate=0.3, crash_rate=0.3, latency_rate=0.3, latency_s=0.0)
    keys = [("read", (s, i)) for s in (0, 64, 4096) for i in range(50)] + [("shard", i) for i in range(20)]

    def probe(plan, order, injected, read_error):
        out = {}
        for kind, key in order:
            try:
                plan.check(kind, key)
                out[(kind, key)] = ("ok", plan.truncate(kind, key, 1000))
            except injected:
                out[(kind, key)] = "crash"
            except read_error:
                out[(kind, key)] = "read_error"
        return out

    for seed in (9, 10, 11):
        a, r = FaultPlan(seed, **kw), RFI.FaultPlan(seed, **kw)
        got = probe(a, keys, FT.InjectedFault, FI.InjectedReadError)
        assert got == probe(r, keys, RFT.InjectedFault, RFI.InjectedReadError)
        assert _events(a) == _events(r) and a.counts_by_action() == r.counts_by_action()
        assert got == probe(FaultPlan(seed, **kw), list(reversed(keys)), FT.InjectedFault,
                            FI.InjectedReadError)
    assert probe(FaultPlan(10, **kw), keys, FT.InjectedFault, FI.InjectedReadError) != probe(
        FaultPlan(11, **kw), keys, FT.InjectedFault, FI.InjectedReadError)


def test_faults_are_transient_then_heal():
    plan = FaultPlan(1, read_error_rate=1.0, attempts_per_fault=2)
    for _ in range(2):
        with pytest.raises(FI.InjectedReadError):
            plan.check("read", (0, 0))
    plan.check("read", (0, 0))  # healed on attempt 3
    perm = FaultPlan(1, read_error_rate=1.0, attempts_per_fault=None)
    for _ in range(5):
        with pytest.raises(FI.InjectedReadError):
            perm.check("read", (0, 0))
    with pytest.raises(ValueError):
        FaultPlan(0, crash_rate=1.5)


def test_truncate_is_deterministic_short_and_the_reference_fraction():
    for seed in range(6):
        got = FaultPlan(seed, truncate_rate=1.0, attempts_per_fault=None).truncate("read", (0, 3), 1000)
        want = RFI.FaultPlan(seed, truncate_rate=1.0, attempts_per_fault=None).truncate("read", (0, 3), 1000)
        assert got == want and 0 <= got < 1000


def test_faulty_sources_deliver_the_reference_pieces():
    """FaultyRangeSource and FaultyChunkSource consult the plan at the same
    sites and cut the same pieces as the reference's."""
    text = make_text(np.random.RandomState(5), 50_000, 4)
    for seed in (0, 1, 2):
        kw = dict(read_error_rate=0.2, truncate_rate=0.2, attempts_per_fault=None)
        a, r = FaultPlan(seed, **kw), RFI.FaultPlan(seed, **kw)
        for s, e in ((0, 50_000), (4096, 30_000), (7, 7)):
            outs = []
            for src in (FaultyRangeSource(text, a, piece_bytes=2048),
                        RFI.FaultyRangeSource(text, r, piece_bytes=2048)):
                try:
                    outs.append([len(p) for p in src(s, e)])
                except (FI.InjectedReadError, RFI.InjectedReadError) as exc:
                    outs.append(type(exc).__name__)
            assert outs[0] == outs[1], (seed, s, e)
        pieces = [text[i : i + 3000] for i in range(0, len(text), 3000)]
        outs = []
        for src in (FaultyChunkSource(pieces, a), RFI.FaultyChunkSource(pieces, r)):
            try:
                outs.append([len(p) for p in src])
            except (FI.InjectedReadError, RFI.InjectedReadError) as exc:
                outs.append(type(exc).__name__)
        assert outs[0] == outs[1]
        assert _events(a) == _events(r)
        assert FaultyRangeSource(text, a).total_bytes == len(text)


# -- the acceptance property: seed x shard count, bit-identical ------------


@pytest.mark.parametrize("seed", FAULT_SEEDS)
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_faulted_sharded_scan_equals_clean_oracle(corpus, seed, n_shards):
    """Transient read errors, truncations, latency spikes and shard crashes,
    recovered through retry, leave counts and positions equal to the
    reference's clean run."""
    text, plans, want, want_pos = corpus
    plan = FaultPlan(seed, latency_rate=0.05, latency_s=0.0, **FAULTS)
    sc = ShardedStreamScanner(plans, n_shards, 4096, max_retries=16, fault_plan=plan, devices=CPU,
                              backoff=BackoffPolicy(base_s=0.0, jitter=0.0))
    np.testing.assert_array_equal(sc.count_many(FaultyRangeSource(text, plan, piece_bytes=8192)), want)
    got_pos = ShardedStreamScanner(plans, n_shards, 4096, max_retries=16, fault_plan=plan,
                                   devices=CPU).positions_many(
        FaultyRangeSource(text, plan, piece_bytes=8192))
    _rows_equal(got_pos, want_pos)


@pytest.mark.parametrize("seed", FAULT_SEEDS)
def test_faulted_scan_fires_the_reference_events(corpus, seed):
    """Through a whole static sharded scan, the port consults the plan at
    the reference's sites with the reference's keys: equal fired events,
    equal retry logs."""
    text, plans, want, _ = corpus
    pats = _pats(text, len(text))
    kw = dict(latency_rate=0.05, latency_s=0.0, **FAULTS)
    plan, rplan = FaultPlan(seed, **kw), RFI.FaultPlan(seed, **kw)
    sc = ShardedStreamScanner(plans, 4, 4096, max_retries=16, fault_plan=plan, devices=CPU,
                              backoff=BackoffPolicy(base_s=0.0, jitter=0.0))
    got = sc.count_many(FaultyRangeSource(text, plan, piece_bytes=8192))
    rsc = RSS.ShardedStreamScanner(R.compile_patterns(pats), 4, 4096, max_retries=16, fault_plan=rplan,
                                   backoff=RFT.BackoffPolicy(base_s=0.0, jitter=0.0))
    rgot = rsc.count_many(RFI.FaultyRangeSource(text, rplan, piece_bytes=8192))
    np.testing.assert_array_equal(got, rgot)
    np.testing.assert_array_equal(got, want)
    assert _events(plan) == _events(rplan) and plan.counts_by_action() == rplan.counts_by_action()
    assert [(e.shard, e.attempt) for e in sc.events] == [(e.shard, e.attempt) for e in rsc.events]


@pytest.mark.parametrize("seed", FAULT_SEEDS)
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_faulted_stealing_scan_equals_clean_oracle(corpus, seed, n_shards):
    """The work-stealing path under the same schedules: sheds and steals
    repartition the stream at beta-aligned seams, the answer is unchanged."""
    text, plans, want, want_pos = corpus

    def make(fp):
        return ShardedStreamScanner(plans, n_shards, 4096, max_retries=16, fault_plan=fp, steal=True,
                                    steal_workers=3, min_steal_bytes=1024, devices=CPU,
                                    backoff=BackoffPolicy(base_s=0.0, jitter=0.0))

    plan = FaultPlan(seed, latency_rate=0.1, latency_s=0.002, **FAULTS)
    np.testing.assert_array_equal(make(plan).count_many(FaultyRangeSource(text, plan, piece_bytes=8192)),
                                  want)
    plan2 = FaultPlan(seed, latency_rate=0.1, latency_s=0.002, **FAULTS)
    _rows_equal(make(plan2).positions_many(FaultyRangeSource(text, plan2, piece_bytes=8192)), want_pos)


def test_forced_steal_is_bit_identical_and_observable():
    text = make_text(np.random.RandomState(3), 80_000, 4)
    pats = _pats(text, len(text))
    want = RS.StreamScanner(R.compile_patterns(pats), 2048).count_many(text)
    plan = FaultPlan(0, latency_rate=0.25, latency_s=0.004, attempts_per_fault=None)
    sc = ShardedStreamScanner(E.compile_patterns(pats, device="cpu"), 2, 2048, steal=True,
                              steal_workers=4, min_steal_bytes=512, max_retries=2, devices=CPU)
    np.testing.assert_array_equal(sc.count_many(FaultyRangeSource(text, plan, piece_bytes=2048)), want)
    for ev in sc.steal_events:
        assert ev.reason in ("idle", "straggler") and ev.stop > ev.start and ev.start % 8 == 0


# -- graceful degradation --------------------------------------------------


def _covered_oracle(text, pats, covered):
    """The reference's StreamScanner over each covered range (its overlap
    prefix injected): counts and positions of the occurrences ending there."""
    rp = R.compile_patterns(pats)
    oracle = RS.StreamScanner(rp, 2048)
    acc = np.zeros(len(pats), np.int64)
    rows = [[] for _ in pats]
    for s, e in covered:
        pre = text[max(0, s - oracle.overlap) : s] if s else None
        acc = acc + oracle.count_many(iter([text[s:e]]), prefix=pre, start=s)
        for p_i, r in enumerate(RS.StreamScanner(rp, 2048).positions_many(iter([text[s:e]]), prefix=pre,
                                                                           start=s)):
            rows[p_i].append(r)
    return acc, [np.concatenate(r) if r else np.zeros(0, np.int64) for r in rows]


@pytest.mark.parametrize("seed", FAULT_SEEDS)
def test_partial_result_reports_exact_missing_ranges(seed):
    """Permanent shard crashes + on_exhausted="partial": missing is exactly
    the dead shards' ranges, and counts/positions equal the reference's
    StreamScanner over the covered complement."""
    text = make_text(np.random.RandomState(seed), 64_000, 4)
    pats = _pats(text, len(text))
    plans = E.compile_patterns(pats, device="cpu")
    plan = FaultPlan(seed, crash_rate=0.4, attempts_per_fault=None)
    sc = ShardedStreamScanner(plans, 8, 2048, max_retries=1, fault_plan=plan, on_exhausted="partial",
                              devices=CPU)
    spec = sc.shard_spec(len(text))
    res = sc.count_many(text)
    assert isinstance(res, PartialScanResult)
    rplan = RFI.FaultPlan(seed, crash_rate=0.4, attempts_per_fault=None)
    dead = {i for i in range(8) if rplan._u("crash", "shard", i) < rplan.crash_rate}
    assert {i for i in range(8) if plan._u("crash", "shard", i) < plan.crash_rate} == dead
    assert res.missing == r_merge(spec.ranges[i] for i in dead)
    assert res.covered == r_complement(res.missing, len(text))
    assert res.complete == (not dead)
    assert res.covered_bytes + sum(e - s for s, e in res.missing) == len(text)
    acc, rows = _covered_oracle(text, pats, res.covered)
    np.testing.assert_array_equal(res.counts, acc.astype(res.counts.dtype))
    res_pos = ShardedStreamScanner(plans, 8, 2048, max_retries=1, on_exhausted="partial", devices=CPU,
                                   fault_plan=FaultPlan(seed, crash_rate=0.4, attempts_per_fault=None),
                                   ).positions_many(text)
    assert res_pos.missing == res.missing
    _rows_equal(res_pos.positions, rows)


def test_partial_mode_with_no_faults_is_complete(corpus):
    text, plans, want, _ = corpus
    res = ShardedStreamScanner(plans, 4, 2048, on_exhausted="partial", devices=CPU).count_many(text)
    assert isinstance(res, PartialScanResult)
    assert res.complete and res.missing == () and res.covered == ((0, len(text)),)
    assert res.coverage_fraction() == 1.0
    np.testing.assert_array_equal(res.counts, want)


def test_partial_mode_steal_path_reports_missing():
    text = make_text(np.random.RandomState(1), 64_000, 4)
    pats = _pats(text, len(text))
    plan = FaultPlan(1, crash_rate=0.5, attempts_per_fault=None)
    sc = ShardedStreamScanner(E.compile_patterns(pats, device="cpu"), 8, 2048, max_retries=1,
                              fault_plan=plan, on_exhausted="partial", steal=True, steal_workers=3,
                              min_steal_bytes=512, devices=CPU)
    res = sc.count_many(text)
    assert isinstance(res, PartialScanResult) and not res.complete
    assert all(s % 8 == 0 for s, _ in res.covered)
    acc, _ = _covered_oracle(text, pats, res.covered)
    np.testing.assert_array_equal(res.counts, acc.astype(res.counts.dtype))


def test_on_exhausted_validates():
    with pytest.raises(ValueError):
        ShardedStreamScanner(E.compile_patterns([b"xx"], device="cpu"), 2, on_exhausted="ignore",
                             devices=CPU)


# -- the retry substrate (tests/test_substrate.py) ---------------------------


def test_watchdog_detects_straggler():
    wd = FT.StepWatchdog(factor=5.0, policy="raise")
    for s in range(6):
        wd.start_step(s)
        time.sleep(0.003)
        wd.end_step()
    wd.start_step(6)
    time.sleep(0.1)
    with pytest.raises(FT.StragglerAbort):
        wd.end_step()
    assert wd.events and wd.events[0].step == 6
    with pytest.raises(ValueError):
        FT.StepWatchdog(policy="ignore")


def test_run_with_retries_classifies_errors():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise IOError("transient")
        return "ok"

    seen = []
    assert FT.run_with_retries(flaky, retries=5, on_failure=lambda a, e: seen.append(a)) == "ok"
    assert calls["n"] == 3 and seen == [0, 1]
    for exc_type in (TypeError, ValueError, KeyError, FT.FatalScanError):
        calls = {"n": 0}

        def fatal():
            calls["n"] += 1
            raise exc_type("bad plan")

        with pytest.raises(exc_type):
            FT.run_with_retries(fatal, retries=5)
        assert calls["n"] == 1
        assert FT.default_is_retryable(exc_type("x")) == RFT.default_is_retryable(
            getattr(RFT, exc_type.__name__, exc_type)("x"))
    calls = {"n": 0}

    def vflaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise ValueError("transiently malformed")
        return "healed"

    assert FT.run_with_retries(vflaky, retries=3, is_retryable=lambda e: True) == "healed"


def test_run_with_retries_backoff_schedule():
    """Delays equal the reference policy's for equal seeds, cap at max_s,
    and the final failing attempt sleeps nothing."""
    delays = []

    def always():
        raise IOError("down")

    with pytest.raises(IOError):
        FT.run_with_retries(always, retries=4, sleep=delays.append,
                            backoff=BackoffPolicy(base_s=0.1, factor=2.0, max_s=0.3, jitter=0.5, seed=3))
    ref = RFT.BackoffPolicy(base_s=0.1, factor=2.0, max_s=0.3, jitter=0.5, seed=3)
    assert delays == [ref.delay_s(a) for a in range(4)]
    for seed in (0, 1, 7, 123):
        mine, theirs = BackoffPolicy(seed=seed), RFT.BackoffPolicy(seed=seed)
        assert [mine.delay_s(a) for a in range(12)] == [theirs.delay_s(a) for a in range(12)]
    flat = BackoffPolicy(base_s=0.1, factor=2.0, max_s=0.3, jitter=0.0)
    assert [flat.delay_s(a) for a in range(4)] == pytest.approx([0.1, 0.2, 0.3, 0.3])
    with pytest.raises(ValueError):
        BackoffPolicy(jitter=2.0)
