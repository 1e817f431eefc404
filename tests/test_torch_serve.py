"""repro_torch.serve (query plane and JSON-lines server) against
repro.serve, at small sizes on the CPU.

Mirrors the cheap cases of tests/test_query_plane.py: coalesced answers
equal per-query answers in count, any and match modes (a dictionary-scale
union among them, which a spy shows taking the engine's automaton route),
the canonical union equals the reference's, admission control answers 429,
the corpus LRU evicts, 404s and reloads, a server round trip, the exported
trace passes benchmarks/validate_trace.py, and a client of each package
talks to a server of the other with equal responses.  The per-query oracle
is the reference engine's own compile and dispatch.
"""

import asyncio
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from benchmarks.validate_trace import validate_trace  # noqa: E402

from repro.core import engine as R  # noqa: E402
from repro.serve import query_plane as RQ  # noqa: E402
from repro.serve import server as RSV  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.obs import Recorder  # noqa: E402
from repro_torch.serve import query_plane as Q  # noqa: E402
from repro_torch.serve.server import GrepClient, GrepServer  # noqa: E402

CPU = "cpu"


@pytest.fixture
def rng():
    return np.random.RandomState(0x5E4E)


def _mk_text(rng, n=20_000):
    text = rng.randint(97, 123, size=n).astype(np.uint8)
    words = [b"needle", b"xy", b"longneedlepattern_over16", b"abcd"]
    for w in words * 40:
        pos = int(rng.randint(0, n - 32))
        text[pos : pos + len(w)] = np.frombuffer(w, np.uint8)
    return text.tobytes()


def _oracle_counts(text: bytes, patterns, k=0):
    """Per-query reference: its own non-canonical compile + dispatch."""
    arr = np.frombuffer(text, np.uint8)[None, :].copy()
    idx = R.build_index(arr, np.array([len(text)], np.int32))
    plans = R.compile_patterns(list(patterns), k=k)
    out = np.asarray(R.count_many(idx, plans, k=k))[0]
    return out[np.argsort(R.plan_order(plans))].astype(np.int32)


def _plane(**cfg):
    return Q.QueryPlane(Q.ServiceConfig(**cfg), device=CPU)


def test_canonical_union_equals_reference(rng):
    pats = [b"ab", b"cd", b"ef", b"abcd", b"xy", b"ab", b"longerpattern"]
    pats += [bytes(rng.randint(0, 256, size=m).astype(np.uint8)) for m in (3, 3, 5, 8, 8, 8)]
    for batch in (pats, pats[::-1], pats[:1]):
        assert Q.canonical_union(batch) == RQ.canonical_union(batch)
    union, position = Q.canonical_union(pats)
    assert sorted({len(union[position[p]]) for p in pats}) == sorted({len(p) for p in pats})
    assert all(union[position[p]] == p for p in pats)


@pytest.mark.parametrize("mode", ["count", "any", "match"])
def test_coalesced_answers_equal_per_query(rng, mode):
    """Concurrent queries with mixed lengths and shared hot patterns
    coalesce; every answer equals its own standalone reference dispatch."""
    text = b"ab" + _mk_text(rng, 6_000) + b"needle"
    pools = [[b"needle", b"xy", b"abcd"], [b"longneedlepattern_over16", b"needle"],
             [b"zz", b"qjx", b"needle", b"vwxyza"], [b"nomatchhere"]]
    queries = [pools[i % len(pools)] for i in range(12)]

    async def main():
        plane = _plane(coalesce_ms=5.0, max_batch=64, result_cache_entries=0)
        plane.add_corpus("c", text)
        results = await asyncio.gather(*[plane.query("c", q, mode=mode) for q in queries])
        await plane.close()
        return results, plane.counters

    results, counters = asyncio.run(main())
    oracle = {tuple(q): _oracle_counts(text, q) for q in pools}
    raw = np.frombuffer(text, np.uint8)
    for q, r in zip(queries, results):
        np.testing.assert_array_equal(r.counts, oracle[tuple(q)])
        assert r.counts.dtype == np.int32 and r.mode == mode
        if mode == "any":
            np.testing.assert_array_equal(r.hits, oracle[tuple(q)] > 0)
        if mode == "match":
            for pat, pos in zip(q, r.positions):
                win = np.lib.stride_tricks.sliding_window_view(raw, len(pat))
                want = np.flatnonzero((win == np.frombuffer(pat, np.uint8)).all(-1))
                np.testing.assert_array_equal(pos, want)
    assert counters["dispatches"] < counters["requests"] == len(queries)


def test_dictionary_union_takes_automaton_route(rng, monkeypatch):
    """Four concurrent 283-pattern queries coalesce into a union past
    AUTOMATON_MIN_P over a corpus that tiles the dictionary end to end (a
    fingerprint flood): the one dispatch counts through the automaton, and
    every answer equals the query's own standalone dispatch, which at 283
    patterns takes the slot-table routes instead."""
    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 0)
    pats = np.unique(rng.randint(97, 101, size=(2600, 6)).astype(np.uint8), axis=0)[:1132]
    queries = [[bytes(p) for p in pats[i * 283 : (i + 1) * 283]] for i in range(4)]
    n = 1 << 18
    text = np.concatenate([pats[i % len(pats)] for i in range(n // 6 + 1)])[:n].tobytes()
    calls = []
    orig = E._automaton_counts
    monkeypatch.setattr(E, "_automaton_counts", lambda *a, **kw: calls.append(1) or orig(*a, **kw))

    async def main():
        plane = _plane(coalesce_ms=60_000.0, flush_on_idle=False, result_cache_entries=0)
        plane.add_corpus("c", text)
        tasks = [asyncio.create_task(plane.query("c", q)) for q in queries]
        await asyncio.sleep(0)
        await plane.flush()
        results = await asyncio.gather(*tasks)
        await plane.close()
        return results, plane.counters

    results, counters = asyncio.run(main())
    assert counters["dispatches"] == 1 and len(calls) == 1
    idx = E.build_index(np.frombuffer(text, np.uint8), device=CPU)
    for q, r in zip(queries, results):
        assert r.batched == 4
        plans = E.compile_patterns(q, device=CPU)
        assert plans[0].automaton is None
        alone = E.count_many(idx, plans)[0].numpy()[np.argsort(E.plan_order(plans))]
        np.testing.assert_array_equal(r.counts, alone)
        assert int(r.counts.min()) >= 1
    assert len(calls) == 1


def test_admission_rejects_at_depth(rng):
    text = _mk_text(rng, 4_000)

    async def main():
        plane = _plane(coalesce_ms=60_000.0, max_batch=10_000, max_pending=5,
                       result_cache_entries=0, flush_on_idle=False)
        plane.add_corpus("c", text)
        parked = [asyncio.create_task(plane.query("c", [b"needle"])) for _ in range(5)]
        await asyncio.sleep(0)
        assert plane.stats()["pending"] == 5
        with pytest.raises(Q.QueryRejected):
            await plane.query("c", [b"xy"])
        assert plane.counters["rejected"] == 1
        await plane.flush()
        results = await asyncio.gather(*parked)
        await plane.close()
        return results

    results = asyncio.run(main())
    expect = _oracle_counts(text, [b"needle"])
    assert all(np.array_equal(r.counts, expect) and r.batched == 5 for r in results)


def test_corpus_lru_eviction_404_and_reload(rng):
    texts = {f"c{i}": _mk_text(rng, 8_000) for i in range(3)}
    probe = Q.CorpusCache(1 << 62, device=CPU).put("probe", texts["c0"])
    assert probe.nbytes == 8192 * (1 + 4) + 1024 * 4 + 4  # text, packed, block fps, length
    budget = probe.nbytes + 1
    loads = []

    async def main():
        plane = _plane(coalesce_ms=0.0, corpus_budget_bytes=budget)
        rec = Recorder(enabled=True, fence=False)
        plane.rec = plane.corpora.rec = rec
        for cid, t in texts.items():
            plane.add_corpus(cid, t)
        assert plane.corpora.ids() == ("c2",)
        assert [e["corpus"] for e in rec.events_named("corpus_evict")] == ["c0", "c1"]
        r = await plane.query("c2", [b"needle"])
        with pytest.raises(Q.UnknownCorpus):
            await plane.query("c0", [b"needle"])
        await plane.close()
        reloading = Q.QueryPlane(Q.ServiceConfig(coalesce_ms=0.0, corpus_budget_bytes=budget),
                                 loader=lambda cid: loads.append(cid) or texts[cid], device=CPU)
        reloading.add_corpus("c0", texts["c0"])
        reloading.add_corpus("c1", texts["c1"])  # evicts c0
        rs = await asyncio.gather(*[reloading.query("c0", [b"needle"]) for _ in range(3)])
        await reloading.close()
        return r, rs, reloading.counters

    r, rs, counters = asyncio.run(main())
    np.testing.assert_array_equal(r.counts, _oracle_counts(texts["c2"], [b"needle"]))
    assert loads == ["c0"] and counters["corpus_reloads"] == 1
    expect = _oracle_counts(texts["c0"], [b"needle"])
    assert all(np.array_equal(x.counts, expect) for x in rs)


def test_server_roundtrip_and_trace_validates(rng, tmp_path):
    text = _mk_text(rng)

    async def main():
        rec = Recorder(enabled=True, fence=True)
        plane = Q.QueryPlane(Q.ServiceConfig(coalesce_ms=1.0), recorder=rec, device=CPU)
        async with GrepServer(plane) as (host, port):
            clients = [await GrepClient.connect(host, port) for _ in range(3)]
            await clients[0].add_corpus("c", text)
            outs = await asyncio.gather(*[c.query("c", [b"needle", b"xy"]) for c in clients])
            match = await clients[1].query("c", [b"abcd"], mode="match")
            missing = await clients[0].query("nope", [b"x"])
            bad = await clients[2].request(op="nosuch")
            stats = await clients[0].stats()
            for c in clients:
                await c.close()
        return rec, outs, match, missing, bad, stats

    rec, outs, match, missing, bad, stats = asyncio.run(main())
    expect = [int(c) for c in _oracle_counts(text, [b"needle", b"xy"])]
    assert all(o["ok"] and o["counts"] == expect for o in outs)
    assert match["counts"] == [len(match["positions"][0])]
    assert match["counts"] == [int(c) for c in _oracle_counts(text, [b"abcd"])]
    assert missing["status"] == 404 and missing["error"] == "unknown_corpus"
    assert bad["status"] == 400
    assert stats["stats"]["requests"] >= 4
    out = tmp_path / "service_trace.json"
    rec.export_trace(out)
    trace = json.loads(out.read_text())
    assert validate_trace(trace) == len(trace["traceEvents"])
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"service_batch", "plan_union", "engine_dispatch"} <= names
    assert rec.metrics.summary()["histograms"]["service.request_ms"]["count"] == 4


def test_clients_and_servers_of_both_packages_interoperate(rng):
    """A reference client against a port server and a port client against a
    reference server, on the same corpus: equal responses, byte for byte
    on the wire format."""
    text = _mk_text(rng, 8_000)
    requests = [dict(op="ping"), dict(op="add_corpus", corpus="c", text=text.decode()),
                dict(op="query", corpus="c", patterns=["needle", "xy"]),
                dict(op="query", corpus="c", patterns=["needle", "xy"]),
                dict(op="query", corpus="c", patterns=["abcd", "zz"], mode="any"),
                dict(op="query", corpus="c", patterns=["needle"], mode="match"),
                dict(op="query", corpus="nope", patterns=["x"])]

    async def session(server, client_cls):
        async with server as (host, port):
            client = await client_cls.connect(host, port)
            out = [await client.request(id=i, **req) for i, req in enumerate(requests)]
            await client.close()
        return out

    port_server = GrepServer(Q.QueryPlane(Q.ServiceConfig(coalesce_ms=1.0), device=CPU))
    ref_server = RSV.GrepServer(RQ.QueryPlane(RQ.ServiceConfig(coalesce_ms=1.0)))
    a = asyncio.run(session(port_server, RSV.GrepClient))
    b = asyncio.run(session(ref_server, GrepClient))
    assert a == b
    assert a[2]["counts"] == [int(c) for c in _oracle_counts(text, [b"needle", b"xy"])]
    assert a[3]["cached"] and a[6]["status"] == 404
