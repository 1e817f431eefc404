"""Grep-as-a-service: the async query plane over the engine, in PyTorch.

The twin of ``repro.serve.query_plane``: the same classes, knobs,
coalescing rules and answers.  When many users grep the same hot corpora
the scarce resource is dispatches, not byte compares, and the engine
already answers P patterns x B texts in one ``count_many``/``match_many``
call (DESIGN.md §7, §14).  So concurrent queries against one corpus
coalesce into one union pattern set, one engine call runs, and the
per-pattern rows scatter back to their futures.  Every engine route is
exact, so a coalesced answer equals the per-query one (DESIGN.md §15);
docs/serving.md is the operator guide.  A coalesced union of 1024 patterns
or more takes the engine's dictionary routes, the packed automaton
included.

Layering (pure asyncio + engine calls; the wire protocol lives in
``serve/server.py``):

  * :class:`ServiceConfig` — the operator knobs: coalescing window and batch
    cap, admission depth, corpus-cache byte budget, result-cache entries.
  * :class:`CorpusCache` — device-resident ``TextIndex`` LRU keyed by corpus
    id, evicting by measured device bytes.  Corpora live on the card unless
    the plane is built with ``device="cpu"``.
  * :class:`QueryPlane` — ``await plane.query(corpus_id, patterns, ...)``:
    admission control (bounded pending depth, :class:`QueryRejected` 429s),
    per-(corpus, mode, k) coalescing buckets, canonical pow2-padded union
    compilation through ``compile_patterns_cached(..., canonical=True)``
    (PyTorch runs eagerly, so the padding buys no shared executable; it
    keeps the plan cache and the union a pure function of the batch's
    (length, pow2 group size) multiset), a keyed recent-result cache, and
    per-request latency histograms / spans through the ``Recorder``.  Every
    engine call runs on the single dispatch thread.

Trace discipline: request lifecycle telemetry is instant events + metric
observations (requests from concurrent asyncio tasks interleave, so spans
would violate the per-lane nesting contract benchmarks/validate_trace.py
enforces); proper X-spans are emitted only from the single-threaded dispatch
executor on the dedicated "dispatch" lane, where nesting is real.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.packing import resolve_device
from repro_torch.obs.recorder import NULL, Recorder


class QueryRejected(RuntimeError):
    """Admission control turned the query away (HTTP-429 analogue): the
    plane already holds ``max_pending`` queries that have been admitted but
    not yet answered.  Clients should back off and retry; the server maps
    this to ``{"error": "rejected", "status": 429}``."""


class UnknownCorpus(KeyError):
    """The corpus id is not resident and the plane has no ``loader`` to
    bring it back (HTTP-404 analogue).  Seen after LRU eviction when the
    operator runs without a reload hook — see docs/serving.md."""


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Operator knobs for the query plane (docs/serving.md has the tuning
    guide; DESIGN.md §15 the model behind each).

    coalesce_ms     micro-batching window: the first query to a
                    (corpus, mode, k) bucket opens it, everything arriving
                    within it joins the same dispatch.  Under flush_on_idle
                    (the default) the timer is only a liveness backstop —
                    it re-arms while the dispatcher is busy rather than cut
                    a growing batch into fragments — so its exact value
                    barely matters; under flush_on_idle=False it is the
                    fixed batching window.  0 disables time-based
                    coalescing.
    flush_on_idle   dispatch-clocked batching (default True): a bucket
                    flushes IMMEDIATELY when no dispatch is in flight, and
                    otherwise accumulates until a running dispatch
                    completes (or max_batch fires).  An idle service adds
                    zero batching latency; a busy one batches exactly as
                    hard as the dispatcher's backlog — False reverts to a
                    fixed-window batcher (tests use this for deterministic
                    parking).
    max_batch       flush the bucket early once it holds this many queries.
    max_pending     admission depth: queries admitted but unanswered; above
                    this, ``query()`` raises :class:`QueryRejected`.
    corpus_budget_bytes   device-byte budget for resident TextIndexes; LRU
                    eviction keeps the measured total under this.
    result_cache_entries  recent-result cache capacity (0 disables).
    """

    coalesce_ms: float = 2.0
    max_batch: int = 64
    max_pending: int = 256
    corpus_budget_bytes: int = 1 << 30
    result_cache_entries: int = 4096
    flush_on_idle: bool = True


@dataclasses.dataclass
class CorpusEntry:
    """One resident corpus: its device index plus identity/size metadata."""

    corpus_id: str
    index: engine.TextIndex
    digest: str          # sha1 of the raw bytes — result-cache identity
    nbytes: int          # measured device bytes (text+packed+block_fp+lengths)
    raw_len: int         # true byte length (before pow2 padding)


def _index_nbytes(index: engine.TextIndex) -> int:
    return int(sum(
        t.numel() * t.element_size()
        for t in (index.text, index.packed, index.block_fp, index.lengths)
    ))


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class CorpusCache:
    """Device-resident TextIndex LRU keyed by corpus id (DESIGN.md §15).

    ``put`` builds the index with the corpus padded to a power-of-two length
    (true length carried in ``TextIndex.lengths``, so padding can never
    match) — together with canonical plans this keeps the shapes of every
    dispatch to (pow2 n, pow2 P) signatures.  Eviction is least-recently-queried
    by measured device bytes against the configured budget; every eviction
    emits a ``corpus_evict`` event so the flight recorder shows WHY a later
    query missed."""

    def __init__(self, budget_bytes: int, recorder: Recorder = NULL, device=None):
        self.budget = int(budget_bytes)
        self.rec = recorder
        self.device = resolve_device(device)
        self._entries: "OrderedDict[str, CorpusEntry]" = OrderedDict()

    def put(self, corpus_id: str, data) -> CorpusEntry:
        return self.install(self.build(corpus_id, data))

    def build(self, corpus_id: str, data) -> CorpusEntry:
        """Build the device index for ``data`` WITHOUT touching the LRU —
        pure and thread-safe, so the plane's loader path can run it on an
        executor and keep the event loop responsive during the build."""
        raw = bytes(data.tobytes() if isinstance(data, np.ndarray) else data)
        if not raw:
            raise ValueError("corpus must be non-empty")
        arr = np.frombuffer(raw, np.uint8)
        n = _pow2_ceil(arr.size)
        padded = np.zeros((1, n), np.uint8)
        padded[0, : arr.size] = arr
        index = engine.build_index(
            padded, np.array([arr.size], np.int32), device=self.device
        )
        if index.device.type == "cuda":
            torch.cuda.synchronize(index.device)
        return CorpusEntry(
            corpus_id=str(corpus_id),
            index=index,
            digest=hashlib.sha1(raw).hexdigest(),
            nbytes=_index_nbytes(index),
            raw_len=arr.size,
        )

    def install(self, entry: CorpusEntry) -> CorpusEntry:
        """Insert a built entry into the LRU and evict over budget (event-
        loop side of ``put``; single-threaded with ``get``)."""
        self._entries.pop(entry.corpus_id, None)
        self._entries[entry.corpus_id] = entry
        self.rec.event(
            "corpus_load", corpus=entry.corpus_id, nbytes=entry.nbytes,
            raw_len=entry.raw_len, n=entry.index.text.shape[1],
        )
        self._evict_over_budget(keep=entry.corpus_id)
        return entry

    def get(self, corpus_id: str) -> Optional[CorpusEntry]:
        entry = self._entries.get(str(corpus_id))
        if entry is not None:
            self._entries.move_to_end(str(corpus_id))
        return entry

    def _evict_over_budget(self, keep: str) -> None:
        while self.total_bytes > self.budget and len(self._entries) > 1:
            victim_id = next(
                cid for cid in self._entries if cid != keep
            )
            victim = self._entries.pop(victim_id)
            self.rec.event(
                "corpus_evict", corpus=victim_id, nbytes=victim.nbytes,
                resident=len(self._entries),
            )
            self.rec.count("service.corpus_evictions")

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def ids(self) -> Tuple[str, ...]:
        """Resident corpus ids, least- to most-recently used."""
        return tuple(self._entries)


def _as_pattern_bytes(p) -> bytes:
    if isinstance(p, (bytes, bytearray, memoryview)):
        b = bytes(p)
    elif isinstance(p, str):
        b = p.encode("utf-8", errors="surrogateescape")
    elif isinstance(p, np.ndarray):
        b = (p if p.dtype == np.uint8 else p.astype(np.uint8)).tobytes()
    else:
        b = np.asarray(p).astype(np.uint8).tobytes()
    if not b:
        raise ValueError("patterns must be non-empty byte strings")
    return b


def _filler_pattern(m: int, i: int) -> bytes:
    """Deterministic padding pattern #i of length m.  Content is irrelevant
    to correctness (filler rows are simply never read back; a collision
    with a real pattern just duplicates a row) — it only needs to be a
    fixed function of (m, i) so padded unions are reproducible."""
    return bytes((157 * i + 89 * j + 13) % 256 for j in range(m))


def canonical_union(
    patterns: Sequence[bytes],
) -> Tuple[Tuple[bytes, ...], Dict[bytes, int]]:
    """Dedup + order + pad a batch's pattern multiset into the canonical
    union the coalesced dispatch compiles (DESIGN.md §15).

    Unique patterns are grouped by length (lengths ascending, first-seen
    order within a group — matching compile_patterns' grouping) and each
    length group is padded to the next power of two with deterministic
    filler patterns, so the compiled plans' shape signature depends only on
    the multiset of (length, pow2 group size) — the canonical-plan cache
    key.  Returns the padded union plus the pattern -> union-position
    map used to scatter engine output rows back to individual queries."""
    seen: "OrderedDict[bytes, None]" = OrderedDict()
    for p in patterns:
        seen.setdefault(p, None)
    by_len: Dict[int, List[bytes]] = {}
    for p in seen:
        by_len.setdefault(len(p), []).append(p)
    union: List[bytes] = []
    position: Dict[bytes, int] = {}
    for m in sorted(by_len):
        group = by_len[m]
        for p in group:
            position[p] = len(union)
            union.append(p)
        pad = _pow2_ceil(len(group)) - len(group)
        for i in range(pad):
            union.append(_filler_pattern(m, i))
    return tuple(union), position


@dataclasses.dataclass
class QueryResult:
    """Answer to one ``QueryPlane.query`` call.

    ``counts`` is int32[len(patterns)] in the REQUEST's pattern order
    (modes "count" and "any"; for "any" it still carries the exact counts —
    ``hits`` derives from them).  ``positions`` (mode "match" only) is one
    int64 array of match-start offsets per requested pattern.  ``cached``
    marks a result-cache hit; ``batched`` is how many queries shared the
    dispatch that produced this answer (1 = it ran alone)."""

    corpus_id: str
    mode: str
    k: int
    patterns: Tuple[bytes, ...]
    counts: Optional[np.ndarray] = None
    positions: Optional[Tuple[np.ndarray, ...]] = None
    cached: bool = False
    batched: int = 1

    @property
    def hits(self) -> Optional[np.ndarray]:
        return None if self.counts is None else self.counts > 0


class _Request:
    __slots__ = ("patterns", "future", "t0")

    def __init__(self, patterns: Tuple[bytes, ...], future, t0: float):
        self.patterns = patterns
        self.future = future
        self.t0 = t0


class _Batch:
    __slots__ = ("key", "entry", "mode", "k", "requests", "timer")

    def __init__(self, key, entry: CorpusEntry, mode: str, k: int):
        self.key = key
        self.entry = entry
        self.mode = mode
        self.k = k
        self.requests: List[_Request] = []
        self.timer: Optional[asyncio.TimerHandle] = None


_MODES = ("count", "any", "match")


class QueryPlane:
    """Coalescing asyncio front end over the batched engine (DESIGN.md §15).

    ``await query(corpus_id, patterns, mode=..., k=...)`` resolves to a
    :class:`QueryResult` whose values are bit-identical to a standalone
    ``count_many``/``match_many`` over the same corpus — coalescing changes
    WHEN and WITH WHOM a query is answered, never WHAT the answer is.

    ``loader`` (optional) maps a corpus id to its raw bytes; with it, a
    query against an evicted corpus transparently reloads instead of
    raising :class:`UnknownCorpus`.  ``recorder`` threads the flight
    recorder through: request/batch events, p50/p99 latency histograms
    (``slo_report()``), and dispatch-lane spans in the exported trace.
    ``device`` is where corpora and plans live (default: the card).

    Dispatches run on a single worker thread (``run_in_executor``) so the
    event loop keeps admitting and coalescing while the device is busy —
    arrivals during a dispatch accumulate into the NEXT batch, which is
    what makes coalescing win under load even with coalesce_ms=0."""

    def __init__(
        self,
        config: Optional[ServiceConfig] = None,
        *,
        loader: Optional[Callable[[str], bytes]] = None,
        recorder: Recorder = NULL,
        device=None,
    ):
        self.cfg = config or ServiceConfig()
        self.rec = recorder
        self.loader = loader
        self.corpora = CorpusCache(
            self.cfg.corpus_budget_bytes, recorder, device=device
        )
        self._batches: Dict[tuple, _Batch] = {}
        self._inflight = 0  # batches flushed but not yet answered
        self._tasks: set = set()
        self._results: "OrderedDict[tuple, QueryResult]" = OrderedDict()
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="svc-dispatch"
        )
        self._pending = 0
        self._reloads: Dict[str, asyncio.Task] = {}
        self.counters = {
            "requests": 0, "rejected": 0, "result_cache_hits": 0,
            "dispatches": 0, "dispatched_queries": 0, "corpus_reloads": 0,
        }

    # -- corpus management --------------------------------------------------

    def add_corpus(self, corpus_id: str, data) -> str:
        """Make ``data`` resident (device-side index built now, LRU-tracked);
        returns the content digest used in result-cache keys."""
        return self.corpora.put(corpus_id, data).digest

    async def _resident(self, corpus_id: str) -> CorpusEntry:
        cid = str(corpus_id)
        entry = self.corpora.get(cid)
        if entry is not None:
            return entry
        if self.loader is None:
            raise UnknownCorpus(cid)
        # loader + index build run on the executor so a reload never stalls
        # the event loop (admission, coalescing, other connections); one
        # in-flight reload per corpus id — concurrent misses share it
        task = self._reloads.get(cid)
        if task is None:
            task = asyncio.get_running_loop().create_task(self._reload(cid))
            self._reloads[cid] = task
            task.add_done_callback(lambda _t: self._reloads.pop(cid, None))
        return await task

    async def _reload(self, cid: str) -> CorpusEntry:
        loop = asyncio.get_running_loop()
        entry = await loop.run_in_executor(
            self._pool, lambda: self.corpora.build(cid, self.loader(cid))
        )
        self.corpora.install(entry)
        self.counters["corpus_reloads"] += 1
        self.rec.count("service.corpus_reloads")
        return entry

    # -- the query path -----------------------------------------------------

    async def query(
        self,
        corpus_id: str,
        patterns: Sequence,
        *,
        mode: str = "count",
        k: int = 0,
    ) -> QueryResult:
        """Answer one grep query; may share its engine dispatch with every
        other in-window query against the same (corpus, mode, k).

        Raises :class:`QueryRejected` when admission depth is exhausted and
        :class:`UnknownCorpus` for a non-resident corpus without a loader.
        Exact occurrence semantics are the engine's (DESIGN.md §7): ``k``
        is the per-byte mismatch budget (§8)."""
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}")
        t0 = time.perf_counter()
        pats = tuple(_as_pattern_bytes(p) for p in patterns)
        if not pats:
            raise ValueError("at least one pattern required")
        self.counters["requests"] += 1
        self.rec.count("service.requests")
        entry = await self._resident(corpus_id)

        ckey = (entry.digest, mode, int(k), pats)
        hit = self._cache_get(ckey)
        if hit is not None:
            self.counters["result_cache_hits"] += 1
            self.rec.count("service.result_cache_hits")
            self._observe_latency(t0, cached=True)
            return dataclasses.replace(hit, cached=True)

        if self._pending >= self.cfg.max_pending:
            self.counters["rejected"] += 1
            self.rec.count("service.rejected")
            self.rec.event(
                "query_rejected", corpus=str(corpus_id),
                pending=self._pending, max_pending=self.cfg.max_pending,
            )
            raise QueryRejected(
                f"admission queue full ({self._pending} pending)"
            )
        self._pending += 1

        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        req = _Request(pats, fut, t0)
        # the digest keys the bucket: if add_corpus/reload replaces the
        # content while a bucket is open, later queries open a FRESH bucket
        # against the new index instead of joining one that would answer
        # them (and populate the result cache) from the old content
        bkey = (str(corpus_id), entry.digest, mode, int(k))
        batch = self._batches.get(bkey)
        if batch is None:
            batch = _Batch(bkey, entry, mode, int(k))
            self._batches[bkey] = batch
            if self.cfg.coalesce_ms > 0 or not self.cfg.flush_on_idle:
                # coalesce_ms <= 0 under flush_on_idle: no timer at all —
                # liveness comes from the immediate-idle flush below and
                # the dispatch-completion FIFO flush in _run_batch
                batch.timer = loop.call_later(
                    max(0.0, self.cfg.coalesce_ms) / 1e3,
                    self._timer_fire, bkey, batch,
                )
        batch.requests.append(req)
        if len(batch.requests) >= self.cfg.max_batch or (
            self.cfg.flush_on_idle and self._inflight == 0
        ):
            # dispatch-clocked batching: never hold a query while the
            # dispatcher idles — arrivals during the dispatch coalesce
            # into the NEXT batch (flushed from _run_batch's finally)
            self._flush_batch(bkey, batch)
        try:
            result = await fut
        finally:
            self._pending -= 1
        self._cache_put(ckey, result)
        self._observe_latency(t0, cached=False)
        return result

    async def flush(self) -> None:
        """Flush every open coalescing bucket now and wait for the resulting
        dispatches (tests and graceful shutdown; not needed in steady state
        — timers flush on their own)."""
        for bkey, batch in list(self._batches.items()):
            self._flush_batch(bkey, batch)
        while self._tasks:
            # drop what was awaited here: gather returns without yielding
            # when every task is already done, before their done-callbacks
            # (which discard them) have run, so waiting on those would spin
            tasks = list(self._tasks)
            await asyncio.gather(*tasks, return_exceptions=True)
            self._tasks.difference_update(tasks)

    async def close(self) -> None:
        """Drain in-flight work and release the dispatch thread."""
        await self.flush()
        self._pool.shutdown(wait=True)

    # -- coalescing internals ----------------------------------------------

    def _timer_fire(self, bkey: tuple, batch: _Batch) -> None:
        if self._batches.get(bkey) is not batch:
            return  # already flushed (max_batch vs timer race)
        if self.cfg.flush_on_idle and self._inflight > 0:
            # Dispatch-clocked mode: the window must not CUT a batch while
            # the dispatcher is busy — a flush now would only queue a
            # fragment behind the running dispatch (measured: 2 ms slices
            # of a 15 ms dispatch shrink batches ~7x).  Re-arm and let the
            # completion-time FIFO flush in _run_batch take the bucket; the
            # timer survives purely as a liveness backstop.
            loop = asyncio.get_running_loop()
            batch.timer = loop.call_later(
                max(0.0, self.cfg.coalesce_ms) / 1e3,
                self._timer_fire, bkey, batch,
            )
            return
        self._flush_batch(bkey, batch)

    def _flush_batch(self, bkey: tuple, batch: _Batch) -> None:
        if self._batches.get(bkey) is not batch:
            return  # already flushed (max_batch vs timer race)
        del self._batches[bkey]
        if batch.timer is not None:
            batch.timer.cancel()
        if not batch.requests:
            return
        self._inflight += 1
        loop = asyncio.get_running_loop()
        task = loop.create_task(self._run_batch(batch))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run_batch(self, batch: _Batch) -> None:
        loop = asyncio.get_running_loop()
        try:
            per_request = await loop.run_in_executor(
                self._pool, self._dispatch, batch
            )
            for req, result in zip(batch.requests, per_request):
                if not req.future.done():
                    req.future.set_result(result)
        except Exception as exc:  # noqa: BLE001 — fan the failure out
            for req in batch.requests:
                if not req.future.done():
                    req.future.set_exception(
                        RuntimeError(f"dispatch failed: {exc!r}")
                    )
        finally:
            self._inflight -= 1
            if (
                self.cfg.flush_on_idle
                and self._inflight == 0
                and self._batches
            ):
                # dispatcher went idle with queries parked: flush the
                # OLDEST bucket now (FIFO), the rest follow as dispatches
                # complete or their coalesce_ms caps fire
                bkey = next(iter(self._batches))
                self._flush_batch(bkey, self._batches[bkey])

    def _dispatch(self, batch: _Batch) -> List[QueryResult]:
        """Runs on the single dispatch thread: compile the canonical union,
        one engine call, scatter rows back per request."""
        rec = self.rec
        entry, mode, k = batch.entry, batch.mode, batch.k
        requests = batch.requests
        flat = [p for r in requests for p in r.patterns]
        with rec.span(
            "service_batch", lane="dispatch", corpus=entry.corpus_id,
            queries=len(requests), mode=mode, k=k,
        ) as sp:
            union, position = canonical_union(flat)
            with rec.span("plan_union", lane="dispatch", p_union=len(union)):
                plans = engine.compile_patterns_cached(
                    union, k=k, canonical=True, recorder=rec,
                    device=entry.index.device,
                )
            order = engine.plan_order(plans)
            inv = np.empty(order.size, np.int64)
            inv[order] = np.arange(order.size)
            row_of = None
            with rec.span(
                "engine_dispatch", lane="dispatch",
                p_union=len(union), n=entry.index.n,
            ) as dsp:
                if mode == "match":
                    mask = engine.match_many(entry.index, plans, k=k)
                    # transfer only the rows some query asked for, padded to
                    # a pow2 row count as the reference pads them (filler
                    # rows and unrequested duplicates never cross the wire)
                    need = np.unique(np.asarray(
                        [inv[position[p]] for r in requests
                         for p in r.patterns], np.int64,
                    ))
                    pad = _pow2_ceil(need.size) - need.size
                    need_pad = np.concatenate(
                        [need, np.repeat(need[-1:], pad)]
                    )
                    sub = mask[0][torch.from_numpy(need_pad).to(mask.device)]
                    del mask
                    out = dsp.fence(sub).cpu().numpy()
                    row_of = {int(r): i for i, r in enumerate(need)}
                else:
                    counts = engine.count_many(entry.index, plans, k=k)
                    out = dsp.fence(counts[0]).cpu().numpy()
            out = np.asarray(out)
            sp.set(p_union=len(union))
        self.counters["dispatches"] += 1
        self.counters["dispatched_queries"] += len(requests)
        rec.count("service.dispatches")
        rec.observe("service.batch_queries", len(requests))
        rec.observe("service.batch_patterns", len(union))

        results: List[QueryResult] = []
        for req in requests:
            rows = np.asarray(
                [inv[position[p]] for p in req.patterns], np.int64
            )
            if mode == "match":
                positions = tuple(
                    np.flatnonzero(out[row_of[int(r)]]).astype(np.int64)
                    for r in rows
                )
                counts = np.asarray(
                    [p.size for p in positions], np.int32
                )
                results.append(QueryResult(
                    corpus_id=entry.corpus_id, mode=mode, k=k,
                    patterns=req.patterns, counts=counts,
                    positions=positions, batched=len(requests),
                ))
            else:
                results.append(QueryResult(
                    corpus_id=entry.corpus_id, mode=mode, k=k,
                    patterns=req.patterns,
                    counts=out[rows].astype(np.int32),
                    batched=len(requests),
                ))
        return results

    # -- result cache -------------------------------------------------------

    def _cache_get(self, key: tuple) -> Optional[QueryResult]:
        if self.cfg.result_cache_entries <= 0:
            return None
        hit = self._results.get(key)
        if hit is not None:
            self._results.move_to_end(key)
        return hit

    def _cache_put(self, key: tuple, result: QueryResult) -> None:
        if self.cfg.result_cache_entries <= 0:
            return
        self._results[key] = result
        self._results.move_to_end(key)
        while len(self._results) > self.cfg.result_cache_entries:
            self._results.popitem(last=False)

    # -- telemetry ----------------------------------------------------------

    def _observe_latency(self, t0: float, *, cached: bool) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        self.rec.observe("service.request_ms", ms)
        if cached:
            self.rec.observe("service.cached_request_ms", ms)

    def stats(self) -> dict:
        """Point-in-time operational snapshot: request/dispatch counters,
        coalescing ratio, cache states — the server's ``stats`` op."""
        d = self.counters["dispatches"]
        q = self.counters["dispatched_queries"]
        return {
            **self.counters,
            "coalescing_ratio": (q / d) if d else 0.0,
            "pending": self._pending,
            "resident_corpora": list(self.corpora.ids()),
            "corpus_bytes": self.corpora.total_bytes,
            "result_cache_entries": len(self._results),
            "plan_cache": engine.plan_cache_stats(),
        }

    def slo_report(self) -> dict:
        """Latency-SLO view from the recorder's histograms: p50/p99 (ms)
        of ``service.request_ms`` plus batch-size distribution.  Empty
        when the recorder is disabled (enable it to measure — the NULL
        recorder records nothing by design)."""
        hist = self.rec.metrics.summary().get("histograms", {})
        keys = (
            "service.request_ms", "service.cached_request_ms",
            "service.batch_queries", "service.batch_patterns",
        )
        return {k: hist[k] for k in keys if k in hist}
