"""Multi-host sharded streaming scans (DESIGN.md §10), in PyTorch.

The PyTorch twin of ``repro.core.shard_stream``: the same partition, seam
rule, retry, stealing and partial-result contract, answering bit for bit
what the reference answers.  On the card every shard window is one
``megascan`` launch (``StreamScanner``'s default there); the processes of a
multi-host scan form a ``torch.distributed`` gloo group
(``launch.mesh.init_stream_cluster``).

The packed filter is embarrassingly parallel over text blocks: disjoint
segments of one logical stream can be scanned independently as long as each
carries an m-1 overlap across its left boundary (Belazzougui's word-RAM
block-split argument, PAPERS.md).  :class:`~repro_torch.core.stream.
StreamScanner` already enforces exactly that seam rule between chunks of ONE
scan; this module applies it a second time, between SCANS:

  * the stream is range-partitioned into per-shard byte ranges
    ``[s_i, s_{i+1})`` with beta-aligned boundaries
    (:func:`repro_torch.dist.sharding.range_partition`), so every shard's windows
    keep the global EPSMc block phase;

  * shard i runs the ordinary StreamScanner chunk loop over its range with
    the ``roundup(max_m - 1, beta)`` overlap prefix — the bytes immediately
    before ``s_i`` — injected into its first window
    (``count_many(..., prefix=, start=)``), and end-position attribution
    makes it own exactly the occurrences whose last byte falls inside its
    range: no misses, no double counts, for ANY shard count, including
    shards narrower than ``max_m - 1`` and empty shards;

  * results merge through ``repro_torch.dist`` collectives: counts are
    summed device-side (``compat.sum_across_devices`` — per-device folds,
    then one add on the first device) then all-reduced across the
    torch.distributed processes;
    positions are already global (each shard's masks carry its byte
    offset), so the merge is an offset-shifted concat gather — shard start
    ranges are disjoint per pattern, so shard-order concatenation is
    already sorted;

  * a shard whose HOST loop fails (source error, short/truncated range
    read, injected fault) is retried ``max_retries`` times by re-opening
    its byte range and rescanning from scratch (``dist.fault_tolerance.
    run_with_retries``); partial attempts are discarded, so a retried
    shard's contribution is bit-identical to a clean pass.  Device-side
    failures are never retried: the per-shard accumulators are never
    synced mid-scan (syncing per shard would serialize the fleet), so most
    surface at the merge, outside the retry scope, and one that a launch
    reports inside it (a kernel launch error, a CUDA error) is classified
    fatal; either raises to the caller: loud, never an undercount.

Within one process, shards round-robin over the listed devices (a device
may be listed several times: one card holds several shards) and each
device's async launch queue drains concurrently (the host loop for shard
i+1 overlaps the device compute of shard i); across processes, each process
scans the shards ``i % world_size == rank`` and merges through the gloo
collectives.  Single host, single device, the sharded scan
degenerates to the plain StreamScanner and is bit-identical to it.

The ELASTIC layer (DESIGN.md §12) rides on the same seam rule:

  * ``steal=True`` runs this process's shards on a small thread-lane pool
    over a shared work deque.  A per-scan :class:`~repro_torch.dist.
    fault_tolerance.StepWatchdog` flags a straggling shard, which SHEDS its
    trailing beta-aligned byte range back onto the deque; an idle lane also
    steals the trailing half of the busiest in-flight scan.  Because any
    beta-aligned partition with overlap prefixes merges exactly (end-
    position attribution — the seam argument of DESIGN.md §10), a stolen range's
    contribution is bit-identical to the victim having finished it: steals
    repartition the stream, they never change the answer.

  * ``on_exhausted="partial"`` degrades gracefully: a shard that exhausts
    its retry budget is RECORDED, not raised, and the query returns a
    :class:`PartialScanResult` whose counts/positions cover exactly the
    merged byte ranges that were scanned, with the missing ranges explicit.

  * ``fault_plan=`` threads a :class:`~repro_torch.dist.fault_injection.FaultPlan`
    through the per-shard attempt scope (site kind ``"shard"``), so chaos
    tests crash whole shards inside the same retry machinery real failures
    exercise.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import weakref
from collections import deque
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.engine import PatternPlan
from repro_torch.core.epsm import EPSMC_BETA
from repro_torch.core.packing import as_u8_np, resolve_device
from repro_torch.core.stream import (
    Compressed,
    StreamScanner,
    _as_chunks,
    _round_up,
)
from repro_torch.dist import compat
from repro_torch.dist.fault_tolerance import (
    BackoffPolicy,
    ShardRetry,
    StepWatchdog,
    default_is_retryable,
    run_with_retries,
)
from repro_torch.dist.sharding import (
    StreamShardSpec,
    complement_ranges,
    make_stream_shard_spec,
    merge_ranges,
)
from repro_torch.obs.recorder import Recorder, logging_sink

_LOG = logging.getLogger("repro_torch.shard_stream")

# Default flight recorder: disabled (no spans/fencing — the static and
# elastic paths keep their pipeline shape) but with the module logger as an
# event sink, so steal/shed/retry/straggler events surface as log lines when
# no recorder is attached (DESIGN.md §13).
_DEFAULT_REC = Recorder(enabled=False, fence=False, sinks=(logging_sink(_LOG),))

# file-like sources share one OS handle between shards: reads go through a
# per-handle lock so concurrently-scanned shards can't interleave seek/read
_FILE_LOCKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _normalize_source(source):
    if isinstance(source, str):
        return source.encode("utf-8", errors="surrogateescape")
    if isinstance(source, torch.Tensor):
        return as_u8_np(source).reshape(-1)
    if isinstance(source, np.ndarray):
        a = source.reshape(-1)
        return a if a.dtype == np.uint8 else a.astype(np.uint8)
    return source


def _device_error(exc: BaseException) -> bool:
    """A failure of the card itself: a kernel launch that failed, CUDA's own
    errors, device memory.  Sources fail on the host; these never retry and
    never become a missing range."""
    from repro_torch.kernels._build import KernelLaunchError

    kinds = (KernelLaunchError, torch.cuda.OutOfMemoryError)
    if hasattr(torch, "AcceleratorError"):
        kinds += (torch.AcceleratorError,)
    return isinstance(exc, kinds) or (
        isinstance(exc, RuntimeError) and "CUDA error" in str(exc)
    )


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` names the current card: give it its index, so a lane thread
    can make it current and one card is one key."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _is_sliceable(source) -> bool:
    return isinstance(source, (bytes, bytearray, memoryview, np.ndarray))


def source_total_bytes(source, total_bytes: Optional[int] = None) -> int:
    """Logical length of a range-partitionable source.

    Sliceable buffers and seekable files know their own length; callable
    range sources need ``total_bytes`` (or a ``total_bytes`` attribute).
    Compressed and one-shot-iterable sources cannot be range-partitioned —
    there is no random access to hand each shard its own range."""
    if total_bytes is not None:
        return int(total_bytes)
    source = _normalize_source(source)
    if _is_sliceable(source):
        return len(source)
    if isinstance(source, os.PathLike):
        return os.stat(os.fspath(source)).st_size
    if hasattr(source, "seek") and hasattr(source, "read"):
        pos = source.tell()
        size = source.seek(0, os.SEEK_END)
        source.seek(pos)
        return int(size)
    got = getattr(source, "total_bytes", None)
    if got is not None:
        return int(got)
    if isinstance(source, Compressed):
        raise TypeError(
            "Compressed sources cannot be range-partitioned (no random "
            "access); decompress to a file/buffer first, or stream it "
            "unsharded through StreamScanner"
        )
    raise TypeError(
        f"cannot determine the length of {type(source).__name__} source; "
        "pass total_bytes= (and a callable open_range-style source)"
    )


def _file_pread_chunks(f, start: int, stop: int, lock) -> Iterator[np.ndarray]:
    pos = start
    while pos < stop:
        n = min(1 << 20, stop - pos)
        with lock:
            f.seek(pos)
            b = f.read(n)
        if not b:
            return  # short file: treat like an exhausted stream
        pos += len(b)
        yield np.frombuffer(bytes(b), np.uint8)


def open_range(source, start: int, stop: int):
    """A chunk source for bytes [start, stop) of the logical stream —
    re-openable, so a failed shard can be rescanned from scratch.

    Accepts sliceable buffers (zero-copy views), ``os.PathLike`` (a fresh
    handle per range: shards on different devices read in parallel),
    seekable file-likes (shared handle, per-handle read lock), and callables
    ``source(start, stop) -> chunk source`` for object stores / remote
    corpora."""
    source = _normalize_source(source)
    start, stop = int(start), int(stop)
    if stop < start:
        raise ValueError(f"bad range [{start}, {stop})")
    if _is_sliceable(source):
        return source[start:stop]
    if isinstance(source, os.PathLike):

        def gen():
            with open(os.fspath(source), "rb") as f:
                yield from _file_pread_chunks(f, start, stop, threading.Lock())

        return gen()
    if hasattr(source, "seek") and hasattr(source, "read"):
        lock = _FILE_LOCKS.setdefault(source, threading.Lock())
        return _file_pread_chunks(source, start, stop, lock)
    if callable(source):
        return source(start, stop)
    raise TypeError(
        f"{type(source).__name__} source supports no random access; "
        "sharded scans need a sliceable buffer, path, seekable file, or "
        "callable (start, stop) -> chunks"
    )


def read_range(source, start: int, stop: int) -> np.ndarray:
    """Materialize bytes [start, stop) on the host (overlap prefixes only —
    at most ``overlap`` bytes, never a shard body)."""
    pieces, need = [], stop - start
    for c in _as_chunks(open_range(source, start, stop)):
        pieces.append(c[:need])
        need -= len(pieces[-1])
        if need <= 0:
            break
    if not pieces:
        return np.zeros(0, np.uint8)
    return np.concatenate(pieces)


class ShortRangeRead(IOError):
    """A shard's source delivered the wrong number of bytes for its range
    (truncated file, misbehaving range callable).  Raised INSIDE the retry
    scope, so a transient short read is rescanned and a persistent one
    propagates — never a silent undercount."""


def _exact_chunks(range_source, need: int, shard: int) -> Iterator[np.ndarray]:
    got = 0
    for c in _as_chunks(range_source):
        got += len(c)
        yield c
    if got != need:
        raise ShortRangeRead(
            f"shard {shard}: range source delivered {got} bytes, "
            f"expected {need}"
        )


@dataclasses.dataclass
class StealEvent:
    """One beta-aligned trailing range moved off an in-flight scan.

    ``thief`` is the stealing lane for an idle-initiated steal, or ``None``
    for a watchdog shed (the range went to the shared deque for whichever
    lane frees up first).  ``victim`` is the ORIGIN shard id of the split
    work item — steals of stolen ranges keep the original id, so the event
    log traces every byte back to its shard."""

    victim: int
    thief: Optional[int]
    start: int
    stop: int
    reason: str  # "idle" | "straggler"


@dataclasses.dataclass
class PartialScanResult:
    """A scan that covered only part of the stream (``on_exhausted=
    "partial"``): counts/positions are exact over ``covered`` — an
    occurrence is included iff its END byte lies in a covered range — and
    ``missing`` lists the byte ranges lost to exhausted retries.  Both are
    merged, sorted, disjoint, and together tile ``[0, total_bytes)``.  A
    fully covered scan still returns this type (``complete`` is True), so
    callers opting into degradation get a stable shape."""

    total_bytes: int
    covered: Tuple[Tuple[int, int], ...]
    missing: Tuple[Tuple[int, int], ...]
    counts: Optional[np.ndarray] = None
    positions: Optional[List[np.ndarray]] = None

    @property
    def complete(self) -> bool:
        return not self.missing

    @property
    def covered_bytes(self) -> int:
        return sum(e - s for s, e in self.covered)

    def coverage_fraction(self) -> float:
        if self.total_bytes == 0:
            return 1.0
        return self.covered_bytes / self.total_bytes


class _WorkItem:
    """One schedulable byte range.  ``stop`` is mutable: sheds trim it, and
    the trimmed value is what a retry rescans / an exhausted item reports
    missing — a shed range is owned by its new item, never double-counted."""

    __slots__ = ("start", "stop", "origin")

    def __init__(self, start: int, stop: int, origin: int):
        self.start = int(start)
        self.stop = int(stop)
        self.origin = int(origin)


class _StealableScan:
    """An in-flight range scan whose trailing bytes can be stolen.

    The piece generator reserves bytes under the lock BEFORE yielding them
    (``pos`` is the commit point), and :meth:`try_shed` only ever splits at
    a beta-aligned point strictly past ``pos`` — so a steal can never take
    back bytes the scanner already consumed, and the victim's scan simply
    ends early at the new ``stop``.  Both sides of the split keep the global
    EPSMc block phase (the split point is beta-aligned) and the thief
    injects the standard overlap prefix, so the merged result is
    bit-identical to the unsplit scan (DESIGN.md §12)."""

    def __init__(self, source, start: int, stop: int, *, align: int, piece_bytes: int):
        self.source = source
        self.start = int(start)
        self.pos = int(start)        # bytes committed to the scanner
        self.stop = int(stop)        # mutable: sheds trim it
        self.align = int(align)
        self.piece_bytes = max(1, int(piece_bytes))
        self.retired = False  # set when the attempt ends; refuses late sheds
        self.lock = threading.Lock()

    def remaining(self) -> int:
        with self.lock:
            return self.stop - self.pos

    def retire(self) -> int:
        """End of attempt: freeze ``stop`` against further sheds and return
        it.  Atomic with try_shed, so a shed either lands before the frozen
        stop is recorded (the retry excludes it) or is refused — a stolen
        range is never also rescanned by its victim."""
        with self.lock:
            self.retired = True
            return self.stop

    def try_shed(self, min_shed: int) -> Optional[Tuple[int, int]]:
        """Split off the trailing ~half of the unscanned range at a beta-
        aligned point; returns the shed (start, stop) or None if what's
        left is too small to be worth a second overlap-prefix read."""
        with self.lock:
            if self.retired:
                return None
            lo = _round_up(self.pos, self.align)
            mid = self.pos + (self.stop - self.pos) // 2
            split = max(lo, _round_up(mid, self.align))
            if split >= self.stop or self.stop - split < min_shed:
                return None
            shed = (split, self.stop)
            self.stop = split
            return shed

    def chunks(self) -> Iterator[np.ndarray]:
        """Reserve-then-yield piece stream over [start, stop), audited:
        under-delivery raises ShortRangeRead inside the retry scope.  The
        underlying range is opened at the CURRENT stop; a later shed just
        stops consumption early at the trimmed stop."""
        opened_stop = self.stop
        it = _as_chunks(open_range(self.source, self.start, opened_stop))
        for piece in it:
            off = 0
            while off < len(piece):
                with self.lock:
                    if self.pos >= self.stop:
                        return  # trailing bytes were shed
                    take = min(
                        self.piece_bytes, len(piece) - off, self.stop - self.pos
                    )
                    self.pos += take
                yield piece[off : off + take]
                off += take
        with self.lock:
            if self.pos < self.stop:
                raise ShortRangeRead(
                    f"range [{self.start}, {self.stop}): source delivered "
                    f"{self.pos - self.start} bytes, "
                    f"expected {self.stop - self.start}"
                )


class ShardedStreamScanner:
    """Range-partitioned streaming matcher: S shards, one seam rule, exact.

    ``devices`` lists where the shards run; a device may be listed more than
    once, so one card holds several shards.  None means every local card
    (and raises without one); the CPU runs only when listed, as in
    ``devices=["cpu"]``.  ``n_shards`` defaults to the listed devices times
    the processes of the torch.distributed group.  Within a process, shards
    round-robin over ``devices``; every device gets one copy of the plans
    (``engine.replicate_plans``) and one prototype :class:`StreamScanner`,
    built once and shared by every shard and lane on it, so the megascan
    spec and its tables are built once per (plan set, device).  Each shard's
    launches enqueue on its device's current stream, so the scans drain
    concurrently.  Across processes, each process owns the shards
    ``i % world_size == rank``.

    ``use_kernel`` is :class:`StreamScanner`'s: None (the default) counts
    every window with the megascan kernel on a CUDA device and with the
    PyTorch steps on the CPU; False pins the PyTorch steps; outputs are
    identical either way.

    Results are bit-identical to a single-host :class:`StreamScanner` for
    every shard count.

    ``recorder`` (DESIGN.md §13) threads one flight recorder through every
    layer of a scan: per-shard/per-lane ``scan_range`` spans wrapping the
    chunk loop's ``host_prep``/``device_put``/``dispatch`` spans, ``steal``
    / ``shed`` / ``straggler`` / ``range_done`` / ``range_lost`` instant
    events whose beta-aligned byte ranges exactly tile the input, and the
    retry loop's ``retry``/``retry_exhausted`` events.  A ``fault_plan``
    without its own recorder inherits this one, so a chaos trace shows each
    injected fault next to the retry it triggered.

    Retries cover SOURCE errors, as in the reference: a failed launch or any
    other CUDA error raises to the caller, whatever ``is_retryable`` says
    of it, and is never rerun on another path.
    """

    def __init__(
        self,
        plans: Sequence[PatternPlan],
        n_shards: Optional[int] = None,
        chunk_bytes="auto",
        *,
        k: Optional[int] = None,
        devices=None,
        max_retries: int = 1,
        fused: bool = True,
        use_kernel: Optional[bool] = None,
        steal: bool = False,
        steal_workers: Optional[int] = None,
        min_steal_bytes: Optional[int] = None,
        straggler_factor: float = 3.0,
        on_exhausted: str = "raise",
        is_retryable=None,
        backoff: Optional[BackoffPolicy] = None,
        fault_plan=None,
        recorder: Optional[Recorder] = None,
    ):
        if on_exhausted not in ("raise", "partial"):
            raise ValueError(
                f"on_exhausted must be 'raise' or 'partial', got {on_exhausted!r}"
            )
        # one recorder serves every per-shard scanner, the retry loops, and
        # (when the caller didn't wire one) the fault plan, so a single
        # trace shows each injection next to the retry it triggered
        self.rec = _DEFAULT_REC if recorder is None else recorder
        if (
            recorder is not None
            and fault_plan is not None
            and getattr(fault_plan, "recorder", None) is None
        ):
            fault_plan.recorder = self.rec
        self.plans = tuple(plans)
        if devices is None:
            resolve_device(None)  # raises without a card
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("ShardedStreamScanner needs at least one device")
        self.k = k
        self.fused = fused
        self.use_kernel = use_kernel
        self._protos: dict = {}
        self._lock = threading.Lock()
        # the first device's prototype resolves "auto" once; every other
        # device and shard reuses the int
        self.chunk_bytes = chunk_bytes
        template = self._proto(self.devices[0])
        self.chunk_bytes = template.chunk_bytes
        self.overlap = template.overlap
        self.max_m = template.max_m
        self.n_patterns = template.n_patterns
        self.order = template.order
        _, world = compat.rank_and_world()
        self.n_shards = int(n_shards) if n_shards else len(self.devices) * world
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.max_retries = int(max_retries)
        self.steal = bool(steal)
        self.steal_workers = steal_workers
        self.min_steal_bytes = (
            max(self.chunk_bytes, 2 * self.overlap)
            if min_steal_bytes is None
            else int(min_steal_bytes)
        )
        self.straggler_factor = float(straggler_factor)
        self.on_exhausted = on_exhausted
        self.is_retryable = is_retryable
        self.backoff = backoff
        self.fault_plan = fault_plan
        self.events: List[ShardRetry] = []
        self.steal_events: List[StealEvent] = []
        self.dispatch_count = 0

    # -- shard plumbing -----------------------------------------------------

    def shard_spec(self, total_bytes: int) -> StreamShardSpec:
        return make_stream_shard_spec(
            total_bytes, self.n_shards, overlap=self.overlap, align=EPSMC_BETA
        )

    def _proto(self, device: torch.device) -> StreamScanner:
        """The prototype scanner of ``device``: its plans, megascan spec and
        tables, built once; shards and lanes scan with its replicas."""
        with self._lock:
            got = self._protos.get(device)
            if got is None:
                got = self._protos[device] = StreamScanner(
                    self.plans, self.chunk_bytes, k=self.k,
                    fused=self.fused, use_kernel=self.use_kernel,
                    device=device, recorder=self.rec,
                )
            return got

    def _scanner_on(self, device, lane: Optional[str] = None) -> StreamScanner:
        return self._proto(device).replica(lane=lane)

    def _scanner(self, shard_i: int) -> StreamScanner:
        return self._scanner_on(
            self.devices[shard_i % len(self.devices)], lane=f"shard{shard_i}"
        )

    def _retryable(self, exc: BaseException) -> bool:
        """The retry classifier: the caller's (default: the reference's),
        except that a device error is never retried."""
        if _device_error(exc):
            return False
        classify = default_is_retryable if self.is_retryable is None else self.is_retryable
        return classify(exc)

    def _my_shards(self, n_shards: int) -> range:
        rank, world = compat.rank_and_world()
        return range(rank, n_shards, world)
    def _scan_shard(self, source, spec: StreamShardSpec, i: int, consume):
        """Run ``consume(scanner, range_source, prefix, start)`` for shard i
        with re-open-and-rescan retry; returns consume's result."""
        s, e = spec.ranges[i]
        lane = f"shard{i}"

        def attempt():
            with self.rec.span(
                "scan_range", lane=lane, shard=i, start=s, stop=e
            ):
                if self.fault_plan is not None:
                    self.fault_plan.check("shard", i)
                prefix = None
                if s > 0:
                    ps, pe = spec.prefix_range(i)
                    prefix = read_range(source, ps, pe)
                    if len(prefix) != pe - ps:
                        raise ShortRangeRead(
                            f"shard {i}: overlap prefix delivered "
                            f"{len(prefix)} bytes, expected {pe - ps}"
                        )
                sc = self._scanner(i)
                rs = _exact_chunks(open_range(source, s, e), e - s, i)
                out = consume(sc, rs, prefix, s)
            return sc, out

        def on_failure(attempt_i, exc):
            self.events.append(
                ShardRetry(shard=i, attempt=attempt_i, error=repr(exc))
            )

        sc, out = run_with_retries(
            attempt, retries=self.max_retries, on_failure=on_failure,
            is_retryable=self._retryable, backoff=self.backoff,
            recorder=self.rec, label=lane,
        )
        self.rec.event("range_done", lane=lane, origin=i, start=s, stop=e)
        self.dispatch_count += sc.dispatch_count
        return out

    # -- the elastic work-stealing path (DESIGN.md §12) ---------------------

    def _elastic_run(self, source, spec: StreamShardSpec, consume):
        """Scan this process's shard ranges on a thread-lane pool with work
        stealing; returns ``(results, missing)``.

        Stealing stays WITHIN a process (a stolen range would otherwise
        need a cross-process result channel; the inter-process partition is
        static).  Every lane pins a device; a lane's scans enqueue on that
        device, so lanes drain concurrently exactly like the round-robin
        static path.  ``results`` is an unordered list of per-item consume
        outputs, ``missing`` the byte ranges whose retries exhausted
        (``on_exhausted="partial"``; in raise mode the first error re-raises
        after the pool drains)."""
        lock = threading.Lock()
        work: deque = deque(
            _WorkItem(s, e, i)
            for i in self._my_shards(spec.n_shards)
            for (s, e) in (spec.ranges[i],)
            if e > s
        )
        results: list = []
        missing: List[Tuple[int, int]] = []
        errors: list = []
        active: dict = {}  # lane -> (_StealableScan, _WorkItem)
        n_lanes = (
            int(self.steal_workers)
            if self.steal_workers
            else max(2, len(self.devices))
        )
        n_lanes = max(1, min(n_lanes, len(work))) if work else 0
        lane_devices = [self.devices[j % len(self.devices)] for j in range(n_lanes)]
        # one scanner a lane, reused by its items and retries, built here
        # so the threads find every device's plans, spec and tables ready
        lane_scanners = [
            self._scanner_on(d, lane=f"lane{j}") for j, d in enumerate(lane_devices)
        ]

        def push_shed(item: _WorkItem, shed, thief, reason):
            with lock:
                self.steal_events.append(
                    StealEvent(item.origin, thief, shed[0], shed[1], reason)
                )
                if thief is None:
                    work.append(_WorkItem(shed[0], shed[1], item.origin))
            self.rec.event(
                "steal" if thief is not None else "shed",
                victim=item.origin, thief=thief,
                start=shed[0], stop=shed[1], reason=reason,
            )

        def timed_chunks(scan: _StealableScan, item: _WorkItem, lane_name: str):
            # host-step watchdog: a straggling step sheds the trailing range
            wd = StepWatchdog(
                factor=self.straggler_factor, policy="log", min_history=3
            )
            it = scan.chunks()
            step = 0
            while True:
                wd.start_step(step)
                try:
                    piece = next(it)
                except StopIteration:
                    wd.end_step()
                    return
                if wd.end_step() is not None:
                    ev = wd.events[-1]
                    self.rec.event(
                        "straggler", lane=lane_name, origin=item.origin,
                        step=ev.step, duration_s=round(ev.duration_s, 6),
                        median_s=round(ev.median_s, 6),
                        factor=round(ev.factor, 2),
                    )
                    shed = scan.try_shed(self.min_steal_bytes)
                    if shed is not None:
                        push_shed(item, shed, None, "straggler")
                yield piece
                step += 1

        def scan_one(lane: int, item: _WorkItem):
            lane_name = f"lane{lane}"
            sc = lane_scanners[lane]

            def attempt():
                with self.rec.span(
                    "scan_range", lane=lane_name, origin=item.origin,
                    start=item.start, stop=item.stop,
                ) as sp:
                    if self.fault_plan is not None:
                        self.fault_plan.check("shard", item.origin)
                    prefix = None
                    if item.start > 0:
                        ps = max(0, item.start - self.overlap)
                        prefix = read_range(source, ps, item.start)
                        if len(prefix) != item.start - ps:
                            raise ShortRangeRead(
                                f"range [{item.start}, {item.stop}): overlap "
                                f"prefix delivered {len(prefix)} bytes, "
                                f"expected {item.start - ps}"
                            )
                    scan = _StealableScan(
                        source, item.start, item.stop,
                        align=spec.align, piece_bytes=self.chunk_bytes,
                    )
                    dispatched = sc.dispatch_count
                    with lock:
                        active[lane] = (scan, item)
                    try:
                        out = consume(
                            sc, timed_chunks(scan, item, lane_name),
                            prefix, item.start,
                        )
                    finally:
                        with lock:
                            active.pop(lane, None)
                        # sheds survive into retries (rescan only what's left)
                        # and into the missing range on exhaustion
                        item.stop = scan.retire()
                        sp.set(stop=item.stop)  # the post-shed truth
                return sc.dispatch_count - dispatched, out

            def on_failure(attempt_i, exc):
                with lock:
                    self.events.append(
                        ShardRetry(
                            shard=item.origin, attempt=attempt_i, error=repr(exc)
                        )
                    )

            dispatched, out = run_with_retries(
                attempt, retries=self.max_retries, on_failure=on_failure,
                is_retryable=self._retryable, backoff=self.backoff,
                recorder=self.rec, label=f"shard{item.origin}",
            )
            self.rec.event(
                "range_done", lane=lane_name, origin=item.origin,
                start=item.start, stop=item.stop,
            )
            with lock:
                self.dispatch_count += dispatched
            return out

        def try_idle_steal(lane: int) -> Optional[_WorkItem]:
            with lock:
                cands = sorted(
                    active.values(), key=lambda p: -p[0].remaining()
                )
            for scan, item in cands:
                shed = scan.try_shed(self.min_steal_bytes)
                if shed is not None:
                    push_shed(item, shed, lane, "idle")
                    return _WorkItem(shed[0], shed[1], item.origin)
            return None

        def worker(lane: int, device: torch.device):
            try:
                if device.type == "cuda":
                    torch.cuda.set_device(device)  # the current card is per thread
                drain(lane)
            except BaseException as exc:  # a dead lane must fail the scan, never shorten it
                with lock:
                    errors.append(exc)

        def drain(lane: int):
            while True:
                with lock:
                    item = work.popleft() if work else None
                if item is None:
                    item = try_idle_steal(lane)
                if item is None:
                    return
                try:
                    out = scan_one(lane, item)
                    with lock:
                        results.append(out)
                except Exception as exc:  # noqa: BLE001 - classified upstream
                    partial = self.on_exhausted == "partial" and not _device_error(exc)
                    with lock:
                        if partial:
                            missing.append((item.start, item.stop))
                        else:
                            errors.append(exc)
                    if partial:
                        self.rec.event(
                            "range_lost", lane=f"lane{lane}",
                            origin=item.origin, start=item.start,
                            stop=item.stop, error=repr(exc),
                        )
                    else:
                        return

        threads = [
            threading.Thread(
                target=worker, args=(j, lane_devices[j]),
                name=f"lane{j}", daemon=True,
            )
            for j in range(n_lanes)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results, missing

    def _partial_result(
        self, spec: StreamShardSpec, missing, *, counts=None, positions=None
    ) -> PartialScanResult:
        """Merge local missing ranges across processes and pair them with
        their complement — the covered ranges the results are exact over."""
        flat = np.asarray(
            [b for r in missing for b in r], np.int64
        ).reshape(-1)
        if compat.rank_and_world()[1] > 1:
            flat = np.concatenate(compat.process_allgather_ragged(flat))
        miss = merge_ranges(zip(flat[0::2].tolist(), flat[1::2].tolist()))
        return PartialScanResult(
            total_bytes=spec.total_bytes,
            covered=complement_ranges(miss, spec.total_bytes),
            missing=miss,
            counts=counts,
            positions=positions,
        )

    # -- queries ------------------------------------------------------------

    def count_many(self, source, *, total_bytes: Optional[int] = None):
        """int32 (P_total,) exact occurrence counts over the whole logical
        stream: per-shard device accumulators, one cross-device reduce, one
        cross-process psum.  Nothing syncs until the merge, so every local
        shard's chunks are in flight together.

        With ``on_exhausted="partial"`` returns a :class:`PartialScanResult`
        instead (counts exact over its covered ranges)."""
        source = _normalize_source(source)
        spec = self.shard_spec(source_total_bytes(source, total_bytes))

        def consume(sc, rs, pre, st):
            return sc.count_device(rs, prefix=pre, start=st)

        missing: List[Tuple[int, int]] = []
        if self.steal:
            parts, missing = self._elastic_run(source, spec, consume)
        else:
            parts = []
            for i in self._my_shards(spec.n_shards):
                try:
                    parts.append(self._scan_shard(source, spec, i, consume))
                except Exception as exc:
                    if self.on_exhausted != "partial" or _device_error(exc):
                        raise
                    missing.append(spec.ranges[i])
        if parts:
            local = compat.sum_across_devices(parts)
        else:  # more processes than shards: contribute zeros to the psum
            local = np.zeros((self.n_patterns,), np.int32)
        counts = compat.process_allsum(local).astype(np.int32)
        if self.on_exhausted == "partial":
            return self._partial_result(spec, missing, counts=counts)
        return counts

    def any_many(self, source, *, total_bytes: Optional[int] = None) -> np.ndarray:
        """bool (P_total,) — does each pattern occur anywhere in the stream?"""
        got = self.count_many(source, total_bytes=total_bytes)
        if isinstance(got, PartialScanResult):
            got = got.counts
        return got > 0

    def positions_many(
        self, source, *, total_bytes: Optional[int] = None
    ):
        """Per-pattern sorted global occurrence start positions.

        Each shard's masks already carry global bases, so the static-path
        merge is a concat in shard order — start ranges are disjoint across
        shards (an occurrence belongs to the shard holding its END byte, and
        ends are partitioned), hence the result is sorted without a global
        sort.  The stealing path completes ranges in arbitrary order, so it
        sorts after the concat — same multiset, same final rows.  Across
        processes, rows are exchanged via the ragged all-gather.

        With ``on_exhausted="partial"`` returns a :class:`PartialScanResult`
        (positions exact over its covered ranges)."""
        source = _normalize_source(source)
        spec = self.shard_spec(source_total_bytes(source, total_bytes))
        rows: List[List[np.ndarray]] = [[] for _ in range(self.n_patterns)]

        def consume(sc, rs, pre, st):
            return sc.positions_many(rs, prefix=pre, start=st)

        missing: List[Tuple[int, int]] = []
        if self.steal:
            outs, missing = self._elastic_run(source, spec, consume)
            for got in outs:
                for p_i in range(self.n_patterns):
                    rows[p_i].append(got[p_i])
            local = [
                np.sort(np.concatenate(r)) if r else np.zeros(0, np.int64)
                for r in rows
            ]
        else:
            for i in self._my_shards(spec.n_shards):
                try:
                    got = self._scan_shard(source, spec, i, consume)
                except Exception as exc:
                    if self.on_exhausted != "partial" or _device_error(exc):
                        raise
                    missing.append(spec.ranges[i])
                    continue
                for p_i in range(self.n_patterns):
                    rows[p_i].append(got[p_i])
            local = [
                np.concatenate(r) if r else np.zeros(0, np.int64) for r in rows
            ]
        if compat.rank_and_world()[1] > 1:
            local = [
                np.sort(np.concatenate(compat.process_allgather_ragged(row)))
                for row in local
            ]
        if self.on_exhausted == "partial":
            return self._partial_result(spec, missing, positions=local)
        return local


def shard_stream_count(
    source,
    patterns: Sequence,
    *,
    n_shards: Optional[int] = None,
    k: int = 0,
    chunk_bytes="auto",
    total_bytes: Optional[int] = None,
    steal: bool = False,
    devices=None,
) -> np.ndarray:
    """int32 (P,) exact (or <= k-mismatch) sharded counts in ORIGINAL
    pattern order — the sharded sibling of :func:`stream.stream_count`.
    The shards run on ``devices`` (None: every local card)."""
    plans = engine.compile_patterns_cached(
        list(patterns), k=k, device=None if devices is None else devices[0]
    )
    sc = ShardedStreamScanner(
        plans, n_shards, chunk_bytes, k=k, steal=steal, devices=devices
    )
    counts = sc.count_many(source, total_bytes=total_bytes)
    out = np.zeros_like(counts)
    out[sc.order] = counts
    return out
