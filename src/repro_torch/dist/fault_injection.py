"""Deterministic fault-injection harness for the elastic scan fabric
(DESIGN.md §12), in the PyTorch port.

The port's copy of ``repro.dist.fault_injection``, which imports no JAX
either.  A plan's draws and fired events equal the reference's for equal
seeds and keys: every site in the port passes plain ``int`` / ``str`` keys,
since a numpy or torch scalar reprs differently and would change the
sha256 draw.

A :class:`FaultPlan` is a SEEDED, order-independent schedule of injected
faults — read errors, short (truncated) reads, latency spikes, and shard
crashes.  Every injection decision is a pure function of ``(seed, fault
type, operation key)`` via sha256, so the same plan produces the same
faults whether shards run sequentially, threaded, or across processes, and
a property test can sweep ``seed x shard count`` and compare every run
against the clean oracle bit-for-bit.

Faults are TRANSIENT by default: a faulty operation fails
``attempts_per_fault`` times, then heals (per-key counters make this
deterministic too), so the retry/steal machinery it exercises can actually
recover.  ``attempts_per_fault=None`` makes faults permanent — the
retry-exhaustion / :class:`~repro_torch.core.shard_stream.PartialScanResult`
path.

The plan threads through three layers:

  * **sources** — :class:`FaultyRangeSource` wraps any range-partitionable
    source behind the callable ``(start, stop)`` protocol and consults the
    plan at every open and every delivered piece; :class:`FaultyChunkSource`
    does the same for one-shot chunk iterators (e.g. the compressed frame
    feed of a :class:`~repro_torch.core.stream.Compressed` source);
  * **scanners** — ``ShardedStreamScanner(fault_plan=...)`` consults the
    plan at the top of every shard attempt (kind ``"shard"``), simulating a
    whole-shard crash inside the retry scope;
  * **retries** — injected errors are ordinary exceptions, so
    ``run_with_retries`` classifies and retries them exactly like real ones
    (:class:`InjectedReadError` is I/O-shaped and retryable; truncations
    surface as ``ShortRangeRead`` from the scanner's length audit).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.dist.fault_tolerance import InjectedFault


class InjectedReadError(IOError):
    """Injected transient I/O failure (an object-store 5xx / reset socket).
    An IOError, so the default retry classifier treats it as retryable."""


@dataclasses.dataclass
class FaultEvent:
    """One injected fault, for assertions: which knob fired where."""

    action: str  # "read_error" | "truncate" | "latency" | "crash"
    kind: str    # the operation site ("open", "read", "shard", "remote_get")
    key: object  # the operation's identity at that site


class FaultPlan:
    """Seeded deterministic fault schedule.

    ``*_rate`` knobs are per-operation probabilities in [0, 1]; each
    (action, kind, key) triple draws its own uniform from sha256, so rates
    compose independently and no draw depends on execution order.

    Sites consult the plan through two calls:

      * :meth:`check(kind, key)` — may sleep (latency spike), raise
        :class:`InjectedFault` (crash), or raise :class:`InjectedReadError`
        (read error);
      * :meth:`truncate(kind, key, n)` — how many of an n-byte piece to
        actually deliver (``n`` when no truncation fires; a deterministic
        fraction of ``n`` when one does).

    ``sleep`` is injectable so latency-spike tests need not actually wait.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        read_error_rate: float = 0.0,
        truncate_rate: float = 0.0,
        latency_rate: float = 0.0,
        latency_s: float = 0.02,
        crash_rate: float = 0.0,
        attempts_per_fault: Optional[int] = 1,
        sleep=time.sleep,
        recorder=None,
    ):
        for name, rate in (
            ("read_error_rate", read_error_rate),
            ("truncate_rate", truncate_rate),
            ("latency_rate", latency_rate),
            ("crash_rate", crash_rate),
        ):
            if not (0.0 <= rate <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        if attempts_per_fault is not None and attempts_per_fault < 1:
            raise ValueError("attempts_per_fault must be >= 1 or None")
        self.seed = int(seed)
        self.read_error_rate = read_error_rate
        self.truncate_rate = truncate_rate
        self.latency_rate = latency_rate
        self.latency_s = latency_s
        self.crash_rate = crash_rate
        self.attempts_per_fault = attempts_per_fault
        self.sleep = sleep
        # optional flight recorder (repro_torch.obs): every fired fault becomes a
        # structured "fault" event + faults_injected counter, so a chaos
        # trace shows each injection next to the retry it triggered
        self.recorder = recorder
        self.events: List[FaultEvent] = []
        self._counts: Dict[Tuple[str, str, object], int] = {}
        self._lock = threading.Lock()

    # -- the deterministic core --------------------------------------------

    def _u(self, action: str, kind: str, key) -> float:
        h = hashlib.sha256(
            repr((self.seed, action, kind, key)).encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64

    def _fires(self, action: str, kind: str, key, rate: float) -> bool:
        """Does this (action, site) inject a fault on THIS attempt?  The
        draw is order-independent; the per-key attempt counter makes the
        transient-then-heals behavior deterministic as well."""
        if rate <= 0.0 or self._u(action, kind, key) >= rate:
            return False
        with self._lock:
            n = self._counts.get((action, kind, key), 0) + 1
            self._counts[(action, kind, key)] = n
            if self.attempts_per_fault is not None and n > self.attempts_per_fault:
                return False  # healed: the fault burned its attempts
            self.events.append(FaultEvent(action, kind, key))
        if self.recorder is not None:  # outside the lock: sinks may log
            self.recorder.event(
                "fault", action=action, kind=kind, key=repr(key)
            )
            self.recorder.count("faults_injected")
        return True

    # -- the two site calls -------------------------------------------------

    def check(self, kind: str, key) -> None:
        """Consult the plan at an operation site (ordered: a latency spike
        may precede the failure that aborts the operation)."""
        if self._fires("latency", kind, key, self.latency_rate):
            self.sleep(self.latency_s)
        if self._fires("crash", kind, key, self.crash_rate):
            raise InjectedFault(f"injected crash at {kind} {key!r}")
        if self._fires("read_error", kind, key, self.read_error_rate):
            raise InjectedReadError(f"injected read error at {kind} {key!r}")

    def truncate(self, kind: str, key, n: int) -> int:
        if n > 0 and self._fires("truncate", kind, key, self.truncate_rate):
            # deterministic keep-fraction in [0, 1): a short, nonempty read
            return int(n * self._u("truncate_frac", kind, key))
        return n

    def counts_by_action(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for e in self.events:
                out[e.action] = out.get(e.action, 0) + 1
            return out


# faulty pieces are delivered at this granularity so mid-range faults can
# land between pieces of one large buffer slice, not only at range edges
_FAULT_PIECE_BYTES = 1 << 16


class FaultyRangeSource:
    """A range-partitionable source with plan faults injected at every open
    and every delivered piece — the callable ``(start, stop)`` protocol, so
    it drops into ``ShardedStreamScanner``/`open_range` unchanged.

    Opens consult site ``("open", (start, stop))``; pieces consult
    ``("read", (start, i))`` where ``i`` is the piece index within the open
    (piece granularity is fixed, so the key sequence is deterministic for a
    given range).  A truncation fault ends the delivery short — the
    scanner's per-shard length audit turns that into ``ShortRangeRead``."""

    def __init__(
        self,
        source,
        plan: FaultPlan,
        *,
        total_bytes: Optional[int] = None,
        piece_bytes: int = _FAULT_PIECE_BYTES,
    ):
        # imported here, not at module top: repro_torch.core.shard_stream imports
        # repro_torch.dist.* at module scope, so the reverse edge must stay lazy
        from repro_torch.core.shard_stream import source_total_bytes

        self.source = source
        self.plan = plan
        self.piece_bytes = int(piece_bytes)
        self.total_bytes = source_total_bytes(source, total_bytes)
        self.opens = 0

    def __call__(self, start: int, stop: int) -> Iterator[np.ndarray]:
        from repro_torch.core.shard_stream import open_range
        from repro_torch.core.stream import _as_chunks

        self.opens += 1
        self.plan.check("open", (start, stop))

        def gen():
            i = 0
            for piece in _as_chunks(open_range(self.source, start, stop)):
                for off in range(0, len(piece), self.piece_bytes):
                    sub = piece[off : off + self.piece_bytes]
                    self.plan.check("read", (start, i))
                    keep = self.plan.truncate("read", (start, i), len(sub))
                    i += 1
                    if keep < len(sub):
                        yield sub[:keep]
                        return  # a short read ends the stream, like EOF
                    yield sub

        return gen()


class FaultyChunkSource:
    """Plan faults over a one-shot iterator of byte pieces — for sources
    with no random access (compressed frame feeds, sockets).  Wrap the
    COMPRESSED pieces and hand the wrapper to :class:`Compressed`: a
    truncation here cuts a frame mid-member (the decompressor's truncated-
    stream error), a read error surfaces mid-stream."""

    def __init__(self, pieces, plan: FaultPlan, *, key: str = "stream"):
        self.pieces = pieces
        self.plan = plan
        self.key = key

    def __iter__(self):
        from repro_torch.core.stream import _as_chunks

        for i, piece in enumerate(_as_chunks(self.pieces)):
            self.plan.check("read", (self.key, i))
            keep = self.plan.truncate("read", (self.key, i), len(piece))
            if keep < len(piece):
                yield piece[:keep]
                return
            yield piece
