"""Reference remote range reader for sharded streaming scans (DESIGN.md §12),
in the PyTorch port: the copy of ``repro.core.remote_source``, which imports
no JAX either.

``ShardedStreamScanner`` already accepts any callable ``(start, stop) ->
chunk iterator`` as a source; this module is the reference implementation of
that protocol over an S3/GCS-style "GET with a Range header" backend:

  * **parts** — a shard's byte range is fetched in ``part_bytes`` pieces
    (one object-store GET each), so a multi-GB shard never materializes a
    single giant response and a failed part retries alone;
  * **bounded prefetch** — up to ``prefetch`` parts are in flight ahead of
    the consumer on a small thread pool, hiding request latency behind the
    scan exactly like the host->device double buffer hides the copy; the
    bound keeps host memory at O(prefetch * part_bytes);
  * **per-part timeout** — a part that hasn't answered within ``timeout_s``
    is abandoned and counted as a retryable failure (the in-flight call is
    left to finish on its worker thread — the reference semantics of a soft
    deadline);
  * **retry with jittered exponential backoff, classified by error type** —
    transient I/O errors and timeouts are retried up to ``retries`` times
    per part with ``BackoffPolicy`` delays; programming errors and
    :class:`~repro_torch.dist.fault_tolerance.FatalScanError` (auth failure,
    object gone) re-raise immediately via the same
    :func:`~repro_torch.dist.fault_tolerance.default_is_retryable` classifier the
    shard-level retry loop uses.  A part answering the WRONG number of
    bytes is a retryable short read — never silently delivered.

The reader carries ``total_bytes``, so ``source_total_bytes`` (and hence
range partitioning) works without an extra argument, and every ``(start,
stop)`` call returns an independent iterator — re-openable, as shard retry
requires.

:class:`FakeObjectStore` is the in-process test double: a byte blob behind
a ``get_range`` RPC with optional injected faults (a ``FaultPlan`` from
``repro_torch.dist.fault_injection``) and simulated latency, plus request
counters the tests assert on.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.dist.fault_tolerance import (
    BackoffPolicy,
    default_is_retryable,
)
from repro_torch.obs.recorder import NULL as _NULL_REC

DEFAULT_PART_BYTES = 1 << 20


class RangeReadTimeout(IOError):
    """A part fetch exceeded the reader's per-range timeout.  An IOError:
    timeouts are the canonical retryable failure."""


@dataclasses.dataclass
class RemoteReadStats:
    """Counters a scan can assert on / a dashboard can scrape."""

    gets: int = 0          # part fetches issued (including retries)
    parts: int = 0         # parts delivered to the consumer
    bytes: int = 0         # payload bytes delivered
    retries: int = 0       # failed attempts that were retried
    timeouts: int = 0      # attempts abandoned at the deadline


class RemoteRangeReader:
    """Callable ``(start, stop) -> iterator of uint8 arrays`` over a
    ``fetch(start, stop) -> bytes`` backend (one object-store GET per call).

    ``fetch`` must be thread-safe: prefetched parts are issued from a small
    worker pool.  ``sleep`` and the ``backoff`` policy's seed are injectable
    so tests can assert the exact backoff schedule without waiting it out.
    """

    def __init__(
        self,
        fetch: Callable[[int, int], bytes],
        total_bytes: Optional[int] = None,
        *,
        part_bytes: int = DEFAULT_PART_BYTES,
        prefetch: int = 2,
        timeout_s: Optional[float] = 30.0,
        retries: int = 4,
        backoff: Optional[BackoffPolicy] = None,
        is_retryable=None,
        sleep=time.sleep,
        recorder=None,
    ):
        if part_bytes < 1:
            raise ValueError("part_bytes must be >= 1")
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1 (1 = no look-ahead)")
        if retries < 0:
            raise ValueError("retries must be >= 0")
        if total_bytes is None:
            total_bytes = getattr(fetch, "total_bytes", None)
        if total_bytes is None:
            raise ValueError(
                "RemoteRangeReader needs total_bytes (pass it, or give the "
                "fetch backend a total_bytes attribute)"
            )
        self.fetch = fetch
        self.total_bytes = int(total_bytes)
        self.part_bytes = int(part_bytes)
        self.prefetch = int(prefetch)
        self.timeout_s = timeout_s
        self.retries = int(retries)
        self.backoff = BackoffPolicy() if backoff is None else backoff
        self.is_retryable = (
            default_is_retryable if is_retryable is None else is_retryable
        )
        self.sleep = sleep
        self.stats = RemoteReadStats()
        # flight recorder (repro_torch.obs): part waits become spans on the
        # consuming lane, timeouts/retries become structured events next to
        # the stats counters.  Defaults to the shared disabled recorder.
        self.rec = _NULL_REC if recorder is None else recorder
        self._lock = threading.Lock()

    # -- per-part fetch with timeout + classified backoff retry -------------

    def _resolve(self, ex: ThreadPoolExecutor, fut, s: int, e: int) -> bytes:
        """Resolve one part: attempt 0 consumes the prefetched future, each
        retry submits a fresh fetch after the classified backoff delay."""
        for attempt in range(self.retries + 1):
            if fut is None:
                with self._lock:
                    self.stats.gets += 1
                fut = ex.submit(self.fetch, s, e)
            try:
                data = fut.result(timeout=self.timeout_s)
                if len(data) != e - s:
                    # short/overlong response: retryable, never delivered
                    raise IOError(
                        f"part [{s}, {e}) returned {len(data)} bytes, "
                        f"expected {e - s}"
                    )
                return data
            except Exception as exc:  # noqa: BLE001 - classified below
                if isinstance(exc, FutureTimeoutError):
                    fut.cancel()  # queued attempts die; running ones are abandoned
                    with self._lock:
                        self.stats.timeouts += 1
                    exc = RangeReadTimeout(
                        f"part [{s}, {e}) exceeded timeout_s={self.timeout_s}"
                    )
                    self.rec.event(
                        "part_timeout", start=s, stop=e, attempt=attempt
                    )
                if attempt == self.retries or not self.is_retryable(exc):
                    raise exc
                with self._lock:
                    self.stats.retries += 1
                self.rec.event(
                    "part_retry", start=s, stop=e, attempt=attempt,
                    error=repr(exc),
                )
                self.rec.count("remote_part_retries")
                self.sleep(self.backoff.delay_s(attempt))
                fut = None
        raise AssertionError("unreachable")

    # -- the (start, stop) protocol ----------------------------------------

    def __call__(self, start: int, stop: int) -> Iterator[np.ndarray]:
        start, stop = int(start), int(stop)
        if not (0 <= start <= stop <= self.total_bytes):
            raise ValueError(
                f"bad range [{start}, {stop}) of {self.total_bytes} bytes"
            )
        parts: List[Tuple[int, int]] = [
            (s, min(s + self.part_bytes, stop))
            for s in range(start, stop, self.part_bytes)
        ]

        def gen():
            # pool sized past the prefetch bound so a retry after an
            # abandoned (still-running) timeout attempt can still schedule
            with ThreadPoolExecutor(max_workers=self.prefetch + 2) as ex:
                inflight: List[Tuple[Tuple[int, int], object]] = []
                nxt = 0
                while inflight or nxt < len(parts):
                    while nxt < len(parts) and len(inflight) < self.prefetch:
                        s, e = parts[nxt]
                        with self._lock:
                            self.stats.gets += 1
                        inflight.append(((s, e), ex.submit(self.fetch, s, e)))
                        nxt += 1
                    (s, e), fut = inflight.pop(0)
                    with self.rec.span(
                        "part_wait", start=s, stop=e
                    ) as sp:
                        data = self._resolve(ex, fut, s, e)
                        sp.set(bytes=len(data))
                    with self._lock:
                        self.stats.parts += 1
                        self.stats.bytes += len(data)
                    self.rec.count("remote_parts")
                    self.rec.count("remote_bytes", len(data))
                    yield np.frombuffer(data, np.uint8)

        return gen()


class FakeObjectStore:
    """In-process stand-in for a blob store: ``get_range(start, stop)``
    over a byte buffer, with optional simulated latency and injected faults
    (any object with the ``FaultPlan`` ``check``/``truncate`` shape — site
    kind ``"remote_get"``, key ``(start, stop)``).  Thread-safe; counts
    requests so tests can assert prefetch/retry behavior."""

    def __init__(self, data, *, plan=None, latency_s: float = 0.0, sleep=time.sleep):
        self.data = np.asarray(
            np.frombuffer(bytes(data), np.uint8)
            if isinstance(data, (bytes, bytearray, memoryview))
            else data,
            dtype=np.uint8,
        ).reshape(-1)
        self.plan = plan
        self.latency_s = latency_s
        self.sleep = sleep
        self.gets = 0
        self.bytes_served = 0
        self._lock = threading.Lock()

    @property
    def total_bytes(self) -> int:
        return len(self.data)

    def get_range(self, start: int, stop: int) -> bytes:
        with self._lock:
            self.gets += 1
        if self.latency_s:
            self.sleep(self.latency_s)
        if self.plan is not None:
            self.plan.check("remote_get", (start, stop))
        data = self.data[start:stop].tobytes()
        if self.plan is not None:
            keep = self.plan.truncate("remote_get", (start, stop), len(data))
            data = data[:keep]
        with self._lock:
            self.bytes_served += len(data)
        return data

    def reader(self, **kwargs) -> RemoteRangeReader:
        """A RemoteRangeReader over this store (its fetch is ``get_range``)."""
        return RemoteRangeReader(self.get_range, self.total_bytes, **kwargs)
