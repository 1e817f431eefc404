"""The flight recorder: one handle for spans, instant events, and metrics,
threaded through the streaming/sharded engine (DESIGN.md §13).

The PyTorch port's copy of ``repro.obs.recorder``.  The port threads it
through ``repro_torch.core.engine`` so far; the streaming and sharded layers
named below are still to be ported.

Every layer that used to log or silently recover now reports to a
:class:`Recorder`: ``StreamScanner`` (per-chunk host_prep / device_put /
dispatch spans), ``ShardedStreamScanner`` (per-lane scan_range spans,
steal/shed/range_done events with exact byte ranges, straggler flags),
``RemoteRangeReader`` (per-part waits, timeouts, backoff retries),
``run_with_retries`` (retry/exhausted events), ``FaultPlan`` (injected
faults), and ``StopScanner`` (per-step stop-scan spans).  Tests and CI
assert on the structured events; humans open the Perfetto export.

The contract that keeps this affordable:

  * **The default is off and stays off the hot path.**  ``enabled=False``
    makes ``span()`` return the shared :data:`~repro_torch.obs.trace.NULL_SPAN`
    and every metric call return immediately — no buffers written, no
    syncs, no fencing.  The engine calls the recorder unconditionally
    (no ``if tracing:`` forks in scan code); what that costs the port on
    the card is not measured yet.

  * **Instant events still reach the sinks when disabled.**  Sinks are
    ``fn(name, args)`` callables; :func:`logging_sink` formats one log
    line per event.  Modules hand their disabled default recorder a
    logging sink, so the pre-recorder log lines (auto-chunk probe,
    straggler flags, kernel fallback) keep appearing with no recorder
    attached — the log file is just another sink of the event stream.

  * **Enabled tracing fences.**  ``span.fence(value)`` blocks until
    ``value`` is device-ready inside the span (see ``trace.py``), so
    dispatch spans measure device time, not submission time.  Fencing
    serializes the double-buffered pipeline; that is the honest cost of
    attribution and exactly why it never happens when disabled.  Pass
    ``fence=False`` to trace submission-side timing with pipelining
    intact.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Dict, List, Optional

from repro_torch.obs.metrics import Metrics
from repro_torch.obs.trace import (
    NULL_SPAN,
    NullSpan,
    Span,
    TraceBuffer,
    _PH_INSTANT,
    _PH_SPAN,
    _now,
    to_chrome,
    write_chrome,
)

Sink = Callable[[str, dict], None]


def logging_sink(logger: logging.Logger, level: int = logging.INFO) -> Sink:
    """A sink that renders each instant event as one log line:
    ``name k1=v1 k2=v2`` with keys sorted (deterministic)."""

    def sink(name: str, args: dict) -> None:
        if logger.isEnabledFor(level):
            kv = " ".join(f"{k}={args[k]}" for k in sorted(args))
            logger.log(level, "%s %s", name, kv)

    return sink


class Recorder:
    """Spans + events + metrics behind one handle (see module docstring;
    DESIGN.md §13 is the design, benchmarks/validate_trace.py the export
    contract the serving plane's dispatch lane also honors).

    ``span(name, lane=..., **args)`` returns a context manager timing a
    nested region on that lane; ``event(name, lane=..., **args)`` records
    an instant structured event (and feeds every sink, enabled or not);
    ``count``/``gauge``/``observe`` update the metrics registry.  The
    queries — ``events_named``, ``span_totals_ms``, ``summary``,
    ``report``, ``trace_json``, ``export_trace`` — serve tests, benches,
    and CI artifacts.
    """

    def __init__(
        self,
        *,
        enabled: bool = True,
        fence: bool = True,
        pid: int = 0,
        sinks: tuple = (),
    ):
        self.enabled = bool(enabled)
        self.fence_dispatches = bool(fence)
        self.pid = int(pid)
        self.sinks: List[Sink] = list(sinks)
        self.trace = TraceBuffer()
        self.metrics = Metrics()

    def add_sink(self, sink: Sink) -> "Recorder":
        self.sinks.append(sink)
        return self

    # -- recording ----------------------------------------------------------

    def span(self, name: str, *, lane: Optional[str] = None, **args):
        if not self.enabled:
            return NULL_SPAN
        return Span(
            name, args, self.trace.lane(lane), self.metrics,
            self.fence_dispatches,
        )

    def event(self, name: str, *, lane: Optional[str] = None, **args) -> None:
        for sink in self.sinks:
            sink(name, args)
        if not self.enabled:
            return
        buf = self.trace.lane(lane)
        buf.append((_PH_INSTANT, name, _now(), 0.0, args))
        self.metrics.count("event/" + name)

    def count(self, name: str, n=1) -> None:
        if self.enabled:
            self.metrics.count(name, n)

    def gauge(self, name: str, value) -> None:
        if self.enabled:
            self.metrics.gauge(name, value)

    def observe(self, name: str, value) -> None:
        if self.enabled:
            self.metrics.observe(name, value)

    # -- queries ------------------------------------------------------------

    def events_named(self, name: str) -> List[dict]:
        """Structured args of every instant event called ``name``, each
        augmented with its ``lane`` and ``ts``, in timestamp order."""
        out = []
        for lane, rows in self.trace.snapshot().items():
            for ph, ev_name, ts, _dur, args in rows:
                if ph == _PH_INSTANT and ev_name == name:
                    out.append({**args, "lane": lane, "ts": ts})
        out.sort(key=lambda e: e["ts"])
        return out

    def span_totals_ms(self) -> Dict[str, float]:
        """Total recorded duration per span name (ms), summed over lanes —
        the host-prep vs device_put vs dispatch breakdown benches emit."""
        totals: Dict[str, float] = {}
        for rows in self.trace.snapshot().values():
            for ph, name, _ts, dur, _args in rows:
                if ph == _PH_SPAN:
                    totals[name] = totals.get(name, 0.0) + dur * 1e3
        return {k: totals[k] for k in sorted(totals)}

    def trace_json(self) -> dict:
        return to_chrome(self.trace, pid=self.pid)

    def export_trace(self, path) -> Path:
        """Write the Chrome/Perfetto trace_event JSON artifact."""
        return write_chrome(self.trace, path, pid=self.pid)

    def summary(self) -> dict:
        """Deterministically ordered run summary: metrics + per-name event
        counts + per-name span totals."""
        event_counts: Dict[str, int] = {}
        span_counts: Dict[str, int] = {}
        for rows in self.trace.snapshot().values():
            for ph, name, _ts, _dur, _args in rows:
                if ph == _PH_INSTANT:
                    event_counts[name] = event_counts.get(name, 0) + 1
                elif ph == _PH_SPAN:
                    span_counts[name] = span_counts.get(name, 0) + 1
        totals = self.span_totals_ms()
        return {
            "metrics": self.metrics.summary(),
            "events": {k: event_counts[k] for k in sorted(event_counts)},
            "spans": {
                k: {"count": span_counts[k], "total_ms": totals.get(k, 0.0)}
                for k in sorted(span_counts)
            },
        }

    def report(self) -> str:
        """Human-readable summary block (stable ordering)."""
        s = self.summary()
        lines = ["== scan telemetry =="]
        for name, info in s["spans"].items():
            lines.append(
                f"span     {name}: n={info['count']} "
                f"total={info['total_ms']:.1f}ms"
            )
        for name, n in s["events"].items():
            lines.append(f"event    {name}: n={n}")
        body = self.metrics.report()
        if body:
            lines.append(body)
        return "\n".join(lines)

    def summary_json(self) -> str:
        return json.dumps(self.summary(), indent=1, sort_keys=True)


# The process-wide disabled recorder: what every instrumented layer falls
# back to when no recorder is passed.  No sinks, no buffers touched — the
# shape bench_obs's "none" column measures.
NULL = Recorder(enabled=False, fence=False)
