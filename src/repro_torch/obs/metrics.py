"""Counters, gauges, and histograms with a deterministic summary
(DESIGN.md §13).

The PyTorch port's copy of ``repro.obs.metrics``, unchanged.

The scan fabric's quantities of interest are small and enumerable —
retries, steals, seam corrections, faults injected, bytes scanned,
dispatches, GB/s, per-span latency distributions — so this is a
deliberately tiny registry, not a metrics framework:

  * ``count(name, n)``   — monotonic counters (retries, dispatches, bytes);
  * ``gauge(name, v)``   — last-write-wins values (chunk_bytes, GB/s);
  * ``observe(name, v)`` — histograms: running count/sum/min/max plus a
    bounded sample buffer (first ``MAX_SAMPLES`` observations) from which
    p50/p99 are computed, so summaries of million-event runs stay O(1)
    memory while short runs (every test, every bench) keep exact samples.

``summary()`` is sorted-key JSON-clean nested dicts and ``report()`` a
sorted fixed-format text block — deterministic given the same recorded
values, so tests and CI can assert on them and two renders of one run can
never disagree.  Thread-safe: every mutation takes the registry lock
(these are per-chunk/per-event rates, not per-byte — contention is noise).
"""

from __future__ import annotations

import threading
from typing import Dict, List


class Metrics:
    MAX_SAMPLES = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        # name -> [count, total, min, max, samples]
        self._hists: Dict[str, list] = {}

    def count(self, name: str, n=1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value) -> None:
        value = float(value)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = [0, 0.0, value, value, []]
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)
            if len(h[4]) < self.MAX_SAMPLES:
                h[4].append(value)

    # -- rendering ----------------------------------------------------------

    @staticmethod
    def _pct(samples: List[float], q: float) -> float:
        s = sorted(samples)
        return s[min(len(s) - 1, int(q * len(s)))]

    def summary(self) -> dict:
        """Nested dict, keys sorted, values plain Python numbers."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: (h[0], h[1], h[2], h[3], list(h[4]))
                     for k, h in self._hists.items()}
        out = {
            "counters": {k: counters[k] for k in sorted(counters)},
            "gauges": {k: gauges[k] for k in sorted(gauges)},
            "histograms": {},
        }
        for name in sorted(hists):
            n, total, lo, hi, samples = hists[name]
            out["histograms"][name] = {
                "count": n,
                "sum": total,
                "min": lo,
                "max": hi,
                "mean": total / n if n else 0.0,
                "p50": self._pct(samples, 0.50) if samples else 0.0,
                "p99": self._pct(samples, 0.99) if samples else 0.0,
            }
        return out

    def report(self) -> str:
        """Fixed-format text block of the summary (one metric per line)."""
        s = self.summary()
        lines = []
        for k, v in s["counters"].items():
            lines.append(f"counter  {k} = {v}")
        for k, v in s["gauges"].items():
            lines.append(f"gauge    {k} = {v}")
        for k, h in s["histograms"].items():
            lines.append(
                f"hist     {k}: n={h['count']} sum={h['sum']:.6g} "
                f"p50={h['p50']:.6g} p99={h['p99']:.6g} max={h['max']:.6g}"
            )
        return "\n".join(lines)
