"""repro_torch.obs — the scan telemetry plane (DESIGN.md §13).

The PyTorch port's copy of ``repro.obs``; ``Span.fence`` synchronizes the
card instead of calling ``jax.block_until_ready``.

Zero-dependency tracing + metrics + flight recorder for the
streaming/sharded engine:

  * :mod:`repro_torch.obs.trace`    — nestable spans, per-lane buffers,
    ``torch.cuda.synchronize`` fencing, Chrome/Perfetto trace_event export;
  * :mod:`repro_torch.obs.metrics`  — counters/gauges/histograms with a
    deterministic summary;
  * :mod:`repro_torch.obs.recorder` — the :class:`Recorder` protocol threaded
    through ``StreamScanner`` / ``ShardedStreamScanner`` /
    ``RemoteRangeReader`` / ``run_with_retries``, plus the process-wide
    disabled :data:`NULL` recorder and :func:`logging_sink`.
"""

from repro_torch.obs.metrics import Metrics
from repro_torch.obs.recorder import NULL, Recorder, logging_sink
from repro_torch.obs.trace import (
    NULL_SPAN,
    NullSpan,
    Span,
    TraceBuffer,
    to_chrome,
    write_chrome,
)

__all__ = [
    "Metrics",
    "NULL",
    "NULL_SPAN",
    "NullSpan",
    "Recorder",
    "Span",
    "TraceBuffer",
    "logging_sink",
    "to_chrome",
    "write_chrome",
]
