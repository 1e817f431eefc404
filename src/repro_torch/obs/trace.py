"""Trace spans, per-lane buffers, and Chrome/Perfetto export (DESIGN.md §13).

The PyTorch port's copy of ``repro.obs.trace``.  Only ``Span.fence``
differs: it waits for the card with ``torch.cuda.synchronize`` where the
reference calls ``jax.block_until_ready``.

The streaming/sharded engine is a pipeline of host work (source reads,
decompression, window assembly), transfers (``device_put``), and
asynchronously dispatched device compute — wall-clock alone cannot say
where a flat scaling curve comes from.  This module is the timing
substrate the :class:`~repro_torch.obs.recorder.Recorder` builds on:

  * :class:`Span` — a nestable timed region on one *lane*, recorded with
    the monotonic clock (``time.perf_counter``).  Spans are context
    managers; nesting needs no parent bookkeeping because the Chrome
    viewer nests complete events on one track by ``ts``/``dur``
    containment, which holds by construction (a child enters after and
    exits before its parent on the same lane).

  * **fencing** — CUDA launches are asynchronous: a call returns as soon
    as the work is enqueued, so a naive ``with span(): f(x)`` times the
    *submission*, hiding device time until some later sync.
    ``span.fence(value)`` synchronizes the card that holds ``value``
    INSIDE the span, so the recorded duration covers the device work.
    Fencing deliberately trades the engine's double-buffered pipelining
    for honest per-dispatch attribution — which is why it only happens
    under an *enabled* recorder (the no-op default never syncs, so the
    production pipeline shape is untouched).

  * :class:`TraceBuffer` — thread-safe per-lane event buffers.  A lane is
    one horizontal track in the trace (a Perfetto "thread"): explicit
    names for logical lanes (``shard3``, ``lane0``) so stolen ranges stay
    attributed to the lane that scanned them, the current thread's name
    otherwise.  Lane creation takes a lock once; appends are plain list
    appends.

  * :func:`to_chrome` — export as Chrome ``trace_event`` JSON
    (``{"traceEvents": [...]}``) loadable by ``chrome://tracing`` and
    https://ui.perfetto.dev.  Lanes become integer ``tid``s with
    ``thread_name`` metadata; timestamps are microseconds relative to the
    buffer's origin.  ``benchmarks/validate_trace.py`` is the stdlib-only
    schema gate CI runs over these exports.

Zero dependencies: ``torch`` is imported only inside ``fence`` on fenced
spans, so the module (and every no-op path) stays stdlib-only.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_now = time.perf_counter

# buffer rows: (ph, name, t_start, duration_s, args)
# ph is the Chrome phase: "X" complete span, "i" instant event
_PH_SPAN = "X"
_PH_INSTANT = "i"


class NullSpan:
    """The reusable do-nothing span a disabled recorder hands out: enter,
    exit, ``set``, and ``fence`` all no-op (``fence`` returns its argument
    WITHOUT syncing — the disabled path must never change the engine's
    async dispatch shape)."""

    __slots__ = ()

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "NullSpan":
        return self

    def fence(self, value):
        return value


NULL_SPAN = NullSpan()


class Span:
    """One timed region on one lane; appended to its buffer at exit.

    ``set(**attrs)`` attaches/updates args mid-span (e.g. the byte count
    known only after the window is assembled).  ``fence(value)`` blocks
    until ``value``'s device work is done — still inside the span — when
    the owning recorder fences, and is a pass-through otherwise.
    """

    __slots__ = ("name", "args", "t0", "_buf", "_metrics", "_fenced")

    def __init__(self, name: str, args: dict, buf: list, metrics, fenced: bool):
        self.name = name
        self.args = args
        self._buf = buf
        self._metrics = metrics
        self._fenced = fenced
        self.t0 = 0.0

    def __enter__(self) -> "Span":
        self.t0 = _now()
        return self

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def fence(self, value):
        if self._fenced and value is not None:
            for device in _cuda_devices(value):
                import torch  # lazy: the no-op paths never touch torch

                torch.cuda.synchronize(device)
        return value

    def __exit__(self, *exc) -> bool:
        dur = _now() - self.t0
        self._buf.append((_PH_SPAN, self.name, self.t0, dur, self.args))
        if self._metrics is not None:
            self._metrics.observe("span/" + self.name, dur)
        return False


def _cuda_devices(value) -> set:
    """The CUDA devices of every tensor in ``value`` (a tensor, or lists,
    tuples and dicts of them); empty on the CPU, so fencing there is free."""
    if isinstance(value, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in value))
    if isinstance(value, dict):
        return _cuda_devices(list(value.values()))
    if getattr(value, "is_cuda", False):
        return {value.device}
    return set()


class TraceBuffer:
    """Thread-safe per-lane event buffers with one shared time origin.

    ``lane(name)`` returns the append target for that lane, creating it
    under the lock on first use; lookups after that are lock-free dict
    reads and appends are GIL-atomic list appends, so concurrent scan
    lanes never contend on a global buffer lock.
    """

    def __init__(self):
        self.t_origin = _now()
        self._lanes: Dict[str, List] = {}
        self._lock = threading.Lock()

    def lane(self, name: Optional[str] = None) -> list:
        if name is None:
            name = threading.current_thread().name
        buf = self._lanes.get(name)
        if buf is None:
            with self._lock:
                buf = self._lanes.setdefault(name, [])
        return buf

    def snapshot(self) -> Dict[str, list]:
        """Point-in-time copy of every lane's rows (safe to iterate while
        scans keep appending)."""
        with self._lock:
            lanes = list(self._lanes.items())
        return {name: list(buf) for name, buf in lanes}


def _jsonable(v):
    """Coerce span/event args to JSON-clean values: numpy scalars to
    Python numbers, bytes to their repr, everything unknown to str."""
    if isinstance(v, bool) or v is None or isinstance(v, (str, int, float)):
        return v
    if hasattr(v, "item"):  # numpy scalar
        try:
            return v.item()
        except Exception:
            return str(v)
    if isinstance(v, (bytes, bytearray)):
        return repr(bytes(v))
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return str(v)


def to_chrome(buffers: TraceBuffer, *, pid: int = 0) -> dict:
    """Chrome ``trace_event`` JSON for the buffers' current contents.

    Lanes map to integer ``tid``s (named via ``thread_name`` metadata
    events) in sorted-lane order, so the export is deterministic for a
    given set of recorded rows.  Timestamps are µs since the buffer's
    origin; complete events carry ``dur``; instant events are
    thread-scoped (``"s": "t"``).
    """
    events: List[dict] = []
    lanes = buffers.snapshot()
    t0 = buffers.t_origin
    for tid, lane_name in enumerate(sorted(lanes)):
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": lane_name},
        })
        for ph, name, ts, dur, args in lanes[lane_name]:
            e = {
                "name": name,
                "cat": "scan",
                "ph": ph,
                "pid": pid,
                "tid": tid,
                "ts": round((ts - t0) * 1e6, 3),
                "args": {k: _jsonable(v) for k, v in args.items()},
            }
            if ph == _PH_SPAN:
                e["dur"] = round(dur * 1e6, 3)
            elif ph == _PH_INSTANT:
                e["s"] = "t"
            events.append(e)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome(buffers: TraceBuffer, path, *, pid: int = 0) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome(buffers, pid=pid), indent=1))
    return path
