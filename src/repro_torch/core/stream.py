"""Streaming scan engine: bounded-memory single-pass matching over unbounded
texts, in PyTorch (DESIGN.md §9-§11).

The PyTorch twin of ``repro.core.stream``.  The resident engine
(core/engine.py) wants the whole corpus on the device; this module answers
the same count/any/positions queries EXACTLY over arbitrarily long inputs in
O(chunk) device memory:

  * :class:`StreamScanner` re-chunks any byte source (bytes, arrays,
    tensors, files, iterables of chunks, gzip/zstd :class:`Compressed`
    frames) into fixed-capacity windows, carries an ``overlap`` tail of
    ``max_m - 1`` bytes (rounded up to the EPSMc beta block so every window
    starts on a GLOBAL beta boundary — the block-phase carry) across
    windows, and runs ONE scan per chunk;

  * seam exactness is by END-position attribution: a window counts only the
    occurrences whose last byte falls in its newly-streamed region (the
    engine's ``end_min`` gate, or the megascan kernel's seam gate), so each
    occurrence is counted exactly once;

  * a ``prefix``/``start`` injection scans a mid-stream range of a larger
    logical stream, the range boundary being just a second-level seam.

Host/device overlap.  Windows are assembled into a small ring of host
buffers (pinned on the card) and copied with ``non_blocking=True``; a
buffer is refilled only once the CUDA event recorded behind its last copy
has completed, so window i+1 is read, decompressed and copied while window
i is scanned.  On the kernel path (the default on the card for an eligible
plan set) every chunk is one ``megascan`` launch that adds its counts into
one device int32 accumulator, read by the host only at the end; a set
megascan refuses takes one acscan counts launch a chunk over its whole
dictionary (approx launches for k-mismatch groups).  The fused
pure-PyTorch path syncs once or more per chunk: the engine compares
candidate counts with their budgets on the host (core/engine.py).

Approximate plans stream too: a <= k-mismatch occurrence spans the same m
bytes as an exact one, so the overlap/attribution argument is untouched.
"""

from __future__ import annotations

import copy
import logging
import time
from collections import deque
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.engine import PatternPlan
from repro_torch.core.epsm import EPSMC_BETA
from repro_torch.core.packing import as_u8_np, resolve_device
from repro_torch.obs.recorder import Recorder, logging_sink

_LOG = logging.getLogger("repro_torch.stream")

# The module's default flight recorder: disabled (no spans, no fencing) but
# with the module logger as an event sink, so the auto-chunk probe, kernel
# fallback and straggler events reach the log with no recorder attached.
_DEFAULT_REC = Recorder(enabled=False, fence=False, sinks=(logging_sink(_LOG),))

# Floor device window capacity (bytes) for adaptive sizing.
DEFAULT_CHUNK_BYTES = 1 << 22
# Adaptive sizing bounds: never below 1 MiB (seam overhead dominates), never
# above 128 MiB (diminishing amortization).
MIN_CHUNK_BYTES = 1 << 20
MAX_CHUNK_BYTES = 1 << 27
# read() granularity for file-like sources
_READ_BYTES = 1 << 20
# host window buffers per scanner: one being filled, one in flight, one spare
_RING = 3

_DISPATCH_OVERHEAD_S: dict = {}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dispatch_overhead_s(device) -> float:
    """One-time measured per-launch overhead on ``device`` (seconds): 32
    launches of a trivial op, then a synchronize.  Cached per device."""
    dev = torch.device(device)
    key = str(dev)
    if key not in _DISPATCH_OVERHEAD_S:
        x = torch.zeros((8,), dtype=torch.int32, device=dev)
        x = x + 1  # first launch outside the timed region
        _sync(dev)
        reps = 32
        t0 = time.perf_counter()
        for _ in range(reps):
            x = x + 1
        _sync(dev)
        _DISPATCH_OVERHEAD_S[key] = (time.perf_counter() - t0) / reps
    return _DISPATCH_OVERHEAD_S[key]


def auto_chunk_bytes(
    *,
    device=None,
    overhead_frac: float = 0.02,
    assumed_gbps: float = 1.0,
) -> int:
    """Adaptive chunk size: device memory budget + measured dispatch
    overhead (DESIGN.md §11).

      * overhead floor — the per-chunk fixed cost measured by the probe must
        be <= ``overhead_frac`` of the chunk's scan time at a conservative
        ``assumed_gbps`` streaming rate;
      * memory ceiling — the streaming working set is ~9.5 device bytes per
        streamed byte (StreamScanner.device_bytes_per_chunk), kept inside a
        quarter of the card's free memory (``torch.cuda.mem_get_info``, at
        least an eighth of the total), or a fixed 512 MiB budget on the CPU.

    The result is clamped to [MIN_CHUNK_BYTES, MAX_CHUNK_BYTES] and rounded
    to the EPSMc beta block.  ``device`` defaults to the card.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        budget = max(int(free), int(total) // 8) // 4
    else:
        budget = 512 << 20
    mem_cap = budget // 10  # ~9.5 working-set bytes per streamed byte
    floor = int(_dispatch_overhead_s(dev) / overhead_frac * assumed_gbps * 1e9)
    chunk = max(DEFAULT_CHUNK_BYTES, floor)
    chunk = max(MIN_CHUNK_BYTES, min(chunk, mem_cap, MAX_CHUNK_BYTES))
    return _round_up(chunk, EPSMC_BETA)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


class Compressed:
    """Marks a byte source as gzip/zstd frames to decompress on the fly.

    ``source`` may be compressed bytes, a binary file-like, or an iterator
    of frames (e.g. one gzip member / zstd frame per cold-storage object) —
    concatenated frames are legal in both formats and decode as one logical
    stream.  ``codec`` is "gzip", "zstd", or "auto" (sniff the first frame's
    magic).  zstd needs the `zstandard` package; its absence raises only
    when a zstd source is actually opened."""

    def __init__(self, source, codec: str = "auto"):
        if codec not in ("auto", "gzip", "zstd"):
            raise ValueError(f"unknown codec {codec!r}")
        self.source = source
        self.codec = codec


def _raw_pieces(source) -> Iterator[bytes]:
    """COMPRESSED byte pieces of a Compressed source's underlying stream."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        yield bytes(source)
        return
    if hasattr(source, "read"):
        while True:
            b = source.read(_READ_BYTES)
            if not b:
                return
            yield bytes(b)
        return
    for piece in source:
        if isinstance(piece, np.ndarray):
            piece = piece.tobytes()
        yield bytes(piece)


_GZIP_MAGIC = b"\x1f\x8b"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _chain_head(head: bytes, rest) -> Iterator[bytes]:
    if head:
        yield head
    yield from rest


def _new_decompressor(codec: str):
    if codec == "gzip":
        import zlib

        return zlib.decompressobj(wbits=16 + zlib.MAX_WBITS)
    try:
        import zstandard
    except ImportError as e:  # gated dep: only zstd sources need it
        raise RuntimeError(
            "zstd-compressed sources need the `zstandard` package "
            "(pip install zstandard), which is not installed"
        ) from e
    return zstandard.ZstdDecompressor().decompressobj()


def _decompressed_chunks(c: Compressed) -> Iterator[np.ndarray]:
    """Incremental multi-frame decompression: O(compressed piece + emitted
    chunk) host memory, frames restarted via each decompressor's
    eof/unused_data contract (zlib and zstandard expose the same one)."""
    codec = c.codec
    d = None
    pieces = _raw_pieces(c.source)
    head = b""
    if codec == "auto":
        # a read()/iterator may legally deliver < 4 bytes: buffer until the
        # longest magic is decidable before sniffing
        for piece in pieces:
            head += piece
            if len(head) >= len(_ZSTD_MAGIC):
                break
        codec = "zstd" if head[: len(_ZSTD_MAGIC)] == _ZSTD_MAGIC else "gzip"
    for data in _chain_head(head, pieces):
        while data:
            if d is None:
                d = _new_decompressor(codec)
            out = d.decompress(data)
            if out:
                yield np.frombuffer(out, np.uint8)
            if d.eof:  # frame boundary: restart on the leftover bytes
                data = d.unused_data
                d = None
            else:
                data = b""
    if d is not None and not d.eof:
        raise ValueError(f"truncated {codec} stream")


def _as_chunks(source) -> Iterator[np.ndarray]:
    """Normalize any byte source into an iterator of host uint8 arrays."""
    if isinstance(source, Compressed):
        yield from _decompressed_chunks(source)
        return
    if isinstance(source, str):
        source = source.encode("utf-8", errors="surrogateescape")
    if isinstance(source, (bytes, bytearray, memoryview)):
        yield np.frombuffer(bytes(source), np.uint8)
        return
    if isinstance(source, np.ndarray):
        a = source.reshape(-1)
        yield a if a.dtype == np.uint8 else a.astype(np.uint8)
        return
    if isinstance(source, torch.Tensor):
        yield as_u8_np(source).reshape(-1)
        return
    if hasattr(source, "read"):
        while True:
            b = source.read(_READ_BYTES)
            if not b:
                return
            yield np.frombuffer(bytes(b), np.uint8)
    else:
        for piece in source:
            yield from _as_chunks(piece)


class _HostRing:
    """Host window buffers reused round-robin.  On the card they are pinned,
    copied with ``non_blocking=True``, and a buffer is handed out for
    refilling only once the CUDA event recorded behind its last copy has
    completed.  On the CPU a window tensor shares its buffer, which is not
    refilled before the scan of that window has run (the loop keeps one
    window pending, the ring holds three)."""

    def __init__(self, nbytes: int, device: torch.device):
        pin = device.type == "cuda"
        self.bufs = [torch.zeros(nbytes, dtype=torch.uint8, pin_memory=pin) for _ in range(_RING)]
        self.views = [b.numpy() for b in self.bufs]
        self.events: List[Optional[torch.cuda.Event]] = [None] * _RING
        self.next = 0

    def take(self) -> np.ndarray:
        i = self.next
        self.next = (i + 1) % _RING
        if self.events[i] is not None:
            self.events[i].synchronize()
            self.events[i] = None
        return self.views[i]

    def upload(self, view: np.ndarray, device: torch.device) -> torch.Tensor:
        i = next(j for j, v in enumerate(self.views) if v is view)
        if device.type != "cuda":
            return self.bufs[i]
        dev = self.bufs[i].to(device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        self.events[i] = ev
        return dev


def _index(window: torch.Tensor, length: int) -> engine.TextIndex:
    return engine.build_index(window[None, :], [int(length)])


def _fused_count_step(counts, window, length, prev_ov, plans, *, ov: int, k, shared: bool = True):
    """One streaming chunk, seam correction FUSED into the scan: the
    ``end_min=prev_ov`` gate inside every matcher keeps exactly the
    occurrences whose END falls in the newly-streamed region, replacing the
    two-pass overlap-prefix subtraction (DESIGN.md §11 proves the two give
    identical integers).  One count_many per chunk; adds into ``counts``."""
    del ov  # the fused gate needs no prefix sub-index
    counts += engine.count_many(_index(window, length), plans, k=k, end_min=int(prev_ov),
                                shared=shared)[0]
    return counts


def _kernel_count_step(counts, window, length, prev_ov, plans, *, auto, k):
    """One chunk of a set megascan refuses, counted by the port's other
    kernels with the seam gate ``end_min=prev_ov``: the exact groups by one
    Aho-Corasick counts launch over their whole dictionary (``acscan``
    through ``engine._automaton_counts``; ``auto`` from
    ``_exact_automaton``), the k-mismatch groups, and the exact ones when no
    automaton fits its caps, by the ``approx`` kernel (k = 0 is exact), a
    slice of patterns at a time.  Adds into ``counts``."""
    from repro_torch.approx import counting

    index = _index(window, length)
    if auto is not None:
        exact = engine._automaton_counts(index, auto, int(prev_ov))[0]
    col = a_col = 0
    for p in plans:
        P, kk = p.n_patterns, engine._effective_k(p, k)
        if kk == 0 and auto is not None:
            got = exact[a_col : a_col + P]
            a_col += P
        else:
            got = engine._dense_count(
                index, p, lambda i, q, e, kk=kk: counting.match_group_approx(i, q, kk, e),
                int(prev_ov))[0]
        counts[col : col + P] += got
        col += P
    return counts


def _exact_automaton(plans: Sequence[PatternPlan], k):
    """The Aho-Corasick automaton of the exact groups' patterns in plan
    order (its columns are theirs in ``_kernel_count_step``), or None with
    no exact group or when its caps refuse it."""
    from repro_torch.core.automaton import compile_automaton

    rows = [r for p in plans if engine._effective_k(p, k) == 0 for r in p.patterns.cpu().numpy()]
    return compile_automaton(rows, device=plans[0].device) if rows else None


def _count_step(counts, window, length, prev_ov, plans, *, ov: int, k, shared: bool = True):
    """Reference two-pass chunk step: full-window counts minus
    overlap-prefix counts.  Kept as the fallback and the oracle the fused
    paths (``_fused_count_step`` and the megascan kernel) are pinned
    against.

    ``window`` is (N,) uint8 with ``length`` valid bytes, the first
    ``prev_ov`` of which were carried from the previous window (0 for the
    first chunk).  The subtraction removes exactly the occurrences whose
    window lies entirely inside the carried prefix — the ones the previous
    chunk already counted — so the sum over chunks is the whole-text count."""
    c = engine.count_many(_index(window, length), plans, k=k, shared=shared)
    if ov:
        pre = engine.build_index(window[None, :ov], [min(int(prev_ov), int(length))])
        c = c - engine.count_many(pre, plans, k=k, shared=shared)
    counts += c[0]
    return counts


def _mask_step(window, length, prev_ov, plans, *, k, fused: bool = True) -> torch.Tensor:
    """(P_total, N) bool match-start mask for one chunk, de-duplicated at the
    seam: a start survives iff its occurrence ENDS at or past ``prev_ov``
    (ends inside the carried prefix belong to the previous chunk).  The
    fused form pushes that gate into the matchers (``end_min``); the
    reference form post-filters — bit-identical."""
    idx = _index(window, length)
    if fused:
        return engine.match_many(idx, plans, k=k, end_min=int(prev_ov))[0]
    mask = engine.match_many(idx, plans, k=k)[0]
    pos = torch.arange(window.shape[0], dtype=torch.int32, device=window.device)
    keeps = []
    for plan in plans:
        keep = pos + (plan.m - 1) >= int(prev_ov)
        keeps.append(keep[None, :].expand(plan.n_patterns, window.shape[0]))
    return mask & torch.cat(keeps, dim=0)


class StreamScanner:
    """Chunked, double-buffered, exact streaming matcher for a plan set.

    Device memory is O(chunk_bytes) regardless of input length; every chunk
    costs exactly one scan (``dispatch_count`` audits this).  Pattern rows
    are in plan-concatenated order, as everywhere in the engine; ``order``
    maps them back to the original pattern sequence.

    ``k`` overrides the per-plan mismatch budget exactly like
    ``engine.count_many(..., k=)``; None runs each plan at the budget it was
    compiled for.

    ``chunk_bytes`` may be an int or ``"auto"`` (the default): auto picks
    the window from the device memory budget and a one-time measured
    dispatch-overhead probe (:func:`auto_chunk_bytes`) and logs the chosen
    value; the resolved size is ``self.chunk_bytes``.

    ``use_kernel`` routes counting through the fused ``megascan`` kernel
    when the plan set is kernel-eligible (``kernels/megascan/ops.py``): one
    launch per chunk adding into one device accumulator, no host read until
    the end.  None (the default) takes it on a CUDA device and not on the
    CPU; True takes it on the CPU too (its plain version there), False pins
    the pure-PyTorch steps.  A set megascan refuses is a static decision,
    logged as a ``kernel_fallback`` event: each chunk is then counted by the
    acscan and approx kernels (``_kernel_count_step``; their plain versions
    on the CPU), never different results.  Without the kernel the fused
    pure-PyTorch path runs, which syncs per chunk (its routes compare
    candidate counts with budgets on the host).  ``fused`` (default True)
    runs those steps with the seam correction fused into the matchers;
    False keeps the reference two-pass step, bit-identical.

    ``device`` places the windows, the accumulator and a copy of the plans
    (``engine.replicate_plans``); None keeps the plans' device.

    ``count_many``/``masks``/``positions_many`` accept ``prefix``/``start``
    to scan a mid-stream RANGE of a larger logical stream: ``start`` is the
    global byte offset of the source's first byte and ``prefix`` the up-to-
    ``overlap`` bytes immediately before it.  ``start - len(prefix)`` must
    sit on a beta block boundary so chunk-local aligned block fingerprints
    still coincide with the global ones.

    ``recorder`` attaches a :class:`~repro_torch.obs.recorder.Recorder`:
    every chunk then traces a ``host_prep`` span (source read / decompress /
    window assembly), a ``device_put`` span and a fenced ``dispatch`` span,
    plus ``dispatches``/``bytes_scanned`` counters.  ``lane`` names this
    scanner's trace track.

    ``watchdog`` is any object with ``start_step(step)``, ``end_step()``
    (returning non-None for a flagged step) and ``events``, armed around
    every chunk's HOST step — source read, decompression, window assembly —
    where slow storage stalls.  ``on_straggler(event)`` observes flagged
    chunks (a raising watchdog aborts the scan itself).
    """

    def __init__(
        self,
        plans: Sequence[PatternPlan],
        chunk_bytes: Union[int, str] = "auto",
        *,
        k: Optional[int] = None,
        device=None,
        fused: bool = True,
        shared: bool = True,
        use_kernel: Optional[bool] = None,
        watchdog=None,
        on_straggler=None,
        recorder: Optional[Recorder] = None,
        lane: Optional[str] = None,
    ):
        self.plans = tuple(plans)
        if not self.plans:
            raise ValueError("StreamScanner needs at least one PatternPlan")
        self.rec = _DEFAULT_REC if recorder is None else recorder
        self.lane = lane
        self.plans = engine.replicate_plans(self.plans, device)
        self.device = self.plans[0].device
        self.k = k
        self.fused = bool(fused)
        # shared=False pins the per-group engine path (count_many shared=False)
        self.shared = bool(shared)
        self.spec = None
        self._kernel_steps = False  # megascan refused: _kernel_count_step
        self._auto = None  # its automaton of the exact groups
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        if use_kernel:
            from repro_torch.kernels.megascan.ops import build_mega_spec

            self.spec = build_mega_spec(self.plans, k=k)
            if self.spec is None:
                self._kernel_steps = True
                self._auto = _exact_automaton(self.plans, k)
                self.rec.event(
                    "kernel_fallback", lane=self.lane,
                    reason="megascan ineligible for this plan set; counting each window "
                    "with the acscan and approx kernels",
                )
        # on the card the first count dispatch takes the megascan tables and
        # the scanner holds them for its whole life, so a launch never reads
        # tables the kernel's cache dropped; replicas share the holder, so a
        # sharded scan builds them once
        self._held: list = []
        if chunk_bytes == "auto":
            chunk_bytes = auto_chunk_bytes(device=self.device)
            self.rec.event(
                "auto_chunk", lane=self.lane, chunk_bytes=int(chunk_bytes),
                dispatch_overhead_us=round(1e6 * _dispatch_overhead_s(self.device), 1),
            )
        self.chunk_bytes = int(chunk_bytes)
        self.max_m = max(p.m for p in self.plans)
        # overlap >= max_m - 1 carries every possibly-straddling occurrence
        # start; rounding up to the beta block keeps each window's start on
        # a global beta boundary (EPSMc block-phase carry).
        self.overlap = _round_up(self.max_m - 1, EPSMC_BETA)
        window = max(self.chunk_bytes, self.overlap + EPSMC_BETA)
        self.window_bytes = _round_up(window, EPSMC_BETA)
        self.step_bytes = self.window_bytes - self.overlap
        self.n_patterns = sum(p.n_patterns for p in self.plans)
        self.order = engine.plan_order(self.plans)
        self.dispatch_count = 0
        self.watchdog = watchdog
        self.on_straggler = on_straggler
        self._ring: Optional[_HostRing] = None

    def replica(self, lane: Optional[str] = None) -> "StreamScanner":
        """A scanner of the same plans, megascan spec and tables and the same
        window, with its own host ring and dispatch count: one per thread or
        shard of a sharded scan, none rebuilding what this one built."""
        twin = copy.copy(self)
        twin.lane = lane
        twin.dispatch_count = 0
        twin._ring = None
        return twin

    # -- host-side re-chunking ---------------------------------------------

    def _injection(self, prefix, start: int) -> Tuple[np.ndarray, int]:
        """Validate a mid-stream (prefix, start) injection; returns the
        normalized carry array and the global position of the first window."""
        if prefix is None:
            carry = np.zeros(0, np.uint8)
        else:
            carry = np.ascontiguousarray(as_u8_np(prefix).reshape(-1))
        if len(carry) > self.overlap:
            raise ValueError(
                f"injected prefix ({len(carry)} B) exceeds the scanner "
                f"overlap ({self.overlap} B)"
            )
        base = int(start) - len(carry)
        if base % EPSMC_BETA:
            raise ValueError(
                "start - len(prefix) must be a multiple of EPSMC_BETA "
                f"({EPSMC_BETA}) to preserve the global block phase; got "
                f"start={start}, len(prefix)={len(carry)}"
            )
        return carry, base

    def _buffers(self) -> _HostRing:
        if self._ring is None:
            self._ring = _HostRing(self.window_bytes, self.device)
        return self._ring

    def _windows(
        self, source, *, prefix=None, start: int = 0
    ) -> Iterator[Tuple[np.ndarray, int, int, int]]:
        """Yield (window (N,) uint8, valid_len, carry_len, base): fixed-
        capacity host windows (buffers of the scanner's ring, zero past
        valid_len) where window[:carry_len] re-feeds the previous window's
        tail and ``base`` is the global position of window[0].
        ``prefix``/``start`` seed the first window's carry for mid-stream
        ranges."""
        N, ov = self.window_bytes, self.overlap
        ring = self._buffers()
        pieces: deque = deque()
        have = 0
        carry, base = self._injection(prefix, start)
        exhausted = False
        it = _as_chunks(source)
        while True:
            while not exhausted and have < N - len(carry):
                try:
                    piece = next(it)
                except StopIteration:
                    exhausted = True
                    break
                if len(piece):
                    pieces.append(piece)
                    have += len(piece)
            new_len = min(have, N - len(carry))
            if new_len == 0:
                return  # nothing newly streamed: no window to emit
            win = ring.take()
            win[: len(carry)] = carry
            filled = len(carry)
            need = new_len
            while need:
                piece = pieces.popleft()
                take = min(len(piece), need)
                win[filled : filled + take] = piece[:take]
                if take < len(piece):
                    pieces.appendleft(piece[take:])
                filled += take
                need -= take
            have -= new_len
            L = len(carry) + new_len
            win[L:] = 0
            yield win, L, len(carry), base
            carry = win[max(0, L - ov) : L].copy() if ov else carry
            base += L - len(carry)

    def _steps(self, source, *, prefix=None, start: int = 0):
        """The `_windows` iterator with each window's PRODUCTION (source
        read, decompress, assembly) wrapped in a ``host_prep`` recorder span
        and, when a watchdog is armed, timed for straggling."""
        rec, lane = self.rec, self.lane
        wd = self.watchdog
        it = self._windows(source, prefix=prefix, start=start)
        step = 0
        while True:
            if wd is not None:
                wd.start_step(step)
            try:
                with rec.span("host_prep", lane=lane, step=step) as sp:
                    win, L, carry_len, base = next(it)
                    sp.set(bytes=int(L) - int(carry_len))
            except StopIteration:
                if wd is not None:
                    wd.end_step()  # close the pair; an instant EOF never flags
                return
            if wd is not None and wd.end_step() is not None:
                ev = wd.events[-1]
                rec.event(
                    "straggler", lane=lane, step=ev.step,
                    duration_s=round(ev.duration_s, 6),
                    median_s=round(ev.median_s, 6),
                    factor=round(ev.factor, 2),
                )
                if self.on_straggler is not None:
                    self.on_straggler(ev)
            step += 1
            yield win, L, carry_len, base

    # -- device loop --------------------------------------------------------

    def _put(self, win: np.ndarray) -> torch.Tensor:
        """Host->device window transfer under a ``device_put`` span.  The
        copy is asynchronous; the fence (enabled recorder only) charges it
        to this span instead of the next dispatch."""
        with self.rec.span("device_put", lane=self.lane, bytes=int(win.nbytes)) as sp:
            return sp.fence(self._buffers().upload(win, self.device))

    def _dispatch_count(self, counts, window_dev, length, prev_ov):
        self.dispatch_count += 1
        new_bytes = int(length) - int(prev_ov)
        with self.rec.span(
            "dispatch", lane=self.lane, chunk=self.dispatch_count, bytes=new_bytes,
        ) as sp:
            if self.spec is not None:
                from repro_torch.kernels.megascan.ops import megascan_count_window

                if not self._held and self.device.type == "cuda":
                    from repro_torch.kernels.megascan.megascan import kernel_entry

                    self._held.append(kernel_entry(self.plans, self.spec))
                megascan_count_window(window_dev, self.plans, self.spec, length=int(length),
                                      prev_ov=int(prev_ov), out=counts)
            elif self._kernel_steps:
                _kernel_count_step(counts, window_dev, length, prev_ov, self.plans,
                                   auto=self._auto, k=self.k)
            else:
                step = _fused_count_step if self.fused else _count_step
                step(counts, window_dev, length, prev_ov, self.plans,
                     ov=self.overlap, k=self.k, shared=self.shared)
            # the seam correction runs inside this same scan; the fence makes
            # the span cover the device work
            sp.fence(counts)
        self.rec.count("dispatches")
        self.rec.count("bytes_scanned", new_bytes)
        return counts

    def _zero_counts(self) -> torch.Tensor:
        return torch.zeros((self.n_patterns,), dtype=torch.int32, device=self.device)

    def count_device(self, source, *, prefix=None, start: int = 0) -> torch.Tensor:
        """Device-resident (P_total,) int32 count accumulator, NOT synced.

        Double-buffered: the (i+1)-th window's host->device copy is issued
        before the i-th window's scan is enqueued."""
        counts = self._zero_counts()
        pending = None
        for win, L, carry_len, _base in self._steps(source, prefix=prefix, start=start):
            dev = self._put(win)
            if pending is not None:
                counts = self._dispatch_count(counts, *pending)
            pending = (dev, L, carry_len)
        if pending is not None:
            counts = self._dispatch_count(counts, *pending)
        return counts

    def count_many(self, source, *, prefix=None, start: int = 0) -> np.ndarray:
        """int32 (P_total,) exact occurrence counts over the whole stream
        (or, with ``prefix``/``start``, over one mid-stream range — counting
        exactly the occurrences whose END lies inside it)."""
        return self.count_device(source, prefix=prefix, start=start).cpu().numpy()

    def any_many(self, source) -> np.ndarray:
        """bool (P_total,) — does each pattern occur anywhere in the stream?"""
        return self.count_many(source) > 0

    def contains_any(self, source, *, sync_every: int = 8) -> bool:
        """Scalar verdict with early exit: the accumulator is polled every
        ``sync_every`` chunks so a hit near the head of a long stream stops
        the scan without draining the source."""
        counts = self._zero_counts()
        pending = None
        chunks = 0
        for win, L, carry_len, _base in self._steps(source):
            dev = self._put(win)
            if pending is not None:
                counts = self._dispatch_count(counts, *pending)
                chunks += 1
                if chunks % sync_every == 0 and bool(counts.sum() > 0):
                    return True
            pending = (dev, L, carry_len)
        if pending is not None:
            counts = self._dispatch_count(counts, *pending)
        return bool(counts.cpu().numpy().sum() > 0)

    def masks(
        self, source, *, prefix=None, start: int = 0
    ) -> Iterator[Tuple[int, int, np.ndarray]]:
        """Yield (base, new_start, (P_total, L) bool) per chunk: the seam-
        deduped match-start mask of the chunk's valid bytes.  A start at
        column j is global position base + j; every occurrence appears in
        exactly one yielded mask.  ``new_start`` is the carried-prefix
        length.  With ``prefix``/``start``, bases are global stream
        positions and occurrences ending before ``start`` are dropped."""
        pending = None
        for win, L, carry_len, base in self._steps(source, prefix=prefix, start=start):
            dev = self._put(win)
            if pending is not None:
                yield self._flush_mask(*pending)
            pending = (dev, L, carry_len, base)
        if pending is not None:
            yield self._flush_mask(*pending)

    def _flush_mask(self, dev, length, prev_ov, base):
        self.dispatch_count += 1
        new_bytes = int(length) - int(prev_ov)
        with self.rec.span(
            "dispatch", lane=self.lane, chunk=self.dispatch_count, bytes=new_bytes,
        ) as sp:
            mask = sp.fence(_mask_step(dev, length, prev_ov, self.plans, k=self.k,
                                       fused=self.fused))
        self.rec.count("dispatches")
        self.rec.count("bytes_scanned", new_bytes)
        return base, int(prev_ov), mask[:, :length].cpu().numpy()

    def positions_many(
        self, source, *, prefix=None, start: int = 0
    ) -> List[np.ndarray]:
        """Per-pattern sorted global occurrence start positions (host side;
        output-sized host memory, still O(chunk) device memory)."""
        out: List[List[np.ndarray]] = [[] for _ in range(self.n_patterns)]
        for base, _new_start, mask in self.masks(source, prefix=prefix, start=start):
            for p_i in range(self.n_patterns):
                (loc,) = np.nonzero(mask[p_i])
                if len(loc):
                    out[p_i].append(loc.astype(np.int64) + base)
        return [np.concatenate(o) if o else np.zeros(0, np.int64) for o in out]

    # -- accounting ---------------------------------------------------------

    @property
    def device_bytes_per_chunk(self) -> int:
        """Estimated peak device working set per chunk: window text (1) +
        packed int32 view (4) + block fingerprints (0.5) + one fingerprint
        temporary (4) per byte, plus the plan LUTs."""
        per_byte = self.window_bytes + self.overlap
        luts = 0
        for p in self.plans:
            luts += (1 << p.kbits)  # lut_any
            if p.lut_pid is not None:
                luts += 4 * (1 << p.kbits)
            if p.lut_bits is not None:
                luts += 4 * p.lut_bits.shape[-1] * (1 << p.kbits)
            if p.relaxed_lut is not None:
                luts += (1 << p.kbits)
        return int(9.5 * per_byte) + luts


# ---------------------------------------------------------------------------
# Convenience wrappers (the epsm.find/count stream= escape hatch lands here)
# ---------------------------------------------------------------------------

def stream_count(
    source,
    patterns: Sequence,
    *,
    k: int = 0,
    chunk_bytes: Union[int, str] = "auto",
    use_kernel: Optional[bool] = None,
    device=None,
) -> np.ndarray:
    """int32 (P,) exact (or <= k-mismatch) counts in ORIGINAL pattern order.
    ``chunk_bytes="auto"`` (default) sizes the window adaptively; plans and
    windows go to ``device`` (default: the card); ``use_kernel`` as in
    :class:`StreamScanner`."""
    plans = engine.compile_patterns_cached(list(patterns), k=k, device=device)
    sc = StreamScanner(plans, chunk_bytes, k=k, use_kernel=use_kernel)
    counts = sc.count_many(source)
    out = np.zeros_like(counts)
    out[sc.order] = counts
    return out


def find_stream(
    source,
    pattern,
    *,
    k: int = 0,
    chunk_bytes: Union[int, str] = "auto",
    device=None,
) -> np.ndarray:
    """Whole-stream bool match-start mask for ONE pattern, assembled on the
    host chunk by chunk (host memory is O(n); device stays O(chunk))."""
    plans = engine.compile_patterns_cached([pattern], k=k, device=device)
    sc = StreamScanner(plans, chunk_bytes, k=k)
    out = np.zeros(sc.window_bytes, bool)
    n = 0
    for base, _new_start, mask in sc.masks(source):
        end = base + mask.shape[1]
        if end > len(out):
            out = np.resize(out, max(2 * len(out), end))
            out[n:] = False
        out[base:end] |= mask[0]
        n = max(n, end)
    return out[:n]
