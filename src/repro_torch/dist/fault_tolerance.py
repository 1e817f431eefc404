"""Fault tolerance for sharded scans, in the PyTorch port: injected faults
(restart tests), shard-retry bookkeeping for the sharded streaming scanner,
retry classification (retryable I/O vs. fatal programming errors), jittered
exponential backoff, a per-step straggler watchdog, and the abort signal it
raises.  DESIGN.md §12 is the contract.

The port's copy of ``repro.dist.fault_tolerance``, which imports no JAX
either: the classes, the retry classifier and the backoff schedule are the
reference's, line for line; the retry loop's recorder is
``repro_torch.obs``'s.

The watchdog keeps a rolling window of recent step durations and flags a step
as a straggler when it exceeds ``factor`` x the rolling median.  What happens
then is the ``policy``:

  * ``"log"``        — record the event, keep going (production default:
                       stragglers are noted for the capacity dashboard).
  * ``"checkpoint"`` — record the event and tell the training loop to cut a
                       checkpoint now (pre-emption is probably imminent).
  * ``"raise"``      — raise :class:`StragglerAbort` so a supervisor can
                       reschedule the job (used by the elastic tests).
"""

from __future__ import annotations

import dataclasses
import random
import statistics
import time
from typing import Callable, List, Optional


class InjectedFault(RuntimeError):
    """Simulated node failure, raised mid-run by tests/launchers."""


class FatalScanError(RuntimeError):
    """A source/scanner error that retrying can never fix (auth failure,
    object permanently gone, corrupt metadata).  Classified non-retryable by
    :func:`default_is_retryable`, so it surfaces on the first attempt."""


class StragglerAbort(RuntimeError):
    """Raised by StepWatchdog(policy="raise") when a step stalls."""


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float
    factor: float


@dataclasses.dataclass
class ShardRetry:
    """One failed attempt at scanning a stream shard (DESIGN.md §10): the
    shard was re-opened from its byte range and rescanned from scratch —
    a partial scan's already-dispatched chunks are simply discarded, so a
    retried shard's contribution is identical to a clean first pass."""

    shard: int
    attempt: int
    error: str


# Programming errors: retrying re-runs the identical code on the identical
# inputs, so these can only fail the same way again — burning retries on them
# hides the traceback behind seconds of pointless backoff.
_NON_RETRYABLE = (
    TypeError,
    ValueError,
    KeyError,
    IndexError,
    AttributeError,
    NotImplementedError,
    AssertionError,
)


def default_is_retryable(exc: BaseException) -> bool:
    """The retry classifier: transient I/O may heal, programming errors and
    :class:`FatalScanError` never do.  ``ValueError`` covers plan/spec
    construction AND data corruption (e.g. a truncated gzip stream) — both
    deterministic, neither helped by a rescan of the same bytes."""
    return not isinstance(exc, _NON_RETRYABLE + (FatalScanError,))


@dataclasses.dataclass
class BackoffPolicy:
    """Jittered exponential backoff: attempt i waits
    ``min(base_s * factor**i, max_s)`` scaled by a uniform jitter in
    ``[1 - jitter, 1 + jitter]`` (decorrelates a fleet of shards hammering
    the same recovering object store).  ``seed`` makes the jitter sequence
    deterministic for tests."""

    base_s: float = 0.05
    factor: float = 2.0
    max_s: float = 2.0
    jitter: float = 0.5
    seed: Optional[int] = None

    def __post_init__(self):
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError("jitter must be in [0, 1]")
        if self.base_s < 0 or self.factor < 1 or self.max_s < 0:
            raise ValueError("backoff needs base_s/max_s >= 0, factor >= 1")
        self._rng = random.Random(self.seed)

    def delay_s(self, attempt: int) -> float:
        d = min(self.base_s * self.factor ** attempt, self.max_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(d, 0.0)


def run_with_retries(
    fn,
    *,
    retries: int,
    on_failure=None,
    is_retryable: Optional[Callable[[BaseException], bool]] = None,
    backoff: Optional[BackoffPolicy] = None,
    sleep=time.sleep,
    recorder=None,
    label: str = "task",
):
    """Call ``fn()``; on a RETRYABLE exception retry up to ``retries`` more
    times (waiting ``backoff.delay_s(attempt)`` between attempts when a
    policy is given), then re-raise.  Non-retryable errors — programming
    errors per :func:`default_is_retryable`, or whatever the ``is_retryable``
    hook rejects — re-raise immediately: a TypeError from plan construction
    must not burn the retry budget a flaky object store needs.
    ``on_failure(attempt, exc)`` observes every failed attempt, fatal ones
    included (the sharded scanner logs a :class:`ShardRetry` there).

    ``recorder`` (a :class:`repro_torch.obs.recorder.Recorder`) gets one
    structured ``retry`` event per retried attempt and one ``retry_exhausted``
    / ``retry_fatal`` event when the loop gives up, each tagged with
    ``label`` — the flight-recorder view of the retry budget (DESIGN.md
    §13)."""
    classify = default_is_retryable if is_retryable is None else is_retryable
    if recorder is None:
        from repro_torch.obs.recorder import NULL as recorder
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 - a shard may die any way it likes
            if on_failure is not None:
                on_failure(attempt, exc)
            retryable = classify(exc)
            if attempt == retries or not retryable:
                recorder.event(
                    "retry_exhausted" if retryable else "retry_fatal",
                    task=label, attempt=attempt, error=repr(exc),
                )
                raise
            recorder.event(
                "retry", task=label, attempt=attempt, error=repr(exc)
            )
            if backoff is not None:
                sleep(backoff.delay_s(attempt))


class StepWatchdog:
    """Detect steps that run anomalously long vs the rolling median.

    Usage::

        wd = StepWatchdog(factor=3.0, policy="log")
        wd.start_step(step)
        ...run the step...
        action = wd.end_step()   # policy string if straggling, else None
    """

    def __init__(
        self,
        factor: float = 3.0,
        policy: str = "log",
        window: int = 64,
        min_history: int = 3,
        min_duration_s: float = 1e-4,
    ):
        if policy not in ("log", "checkpoint", "raise"):
            raise ValueError(f"unknown watchdog policy {policy!r}")
        self.factor = factor
        self.policy = policy
        self.window = window
        self.min_history = min_history
        self.min_duration_s = min_duration_s
        self.events: List[StragglerEvent] = []
        self._durations: List[float] = []
        self._step: Optional[int] = None
        self._t0: Optional[float] = None

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.perf_counter()

    def end_step(self) -> Optional[str]:
        if self._t0 is None:
            raise RuntimeError("end_step() without start_step()")
        dur = time.perf_counter() - self._t0
        step = self._step
        self._t0 = None
        straggler = False
        if len(self._durations) >= self.min_history:
            med = statistics.median(self._durations)
            if dur > max(self.factor * med, self.min_duration_s):
                straggler = True
                self.events.append(
                    StragglerEvent(
                        step=int(step), duration_s=dur, median_s=med,
                        factor=dur / max(med, 1e-12),
                    )
                )
        if not straggler:
            # stragglers don't pollute the baseline window
            self._durations.append(dur)
            if len(self._durations) > self.window:
                self._durations = self._durations[-self.window :]
            return None
        if self.policy == "raise":
            raise StragglerAbort(
                f"step {step} took {dur * 1e3:.1f}ms "
                f"(median {statistics.median(self._durations) * 1e3:.1f}ms)"
            )
        return self.policy
