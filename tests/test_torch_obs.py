"""repro_torch.obs against repro.obs: the same recordings give the same
summaries, reports and trace structure, and a port trace passes the
repository's validator (benchmarks/validate_trace.py, run as CI runs it).

Mirrors the recorder, metrics and validator cases of tests/test_obs.py; the
recorded workload is the port's engine (plan compilation and route_probe)
in place of the not yet ported streaming scanners.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from benchmarks.validate_trace import validate_trace  # noqa: E402

from repro import obs as R_obs  # noqa: E402
from repro.core import engine as R_engine  # noqa: E402
from repro_torch import obs as P_obs  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.obs import trace as P_trace  # noqa: E402

CPU = "cpu"


def _record(obs):
    """The same sequence of metrics, spans and events on one recorder."""
    m = obs.Metrics()
    m.count("dispatches")
    m.count("bytes", 100)
    m.count("bytes", 50)
    m.gauge("chunk", 4096)
    for v in range(1, 101):
        m.observe("lat", float(v))
    rec = obs.Recorder(enabled=True, fence=False)
    with rec.span("outer", lane="laneA", k=1):
        with rec.span("inner", lane="laneA", n=np.int64(3)):
            pass
    with rec.span("other", lane="laneB"):
        pass
    rec.event("steal", victim=0, thief=2, start=0, stop=8)
    rec.event("retry", lane="laneB", task="x", attempt=1)
    rec.count("plan_cache.hit", 2)
    rec.gauge("g", 1.5)
    rec.observe("h", 2.0)
    return m, rec


def _shape(trace):
    """A trace without its clock readings."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in trace["traceEvents"]]


def test_metrics_summary_and_report_equal_reference():
    mp, _ = _record(P_obs)
    mr, _ = _record(R_obs)
    assert mp.summary() == mr.summary()
    assert mp.report() == mr.report()
    h = mp.summary()["histograms"]["lat"]
    assert h["count"] == 100 and h["p50"] == 51 and h["p99"] == 100 and h["mean"] == 50.5


def test_recorder_export_structure_equals_reference(tmp_path):
    _, rp = _record(P_obs)
    _, rr = _record(R_obs)
    tp, tr = rp.trace_json(), rr.trace_json()
    assert tp["displayTimeUnit"] == "ms"
    assert _shape(tp) == _shape(tr)
    assert validate_trace(tp) == len(tp["traceEvents"])
    xs = {e["name"]: e for e in tp["traceEvents"] if e["ph"] == "X"}
    assert xs["outer"]["ts"] <= xs["inner"]["ts"]
    assert (xs["inner"]["ts"] + xs["inner"]["dur"]
            <= xs["outer"]["ts"] + xs["outer"]["dur"] + 0.0011)
    ps, rs = rp.summary(), rr.summary()
    assert ps["events"] == rs["events"]
    assert {k: v["count"] for k, v in ps["spans"].items()} == {
        k: v["count"] for k, v in rs["spans"].items()}
    assert ps["metrics"]["counters"] == rs["metrics"]["counters"]
    assert rp.events_named("retry")[0]["lane"] == "laneB"
    assert rp.report().startswith("== scan telemetry ==")
    assert json.loads(rp.summary_json()) == json.loads(json.dumps(ps))


def test_port_trace_passes_validator_script(tmp_path):
    """An engine run traced by the port's recorder, exported to a file and
    checked by benchmarks/validate_trace.py as CI runs it."""
    rec = P_obs.Recorder(enabled=True, fence=True)
    pats = [b"abcdefgh", b"abcdefgx", b"zzzz", b"abc", b"0123456789abcdefghij"]
    with rec.span("scan", lane="lane0"):
        plans = E.compile_patterns(pats, recorder=rec, device=CPU)
        idx = E.build_index(b"xxabcdefghzz" * 50, device=CPU)
        with rec.span("dispatch", lane="lane0") as sp:
            counts = sp.fence(E.count_many(idx, plans))
        E.route_probe(idx, plans, recorder=rec)
    assert counts.dtype == torch.int32 and int(counts[0, 0]) == 50
    out = rec.export_trace(tmp_path / "port_trace.json")
    res = subprocess.run([sys.executable, str(REPO / "benchmarks" / "validate_trace.py"), str(out)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert "OK" in res.stdout
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
    assert {"scan", "dispatch", "plan_compile", "plan_group", "fallback_route"} <= names


def test_disabled_recorder_is_inert_but_sinks_still_fire():
    captured = []
    rec = P_obs.Recorder(enabled=False, fence=False,
                         sinks=(lambda name, args: captured.append((name, dict(args))),))
    assert rec.span("anything", lane="x", a=1) is P_obs.NULL_SPAN
    obj = object()
    assert P_obs.NULL_SPAN.fence(obj) is obj
    P_obs.NULL_SPAN.set(a=1)
    pats = [b"abcd", b"abcdefghijklmnopq"]
    want = R_engine.compile_patterns(pats)
    plans = E.compile_patterns(pats, recorder=rec, device=CPU)
    assert [p.m for p in plans] == [p.m for p in want]
    assert rec.trace_json()["traceEvents"] == []
    assert [name for name, _ in captured] == ["plan_group", "plan_group"]
    rec.event("straggler", step=3, duration_s=0.5)
    assert captured[-1] == ("straggler", {"step": 3, "duration_s": 0.5})
    assert rec.events_named("straggler") == []


def test_compile_events_equal_reference():
    """Plan compilation reports the reference's plan_group events and gauges."""
    rng = np.random.RandomState(5)
    pats = list(np.unique(rng.randint(0, 256, (400, 8)).astype(np.uint8), axis=0)[:200])
    pats += [b"abc", b"0123456789abcdefghij"]
    rp, rr = P_obs.Recorder(fence=False), R_obs.Recorder(fence=False)
    E.compile_patterns(pats, recorder=rp, device=CPU)
    R_engine.compile_patterns(pats, recorder=rr)
    strip = lambda evs: [{k: v for k, v in e.items() if k not in ("ts", "lane")} for e in evs]
    assert strip(rp.events_named("plan_group")) == strip(rr.events_named("plan_group"))
    assert rp.metrics.summary()["gauges"] == rr.metrics.summary()["gauges"]
    assert rp.span_totals_ms().get("plan_compile", 0.0) > 0.0


def test_plan_cache_counters_reach_the_recorder():
    rec = P_obs.Recorder(fence=False)
    pats = [b"cache-counter-%d" % i for i in range(3)]
    E.compile_patterns_cached(pats, recorder=rec, device=CPU)
    E.compile_patterns_cached(pats, recorder=rec, device=CPU)
    counters = rec.metrics.summary()["counters"]
    assert counters["plan_cache.hit"] == 1 and counters["plan_cache.miss"] == 1
    assert counters["event/plan_group"] == 1  # compiled once


def test_fence_synchronizes_only_cuda_values(monkeypatch):
    """Span.fence waits for the card that holds the value, and for nothing
    on the CPU (the reference's jax.block_until_ready)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    span = P_obs.Recorder(enabled=True, fence=True).span("s")
    cpu = torch.zeros(3)
    assert span.fence(cpu) is cpu and synced == []

    class FakeCuda:
        is_cuda = True
        device = torch.device("cuda", 1)

    value = {"a": [cpu, FakeCuda()], "b": (FakeCuda(),)}
    assert span.fence(value) is value
    assert synced == [torch.device("cuda", 1)]
    assert P_trace._cuda_devices(None) == set()
    unfenced = P_obs.Recorder(enabled=True, fence=False).span("s")
    unfenced.fence(FakeCuda())
    assert len(synced) == 1


def test_default_recorders_are_disabled_with_log_sinks():
    assert P_obs.NULL.enabled is False and P_obs.NULL.sinks == []
    assert E._DEFAULT_REC.enabled is False and E._DEFAULT_REC.sinks


@pytest.mark.parametrize("value,want", [(np.float32(1.5), 1.5), (b"ab", "b'ab'"),
                                        ((1, np.int64(2)), [1, 2]), (None, None)])
def test_jsonable_equals_reference(value, want):
    from repro.obs import trace as R_trace

    assert P_trace._jsonable(value) == R_trace._jsonable(value) == want
