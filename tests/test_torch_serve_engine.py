"""repro_torch.serve.engine (StopScanner, ServeEngine) against
repro.serve.engine, at small sizes on the CPU.

Mirrors the StopScanner cases of tests/test_match_many.py, the fuzzy stop
of tests/test_approx.py, the lazy-sync case of tests/test_stream.py, the
fenced spans of tests/test_obs.py and tests/test_train_serve.py's
ServeEngine stop strings.  Hit matrices are compared with the reference's
bit for bit, step by step, for B > 1, for stops in all three length groups
('a' m < 4, 'b' 4 <= m < 16, 'c' m >= 16), for streams longer than 2W (the
tail ring wraps), at k = 0 and k = 1.  Greedy generation is compared in
text and ``stopped_by``; sampled generation cannot equal the reference's
``jax.random`` stream, so it is checked for repeating by seed and for the
reference's stop and BOS semantics instead.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import reduced_config
from repro.data.pipeline import VOCAB
from repro.models import transformer as RT
from repro.serve import engine as RE
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.obs import Recorder
from repro_torch.serve import engine as E

CPU = "cpu"


def _scanner(stops, B, n, k=0, **kw):
    return E.StopScanner(stops, B, n, k=k, device=CPU, **kw)


def _scan_all(sc, streams):
    """(steps, B, P) hit matrices of a scanner fed the streams byte by byte."""
    steps = len(streams[0])
    return np.stack([
        sc.scan(np.asarray([s[step] for s in streams], np.int32), step) for step in range(steps)
    ])


STOP_SETS = {
    "abc_groups": [b"stop", b"here", b"xx", b"\x00\x00\x00", b"ab", b"q",
                   b"the end of the stream", b"sixteen_bytes_ok"],
    "one_b": [b"abcd"],
    "c_only": [b"a longer stop string!", b"0123456789abcdef"],
}


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("stops", sorted(STOP_SETS))
def test_hit_matrices_equal_reference_bit_for_bit(stops, k):
    stops = STOP_SETS[stops]
    rs = np.random.RandomState(0)
    W = max(len(s) for s in stops)
    n = 2 * W + 19  # the ring wraps at least twice
    streams = []
    for b in range(3):
        row = bytearray(rs.choice(list(b"abcdehopqrstx \x00"), size=n).astype(np.uint8).tobytes())
        for j, s in enumerate(stops):  # plant every stop in some row
            if (j + b) % 3 == 0:
                at = rs.randint(0, n - len(s) + 1)
                row[at : at + len(s)] = s
        if k:  # and a one-byte typo of the longest one
            s = bytearray(max(stops, key=len))
            s[len(s) // 2] ^= 1
            at = rs.randint(0, n - len(s) + 1)
            row[at : at + len(s)] = s
        streams.append(bytes(row))
    got = _scan_all(_scanner(stops, 3, n, k=k), streams)
    ref = RE.StopScanner(stops, 3, n, k=k)
    want = np.stack([
        ref.scan(np.asarray([s[step] for s in streams], np.int32), step) for step in range(n)
    ])
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_stop_scanner_one_dispatch_per_step():
    streams = [b"hello stop here", b"xxxxxxxxxxxxxxx", b"stopstopstopsto"]
    stops = [b"stop", b"here", b"xx", b"\x00\x00\x00"]
    sc = _scanner(stops, 3, 15)
    hits = _scan_all(sc, streams)
    assert sc.dispatch_count == 15  # 1 per step, not B*stops per step
    first = {}
    for step, b, si in zip(*np.nonzero(hits)):
        first.setdefault((b, si), step)
    assert first[(0, 0)] == 9 and first[(0, 1)] == 14 and first[(1, 2)] == 1 and first[(2, 0)] == 3
    # the zero-byte stop must NOT fire from the uninitialized ring apron
    assert (2, 3) not in first and (0, 3) not in first


def test_stop_scanner_ring_wraparound():
    stream = b"xyabcdabcd_abcd_abcd"
    sc = _scanner([b"abcd"], 1, len(stream))
    hits = _scan_all(sc, [stream])
    assert tuple(sc.buf.shape) == (1, 7)  # O(W), not O(max_new)
    assert np.nonzero(hits[:, 0, 0])[0].tolist() == [5, 9, 14, 19]


def test_stop_scanner_two_stops_same_step():
    hits = _scan_all(_scanner([b"abc", b"xbc", b"bc", b"zzzz"], 1, 10), [b"__abc__xbc"])
    fired = {si: np.nonzero(hits[:, 0, si])[0].tolist() for si in range(4)}
    assert fired == {0: [4], 1: [9], 2: [4, 9], 3: []}


def test_fuzzy_stop_scanner():
    stream = b"aa STOPW0RD bbbbbbbb"  # O -> 0 typo in the generated bytes
    for k, expect in ((0, []), (1, [10])):
        sc = _scanner([b"STOPWORD"], 1, len(stream), k=k)
        hits = _scan_all(sc, [stream])
        assert np.nonzero(hits[:, 0, 0])[0].tolist() == expect, k
        assert sc.dispatch_count == len(stream)


def test_hit_matrix_copied_only_on_steps_with_a_hit(monkeypatch):
    rs = np.random.RandomState(1)
    stream = bytes(rs.randint(0, 3, size=60).astype(np.uint8))
    stops = [b"\x00\x01", b"\x01\x02\x00"]
    sc = _scanner(stops, 1, len(stream))
    copies = []
    orig = torch.Tensor.cpu

    def counting_cpu(t, *a, **kw):
        copies.append(tuple(t.shape))
        return orig(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    hits = _scan_all(sc, [stream])
    monkeypatch.undo()
    hit_steps = int(hits.any(axis=(1, 2)).sum())
    assert 0 < hit_steps < len(stream)
    assert copies.count((1, 2)) == hit_steps
    want = [e for e in range(len(stream)) for s in stops
            if e + 1 >= len(s) and stream[e + 1 - len(s) : e + 1] == s]
    assert sorted(np.nonzero(hits.any(axis=2))[0].tolist()) == sorted(set(want))


def test_stop_scanner_records_fenced_spans():
    rec = Recorder(enabled=True, fence=True)
    sc = _scanner([b"ab"], 2, 8, recorder=rec)
    hits = _scan_all(sc, [b"xaab", b"xxxx"])
    assert hits[3][0, 0] and not hits[3][1, 0]
    assert rec.summary()["spans"]["stop_scan"]["count"] == sc.dispatch_count == 4
    assert rec.metrics.summary()["counters"]["stop_scan_dispatches"] == 4


def test_no_stops_and_empty_stop():
    sc = _scanner([], 2, 4)
    assert sc.scan(np.zeros(2, np.int32), 0).shape == (2, 0)
    with pytest.raises(ValueError):
        _scanner([b""], 1, 4)


# -- ServeEngine -----------------------------------------------------------


def _tiny_cfg():
    cfg = reduced_config("smollm-135m")
    return dataclasses.replace(
        cfg, vocab=VOCAB, n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
        d_ff=64, q_chunk=32, kv_chunk=32, ce_chunk=32,
    )


@pytest.fixture(scope="module")
def engines():
    cfg = _tiny_cfg()
    rparams = RT.init_params(jax.random.key(2), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(rparams))
    params = lm_params_from_numpy(tree, cfg, device=CPU)
    return (RE.ServeEngine(rparams, cfg, max_len=128),
            E.ServeEngine(params, cfg, max_len=128, device=CPU))


PROMPTS = [b"hello world ", b"the quick br", b"0123456789ab"]


def _same(got, want):
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.stopped_by for r in got] == [r.stopped_by for r in want]
    for r in got:
        np.testing.assert_array_equal(r.tokens, np.frombuffer(r.text, np.uint8))


def test_greedy_generate_equals_reference(engines):
    ref, eng = engines
    want = ref.generate(PROMPTS, max_new_tokens=24)
    got = eng.generate(PROMPTS, max_new_tokens=24)
    _same(got, want)
    # stops from the outputs themselves: a 1-byte one, one of each group
    text = want[1].text
    stops = [text[3:5], text[4:9], want[0].text[2:19], text[6:7]]
    stops = [s for s in stops if s]
    fuzzy = [s for s in stops if len(s) >= 4]  # k = 1 on a short stop fires at once
    for k, ss in ((0, stops), (1, fuzzy)):
        want = ref.generate(PROMPTS, max_new_tokens=24, stop_strings=ss, stop_k=k)
        assert any(r.stopped_by for r in want)
        _same(eng.generate(PROMPTS, max_new_tokens=24, stop_strings=ss, stop_k=k), want)


def test_generate_stops_on_first_byte(engines):
    """tests/test_train_serve.py::test_serve_engine_stop_strings on the port."""
    _, eng = engines
    res = eng.generate(PROMPTS[:2], max_new_tokens=12)
    assert len(res) == 2 and all(len(r.text) <= 12 for r in res)
    first = res[0].text[:1]
    if first:
        res2 = eng.generate(PROMPTS[:2], max_new_tokens=12, stop_strings=[first])
        assert res2[0].stopped_by == first and len(res2[0].text) == 1


def test_sampled_generate_repeats_by_seed_with_stop_and_bos_semantics(engines):
    """Sampling draws from a torch.Generator, so its tokens differ from the
    reference's jax.random draws; it must repeat for a seed, and keep the
    reference's semantics: a row ends on its first stop (the stop is the
    text's suffix, and no earlier prefix ends in a stop) or on BOS (never
    part of the text)."""
    _, eng = engines
    stops = [b"e", b"  "]
    kw = dict(max_new_tokens=40, temperature=0.7, stop_strings=stops)
    a = eng.generate(PROMPTS, seed=3, **kw)
    b = eng.generate(PROMPTS, seed=3, **kw)
    c = eng.generate(PROMPTS, seed=4, **kw)
    assert [r.text for r in a] == [r.text for r in b]
    assert [r.text for r in a] != [r.text for r in c]
    for r in a + c:
        assert len(r.text) <= 40 and all(t < 256 for t in r.tokens)
        if r.stopped_by is not None:
            assert r.text.endswith(r.stopped_by)
        ends = [i for i in range(1, len(r.text) + 1) if any(r.text[:i].endswith(s) for s in stops)]
        assert ends == ([len(r.text)] if r.stopped_by is not None else [])


def test_generate_rejects_ragged_prompts_and_overlong_requests(engines):
    _, eng = engines
    with pytest.raises(ValueError):
        eng.generate([b"ab", b"abc"])
    with pytest.raises(ValueError):
        eng.generate([b"ab"], max_new_tokens=200)


def test_recorder_spans_prefill_decode_and_stop_scan(engines):
    _, eng = engines
    rec = Recorder(enabled=True, fence=True)
    res = eng.generate(PROMPTS, max_new_tokens=6, stop_strings=[b"\xff\xfe"], recorder=rec)
    spans = rec.summary()["spans"]
    steps = max(len(r.text) for r in res)
    assert spans["prefill"]["count"] == 1
    assert spans["stop_scan"]["count"] == 6 and spans["decode"]["count"] in (5, 6)
    assert steps <= 6
