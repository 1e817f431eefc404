"""repro_torch.data.pipeline against repro.data.pipeline, at small sizes on
the CPU.

Inputs come from local seeded generators, not the session-scoped ``rng``
fixture, whose draws other test files in the same worker depend on.

Mirrors the pipeline cases of tests/test_substrate.py (blocklist filter,
dedup), tests/test_approx.py (blocklist_k = 1) and tests/test_stream.py
(oversize documents through the streaming scanner).  The same documents go
through both pipelines; batches, stats and dedup signatures must be equal,
and the copied constants are pinned to the reference's.
"""

import numpy as np
import pytest

from repro.core import epsm as R_epsm
from repro.data import corpus as RC
from repro.data import pipeline as RP
from repro_torch.core import epsm
from repro_torch.data import pipeline as P

CPU = "cpu"


def test_constants_pinned_to_reference():
    for name in ("BOS", "VOCAB", "FILTER_BATCH", "MAX_FILTER_LEN"):
        assert getattr(P, name) == getattr(RP, name), name
    assert epsm.EPSMC_KBITS == R_epsm.EPSMC_KBITS
    assert [P._bucket_len(n) for n in (0, 1, 256, 257, 5000, 1 << 18)] == \
        [RP._bucket_len(n) for n in (0, 1, 256, 257, 5000, 1 << 18)]
    assert P.FingerprintDeduper().kbits == RP.FingerprintDeduper().kbits
    np.testing.assert_array_equal(P.FingerprintDeduper().weights, RP.FingerprintDeduper().weights)


def _run(mod, docs, **kw):
    if mod is P:
        kw["device"] = CPU
    pipe = mod.LMDataPipeline([d.copy() for d in docs], **kw)
    return list(pipe), pipe.stats


def _same_run(docs, **kw):
    got, gstats = _run(P, docs, **kw)
    want, wstats = _run(RP, docs, **kw)
    assert gstats == P.PipelineStats(**vars(wstats))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            assert g[key].dtype == w[key].dtype == np.int32
            np.testing.assert_array_equal(g[key], w[key])
    return got, gstats


def test_blocklist_filter_equals_reference():
    bad = b"GATTACA"
    docs = []
    for i in range(40):
        d = RC.make_corpus("genome", 512, seed=i)
        if i % 4 == 0:  # plant the blocked pattern
            d = d.copy()
            d[100:107] = np.frombuffer(bad, np.uint8)
        docs.append(d)
    batches, stats = _same_run(docs, seq_len=128, batch_size=2, blocklist=[bad])
    assert (stats.docs_blocked, stats.docs_out) == (10, 30)
    for b in batches:
        assert b["tokens"].shape == (2, 128) and b["tokens"].max() <= P.BOS
        flat = b["tokens"].astype(np.uint8).reshape(-1)
        assert int(epsm.count(flat, np.frombuffer(bad, np.uint8), device=CPU)) == 0


def test_dedup_signatures_and_stats_equal():
    base = RC.make_corpus("english", 1024, seed=7)
    docs = [base, base.copy(), RC.make_corpus("english", 1024, seed=8), base[:1020].copy()]
    _, stats = _same_run(docs, seq_len=64, batch_size=1, dedup=True)
    assert stats.docs_deduped == 2
    ours, ref = P.FingerprintDeduper(), RP.FingerprintDeduper()
    for d in docs + [base[:7], RC.make_corpus("genome", 333, seed=1)]:
        assert ours.signature(d) == ref.signature(d)
        assert ours.is_duplicate(d) == ref.is_duplicate(d)


def test_fuzzy_blocklist_k1():
    rng = np.random.RandomState(0xF022)
    bad = b"forbiddenterm"
    docs = [rng.randint(97, 123, size=2000).astype(np.uint8) for _ in range(6)]
    corrupted = np.frombuffer(bad, np.uint8).copy()
    corrupted[5] ^= 2
    for i in (1, 4):
        docs[i][300 : 300 + len(bad)] = corrupted
    blocked = {}
    for k in (0, 1):
        _, stats = _same_run(docs, seq_len=64, batch_size=2, blocklist=[bad], blocklist_k=k)
        blocked[k] = stats.docs_blocked
    assert blocked == {0: 0, 1: 2}


def test_oversize_documents_stream(monkeypatch):
    rng = np.random.RandomState(0x0B16)
    monkeypatch.setattr(RP, "MAX_FILTER_LEN", 512)
    monkeypatch.setattr(P, "MAX_FILTER_LEN", 512)
    bad = b"\x07\x01\x07\x02\x07\x03"
    clean_big = rng.randint(0, 4, size=4_000).astype(np.uint8)
    dirty_big = rng.randint(0, 4, size=4_000).astype(np.uint8)
    dirty_big[2_345 : 2_345 + len(bad)] = np.frombuffer(bad, np.uint8)
    small = rng.randint(0, 4, size=100).astype(np.uint8)
    _, stats = _same_run([clean_big, dirty_big, small], seq_len=64, batch_size=1,
                         blocklist=[bad, b"\x06\x06\x06\x06\x06\x06\x06\x06"])
    assert (stats.docs_in, stats.docs_blocked, stats.docs_out) == (3, 1, 2)


def test_one_document_over_max_filter_len():
    """A real oversize document (> MAX_FILTER_LEN = 256 KiB) among small
    ones, with a mixed-length blocklist ('a', 'b' and 'c' groups) and dedup:
    three filter batches, the middle one ragged."""
    english = RC.make_corpus("english", 700_000, seed=3)
    big = english[: P.MAX_FILTER_LEN + 4097].copy()
    rs = np.random.RandomState(11)
    docs = []
    for i in range(70):
        at = int(rs.randint(0, len(english) - 3000))
        docs.append(english[at : at + int(rs.randint(1, 3000))].copy())
    docs.insert(33, big)
    docs.append(docs[5].copy())  # a duplicate
    blocklist = [b"qz", b"zebra!", b"the ", b"longer than sixteen bytes", b"xx. xx"]
    big[200_000 : 200_000 + 25] = np.frombuffer(b"longer than sixteen bytes", np.uint8)
    _, stats = _same_run(docs, seq_len=256, batch_size=4, blocklist=blocklist[:1] + blocklist[3:],
                         dedup=True)
    assert stats.docs_in == 72 and stats.docs_blocked >= 1
    _, stats = _same_run(docs, seq_len=256, batch_size=4, blocklist=blocklist, dedup=True)
    assert stats.docs_blocked > 1


def test_no_blocklist_passes_everything_and_packs():
    docs = list(RC.documents("english", 10, doc_len=300, seed=2))
    batches, stats = _same_run(docs, seq_len=50, batch_size=3)
    assert stats == P.PipelineStats(10, 0, 0, 10)
    flat = np.concatenate([np.concatenate([[P.BOS], d]) for d in docs])
    need = 3 * 51
    for i, b in enumerate(batches):
        rows = flat[i * need : (i + 1) * need].reshape(3, 51)
        np.testing.assert_array_equal(b["tokens"], rows[:, :-1])
        np.testing.assert_array_equal(b["targets"], rows[:, 1:])
    assert len(batches) == len(flat) // need


def test_pipeline_device_rule(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.LMDataPipeline([], seq_len=4, batch_size=1)
    assert list(P.LMDataPipeline([], seq_len=4, batch_size=1, device=CPU)) == []
