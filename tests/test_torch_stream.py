"""repro_torch.core.stream against repro.core.stream, bit for bit.

Mirrors tests/test_stream.py: seam equivalence at random chunk boundaries
(counts and positions, k in {0, 1}), occurrences straddling a seam at every
phase, the fused step against the two-pass one, one dispatch per chunk (the
shared EPSMb pass included), auto chunk sizing, bytes / file / iterable /
tensor sources, empty and short sources, gzip (and zstd where installed),
mid-stream prefix/start injection, stream_count order, find_stream, the epsm
stream hatch, PatternSet.contains_any_stream, the watchdog (a small stub)
and the recorder spans.  The port runs on the CPU; the reference side runs
its StreamScanner(use_kernel=False) and its jitted engine.  No tolerance.
"""

import gzip
import io

import numpy as np
import pytest
import torch

from repro.core import engine as R, epsm as Repsm, multipattern as Rmp
from repro.core import stream as RS
from repro_torch.core import engine as E, epsm as Pepsm, multipattern as Pmp
from repro_torch.core import stream as S
from repro_torch.core.stream import Compressed, StreamScanner, find_stream, stream_count
from repro_torch.obs.recorder import Recorder

from conftest import make_text

CPU = "cpu"
LENGTHS = (2, 4, 8, 13, 16, 32)
CHUNKS = (96, 251, 1000)


@pytest.fixture
def rng():
    """A fresh generator per test, so no test's data depends on which tests
    ran before it in the same process."""
    return np.random.RandomState(0x57E4)


def _patterns(rng, text):
    """One extracted (guaranteed-hit) pattern per length, plus one random."""
    pats = []
    for m in LENGTHS:
        s = rng.randint(0, len(text) - m + 1)
        pats.append(text[s : s + m].copy())
        pats.append(rng.randint(0, 5, size=m).astype(np.uint8))
    return pats


def _plans(pats, **kw):
    return E.compile_patterns(pats, device=CPU, **kw)


def _occurrences(text, pat) -> int:
    """numpy sliding-window count of pat in text."""
    pat = np.frombuffer(pat, np.uint8) if isinstance(pat, bytes) else np.asarray(pat)
    if len(pat) > len(text):
        return 0
    return int((np.lib.stride_tricks.sliding_window_view(text, len(pat)) == pat).all(-1).sum())


@pytest.mark.parametrize("k", [0, 1])
def test_seam_equivalence_random_boundaries(rng, k):
    """Random texts split at random chunk boundaries: streaming counts and
    positions equal the whole-text resident engine — the reference's jitted
    one and its scanner in the first trial, the port's in the others."""
    for trial in range(3):
        n = int(rng.randint(400, 3000))
        text = make_text(rng, n, 4)
        pats = _patterns(rng, text)
        rp = R.compile_patterns(pats, k=k)
        pp = _plans(pats, k=k)
        if trial == 0:
            idx = R.build_index(text)
            want_counts = np.asarray(R.count_many_jit(idx, rp, k=k))[0]
            want_mask = np.asarray(R.match_many_jit(idx, rp, k=k))[0]
        else:
            idx = E.build_index(text, device=CPU)
            want_counts = E.count_many(idx, pp, k=k)[0].numpy()
            want_mask = E.match_many(idx, pp, k=k)[0].numpy()
        chunk = CHUNKS[trial]
        got = StreamScanner(pp, chunk, k=k).count_many(text)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want_counts, err_msg=f"k={k} chunk={chunk} n={n}")
        pos = StreamScanner(pp, chunk, k=k).positions_many(text)
        for p_i in range(len(pos)):
            np.testing.assert_array_equal(pos[p_i], np.nonzero(want_mask[p_i])[0])
        if trial == 0:
            np.testing.assert_array_equal(got, RS.StreamScanner(rp, chunk, k=k).count_many(text))


def test_seam_occurrence_straddles_every_phase():
    """Occurrences crossing a seam at every straddle phase, and one inside the
    short final chunk, are found exactly once."""
    for m in (2, 4, 8, 13, 16, 32):
        pat = np.full(m, 9, np.uint8)  # alphabet disjoint from the text
        plans = _plans([pat])
        step = StreamScanner(plans, 256).step_bytes
        text = make_text(np.random.RandomState(m), 3 * step + 11, 4)
        starts = [step - m + 1 + j for j in range(m + 1) if step - m + 1 + j >= 0] + [2 * step + 5]
        planted, last_end = [], -1
        for s in sorted({s for s in starts if 0 <= s <= len(text) - m}):
            if s > last_end:  # a gap between plants: no extra run occurrences
                text[s : s + m] = pat
                planted.append(s)
                last_end = s + m
        assert StreamScanner(plans, 256).count_many(text).tolist() == [len(planted)], f"m={m}"
        pos = StreamScanner(plans, 256).positions_many(text)
        np.testing.assert_array_equal(pos[0], np.asarray(planted), f"m={m}")


@pytest.mark.parametrize("k", [0, 1])
def test_fused_seam_equals_two_pass(rng, k):
    """The fused chunk step (end_min) equals the two-pass overlap-prefix
    subtraction, counts and positions, and both equal the reference's."""
    for trial in range(2):
        n = int(rng.randint(400, 3000))
        text = make_text(rng, n, 4)
        pats = _patterns(rng, text)
        plans = _plans(pats, k=k)
        chunk = CHUNKS[trial]
        want = StreamScanner(plans, chunk, k=k, fused=False).count_many(text)
        np.testing.assert_array_equal(StreamScanner(plans, chunk, k=k).count_many(text), want)
        pos_ref = StreamScanner(plans, chunk, k=k, fused=False).positions_many(text)
        pos_fused = StreamScanner(plans, chunk, k=k).positions_many(text)
        for r in range(len(pos_ref)):
            np.testing.assert_array_equal(pos_fused[r], pos_ref[r])
        if trial == 0:
            rp = R.compile_patterns(pats, k=k)
            np.testing.assert_array_equal(want, RS.StreamScanner(rp, chunk, k=k, fused=False).count_many(text))


def test_mixed_plans_one_dispatch_per_chunk_shared_path(rng, monkeypatch):
    """A mixed plan set with one sparse-eligible EPSMb group counts through
    the shared pass, one scan per chunk, equal to per-pattern counts."""
    monkeypatch.setattr(E, "SPARSE_B_MIN_ELEMS", 0)
    text = make_text(rng, 6_000, 4)
    pats = [text[7:9].copy(), text[100:108].copy(), text[200:208].copy(), text[400:408].copy(),
            text[900:908].copy(), text[300:324].copy()]
    plans = _plans(pats)
    calls = []
    orig = E._count_groups_b_shared

    def spy(index, plans_, bank, end_min=None):
        calls.append(len(plans_))
        return orig(index, plans_, bank, end_min)

    monkeypatch.setattr(E, "_count_groups_b_shared", spy)
    sc = StreamScanner(plans, 1024)
    n_windows = sum(1 for _ in sc._windows(text))
    got = sc.count_many(text)
    assert sc.dispatch_count == n_windows and calls == [1] * n_windows
    for row, pid in enumerate(sc.order):
        assert got[row] == _occurrences(text, pats[pid]), f"pattern {pid}"


def test_auto_chunk_bytes_resolved_and_exact(rng):
    """chunk_bytes="auto" resolves to a beta-aligned size within bounds (a
    fixed 512 MiB budget and the dispatch probe on the CPU), is recorded on
    the scanner and logged, and scans exactly."""
    for name in ("DEFAULT_CHUNK_BYTES", "MIN_CHUNK_BYTES", "MAX_CHUNK_BYTES"):
        assert getattr(S, name) == getattr(RS, name)
    auto = S.auto_chunk_bytes(device=CPU)
    assert S.MIN_CHUNK_BYTES <= auto <= S.MAX_CHUNK_BYTES and auto % 8 == 0
    assert S._dispatch_overhead_s(CPU) > 0
    text = make_text(rng, 5_000, 4)
    plans = _plans([text[100:108].copy()])
    rec = Recorder(enabled=True)
    sc = StreamScanner(plans, recorder=rec)  # default chunk_bytes="auto"
    assert sc.chunk_bytes == auto and rec.events_named("auto_chunk")[0]["chunk_bytes"] == auto
    np.testing.assert_array_equal(sc.count_many(text), StreamScanner(plans, 512).count_many(text))
    if not torch.cuda.is_available():  # no card and no device asked for: raise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.auto_chunk_bytes()


def test_one_dispatch_per_chunk_and_bounded_window(rng):
    """One scan per chunk; window and working set O(chunk), equal to the
    reference's accounting."""
    text = make_text(rng, 10_000, 4)
    pats = [text[50:58].copy(), text[300:316].copy()]
    sc = StreamScanner(_plans(pats, k=1), 1024)
    n_windows = sum(1 for _ in sc._windows(text))
    sc.count_many(text)
    assert sc.dispatch_count == n_windows
    assert sc.window_bytes < 2 * 1024 + sc.overlap + 8
    ref = RS.StreamScanner(R.compile_patterns(pats, k=1), 1024)
    assert (sc.window_bytes, sc.overlap, sc.step_bytes) == (ref.window_bytes, ref.overlap, ref.step_bytes)
    assert sc.device_bytes_per_chunk == ref.device_bytes_per_chunk


def test_windows_reuse_a_ring_zeroed_past_length(rng):
    """Windows are assembled in a ring of three host buffers, each zero past
    its valid length."""
    text = make_text(rng, 2_500, 4) + 1
    sc = StreamScanner(_plans([b"\x01\x02\x03"]), 1000)
    seen = []
    for win, L, carry, base in sc._windows(text):
        assert not win[L:].any() and (win[:L] == text[base : base + L]).all()
        seen.append(id(win))
    assert len(seen) == 3 and len(set(seen)) == 3
    assert [id(w) for w, *_ in sc._windows(text[:10])] == [seen[0]]  # round-robin continues
    assert sc._ring.bufs[0].is_pinned() is False


def test_sources_bytes_file_iterable_tensor_agree(rng):
    text = make_text(rng, 5_000, 4)
    sc = StreamScanner(_plans([text[100:108].copy()]), 512)
    want = sc.count_many(text)
    ragged = np.array_split(text, [1, 7, 8, 1000, 1001, 4000])
    for src in (text.tobytes(), io.BytesIO(text.tobytes()), iter(ragged), torch.from_numpy(text),
                bytearray(text.tobytes())):
        np.testing.assert_array_equal(sc.count_many(src), want)


def test_empty_and_short_sources():
    plans = _plans([np.arange(8, dtype=np.uint8)])
    sc = StreamScanner(plans, 256)
    assert sc.count_many(b"").tolist() == [0]
    assert sc.dispatch_count == 0  # no chunk, no dispatch
    short = np.arange(8, dtype=np.uint8)
    assert StreamScanner(plans, 256).count_many(short).tolist() == [1]
    assert StreamScanner(plans, 256).count_many(short[:5]).tolist() == [0]
    assert [len(p) for p in StreamScanner(plans, 256).positions_many(b"")] == [0]
    with pytest.raises(ValueError):
        StreamScanner([], 256)


def test_gzip_sources_stream_exactly(rng):
    """gzip bytes, multi-member blobs, file-likes and frame iterators agree
    with the plain scan, occurrences straddling member boundaries included;
    a truncated stream raises; a short first piece still sniffs."""
    text = make_text(rng, 30_000, 4)
    m = 8
    pat = np.full(m, 9, np.uint8)
    cuts = [5_000, 12_344, 20_008]
    for cut in cuts:
        text[cut - m // 2 : cut - m // 2 + m] = pat
    plans = _plans([pat, text[100:108].copy()])
    want = StreamScanner(plans, 1024).count_many(text)
    assert want[0] >= len(cuts)
    members = np.split(text, cuts)
    blob_one = gzip.compress(text.tobytes())
    blob_multi = b"".join(gzip.compress(c.tobytes()) for c in members)
    frames = [gzip.compress(c.tobytes()) for c in members]
    for src in (Compressed(blob_one), Compressed(blob_multi), Compressed(io.BytesIO(blob_multi)),
                Compressed(iter(frames), codec="gzip"),
                Compressed(iter([blob_one[:2], blob_one[2:3], blob_one[3:]]))):
        np.testing.assert_array_equal(StreamScanner(plans, 1024).count_many(src), want)
    pos = StreamScanner(plans, 1024).positions_many(Compressed(blob_multi))
    want_pos = StreamScanner(plans, 1024).positions_many(text)
    for r in range(len(pos)):
        np.testing.assert_array_equal(pos[r], want_pos[r])
    with pytest.raises(ValueError, match="truncated"):
        StreamScanner(plans, 1024).count_many(Compressed(blob_one[:-20]))
    with pytest.raises(ValueError):
        Compressed(blob_one, codec="bz2")
    # the reference decompresses the same frames to the same counts
    rp = R.compile_patterns([pat, text[100:108].copy()])
    np.testing.assert_array_equal(RS.StreamScanner(rp, 1024).count_many(RS.Compressed(blob_multi)), want)


def test_zstd_sources_stream_or_name_the_missing_package(rng):
    """zstd frames stream exactly where `zstandard` is installed; where it is
    not, opening one raises the same RuntimeError as the reference."""
    text = make_text(rng, 20_000, 4)
    plans = _plans([text[100:108].copy()])
    try:
        import zstandard
    except ImportError:
        blob = b"\x28\xb5\x2f\xfd" + bytes(16)
        for mod, pl in ((S, plans), (RS, R.compile_patterns([text[100:108].copy()]))):
            with pytest.raises(RuntimeError, match="zstandard"):
                mod.StreamScanner(pl, 1024).count_many(mod.Compressed(blob))
        return
    want = StreamScanner(plans, 1024).count_many(text)
    blob = b"".join(zstandard.ZstdCompressor().compress(c.tobytes()) for c in np.array_split(text, 4))
    np.testing.assert_array_equal(StreamScanner(plans, 1024).count_many(Compressed(blob)), want)


def test_mid_stream_prefix_start_injection(rng):
    """Scanning [0, p) and [p, n) separately (the second with the carried
    prefix and start offset) composes to the whole-text result."""
    text = make_text(rng, 9_000, 4)
    plans = _plans([text[70:78].copy(), text[10:42].copy()])
    sc = StreamScanner(plans, 1024)
    ov = sc.overlap
    whole = sc.count_many(text)
    whole_pos = StreamScanner(plans, 1024).positions_many(text)
    for p in (1024, 2048, 4096):
        left = StreamScanner(plans, 1024).count_many(text[:p])
        right = StreamScanner(plans, 1024).count_many(text[p:], prefix=text[p - ov : p], start=p)
        np.testing.assert_array_equal(left + right, whole, err_msg=f"p={p}")
        pos_l = StreamScanner(plans, 1024).positions_many(text[:p])
        pos_r = StreamScanner(plans, 1024).positions_many(text[p:], prefix=text[p - ov : p], start=p)
        for r in range(len(pos_l)):
            np.testing.assert_array_equal(np.concatenate([pos_l[r], pos_r[r]]), whole_pos[r])
    with pytest.raises(ValueError):  # start - len(prefix) off the beta grid
        StreamScanner(plans, 1024).count_many(text[5:], prefix=text[1:5], start=5)
    with pytest.raises(ValueError):  # prefix longer than the overlap
        StreamScanner(plans, 1024).count_many(text[ov + 8 :], prefix=text[: ov + 8], start=ov + 8)


def test_stream_count_original_order_and_find_stream(rng):
    text = make_text(rng, 20_000, 4)
    pats = [text[70:102].copy(), text[10:12].copy(), text[500:508].copy()]
    got = stream_count(text, pats, chunk_bytes=777, device=CPU)
    np.testing.assert_array_equal(got, RS.stream_count(text, pats, chunk_bytes=777))
    assert got.tolist() == [_occurrences(text, p) for p in pats]
    mask = find_stream(text, pats[2], chunk_bytes=777, device=CPU)
    assert isinstance(mask, np.ndarray) and mask.dtype == bool
    np.testing.assert_array_equal(mask, np.asarray(RS.find_stream(text, pats[2], chunk_bytes=777)))
    assert mask.sum() == got[2]
    np.testing.assert_array_equal(find_stream(text, pats[2], k=1, chunk_bytes=777, device=CPU),
                                  Pepsm.find(text, pats[2], k=1, device=CPU).numpy())


def test_epsm_stream_escape_hatch(rng, monkeypatch):
    """find/count/positions with stream=True (and the auto threshold) equal
    the resident scan and the reference's."""
    text = make_text(rng, 9_000, 4)
    pat = text[123:131].copy()
    want_mask = np.asarray(Repsm.find(text, pat))
    np.testing.assert_array_equal(Pepsm.find(text, pat, stream=True, device=CPU), want_mask)
    assert int(Pepsm.count(text, pat, stream=True, device=CPU)) == int(np.asarray(Repsm.count(text, pat)))
    assert int(Pepsm.count(text, pat, k=1, stream=True, device=CPU)) == int(
        np.asarray(Repsm.count(text, pat, k=1)))
    monkeypatch.setattr(Pepsm, "STREAM_AUTO_BYTES", 1024)
    auto = Pepsm.find(text, pat, device=CPU)
    assert isinstance(auto, np.ndarray)  # host mask: the streaming path ran
    np.testing.assert_array_equal(auto, want_mask)
    np.testing.assert_array_equal(Pepsm.positions(text, pat, device=CPU), np.nonzero(want_mask)[0])
    # an explicit algo, or a tensor, runs resident
    assert isinstance(Pepsm.find(text, pat, algo="epsmb", device=CPU), torch.Tensor)
    assert isinstance(Pepsm.find(torch.from_numpy(text), pat), torch.Tensor)


def test_patternset_contains_any_stream(rng):
    """Bounded-memory verdicts with early exit, as the reference's, exact
    and k = 1; the scanner is cached per chunk size."""
    bad = b"\x07\x01\x07\x02\x07\x03"
    clean = make_text(rng, 40_000, 4)
    dirty = clean.copy()
    dirty[31_345 : 31_345 + len(bad)] = np.frombuffer(bad, np.uint8)
    typo = clean.copy()
    typo[2_000 : 2_000 + len(bad)] = np.frombuffer(bad, np.uint8)
    typo[2_002] = 5
    for k in (0, 1):
        got = Pmp.PatternSet([bad, b"\x06" * 8], k=k, device=CPU)
        want = Rmp.PatternSet([bad, b"\x06" * 8], k=k)
        for doc in (clean, dirty, typo):
            assert got.contains_any_stream(doc, chunk_bytes=1024) == want.contains_any_stream(doc, chunk_bytes=1024)
        assert got.contains_any_stream(iter([dirty[:20_000], dirty[20_000:]]), chunk_bytes=1024)
        assert len(got._scanners) == 1
    assert not Pmp.PatternSet([bad], device=CPU).contains_any_stream(typo, chunk_bytes=1024)
    # early exit: a hit in the first chunks stops before the source is drained
    early = clean.copy()
    early[: len(bad)] = np.frombuffer(bad, np.uint8)
    drained = []

    def source():
        for i in range(0, len(early), 512):
            drained.append(i)
            yield early[i : i + 512]

    assert Pmp.PatternSet([bad], device=CPU).contains_any_stream(source(), chunk_bytes=1024)
    assert len(drained) < len(range(0, len(early), 512))


def test_fault7_contains_any_stream_answers_where_megascan_refuses(rng, monkeypatch):
    """ROADMAP §3 fault 7: a set megascan cannot take (one 2056-byte EPSMc
    pattern) streams on the card with one acscan counts launch a window over
    the set's automaton, and gives the reference's verdict (equal): any
    occurrence of any pattern by the reference's oracle ``naive_np`` (the
    reference's own PatternSet takes ~160 s to compile a 2056-byte plan on a
    CPU; it answered True on such a text when the fault was recorded).  A
    spy builds each scanner as on the card (use_kernel=True, a recorder) and
    hands back a view whose device reads cuda while it counts here; the
    acscan op (the kernel on a CUDA tensor, its plain version here) must
    count every window, and the approx route none."""
    from repro.core.baselines import naive_np
    from repro_torch.approx import counting
    from repro_torch.kernels.acscan import ops as acscan_ops

    text = make_text(rng, 16_384, 4)
    pats = [text[1000:3056].copy(), text[50:58].copy()]
    absent = (make_text(rng, 16_384, 4) + 4).astype(np.uint8)  # bytes 4..7: no occurrence
    planted = absent.copy()
    planted[7_000 : 7_000 + 2056] = pats[0]  # across the first 8 KiB seam
    built, real = [], S.StreamScanner

    class OnCard:
        device = torch.device("cuda")

        def __init__(self, sc):
            self._sc = sc

        def __getattr__(self, name):
            return getattr(self._sc, name)

    def on_card(plans, chunk_bytes, **kw):
        rec = Recorder(enabled=True)
        sc = real(plans, chunk_bytes, use_kernel=True, recorder=rec, **kw)
        built.append((sc, rec))
        return OnCard(sc)

    calls = {"acscan": 0, "approx": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(S, "StreamScanner", on_card)
    monkeypatch.setattr(acscan_ops, "acscan_counts", spy("acscan", acscan_ops.acscan_counts))
    monkeypatch.setattr(counting, "match_group_approx",
                        spy("approx", counting.match_group_approx))
    got = Pmp.PatternSet(pats, device=CPU)
    docs = (text, absent, planted)
    verdicts = [got.contains_any_stream(doc, chunk_bytes=8192) for doc in docs]
    assert verdicts == [any(naive_np(doc, p).any() for p in pats) for doc in docs]
    assert verdicts == [True, False, True]
    (sc, rec), = built  # one scanner, cached for the chunk size
    assert sc.spec is None and rec.events_named("kernel_fallback")
    assert calls == {"acscan": sc.dispatch_count, "approx": 0} and sc.dispatch_count > 0


@pytest.mark.parametrize("variant", ["flat", "bucketed", "no_automaton", "mixed_k"])
def test_kernel_route_counts_as_the_fused_path(rng, monkeypatch, variant):
    """A set megascan refuses, scanned with use_kernel=True, counts each
    window on the acscan and approx ops (their plain versions here) and
    equals the fused PyTorch path (equal).  Every group holds more than 512
    patterns.  Variants: flat groups, a bucketed dictionary (CSR slots and
    the engine's own automaton), the automaton's caps refused (every exact
    group on the approx op at k = 0), and exact groups beside a k = 1
    group."""
    import repro_torch.core.automaton as A

    text = make_text(rng, 12_000, 4)
    pats = [text[s : s + m].copy() for m in (5, 9, 12) for s in rng.randint(0, 11_900, 600)]
    if variant == "bucketed":
        plans = E.compile_patterns(pats, bucket=True, automaton=True, device=CPU)
    else:
        plans = E.compile_patterns(pats, bucket=False, automaton=False, device=CPU)
        wide = [text[s : s + 32].copy() for s in range(0, 11_900, 22)]  # 541 patterns
        plans = E.compile_patterns(wide, bucket=False, automaton=False, device=CPU) + plans
    if variant == "mixed_k":
        plans = plans + E.compile_patterns([text[900:910].copy(), text[5:15].copy()], k=1,
                                           device=CPU)
    if variant == "no_automaton":
        monkeypatch.setattr(A, "compile_automaton", lambda *a, **kw: None)
    rec = Recorder(enabled=True)
    sc = StreamScanner(plans, 2048, use_kernel=True, recorder=rec)
    assert sc.spec is None and sc._kernel_steps and len(rec.events_named("kernel_fallback")) == 1
    assert (sc._auto is None) == (variant == "no_automaton")
    want = StreamScanner(plans, 2048, use_kernel=False).count_many(text)
    assert want.sum() > 0
    np.testing.assert_array_equal(sc.count_many(text), want)


@pytest.mark.parametrize("k", [0, 1])
def test_patternset_stream_plans_take_megascan(rng, k):
    """A dictionary-scale set (bucketed EPSMb and EPSMc groups, one group
    over MEGA_P_MAX) streams over plans megascan takes: flat groups of at
    most MEGA_P_MAX patterns whose ids map rows back to the input.  The
    verdicts equal the reference's, and megascan's plain version counts
    each pattern as the engine's own plans do."""
    from repro_torch.kernels.megascan.ops import MEGA_P_MAX, build_mega_spec

    pats = [rng.randint(0, 256, size=m).astype(np.uint8).tobytes()
            for m, n in ((6, MEGA_P_MAX + 40), (10, 130), (20, 130)) for _ in range(n)]
    clean = make_text(rng, 12_000, 4)
    docs = [clean]
    for i in (7, MEGA_P_MAX + 3, MEGA_P_MAX + 60, MEGA_P_MAX + 200):
        doc = clean.copy()
        doc[5_000 : 5_000 + len(pats[i])] = np.frombuffer(pats[i], np.uint8)
        if k:
            doc[5_001] ^= 1
        docs.append(doc)
    got = Pmp.PatternSet(pats, k=k, device=CPU)
    assert build_mega_spec(got.plans, k=k) is None
    want = Rmp.PatternSet(pats, k=k)
    verdicts = [got.contains_any_stream(doc, chunk_bytes=2048) for doc in docs]
    assert verdicts == [want.contains_any_stream(doc, chunk_bytes=2048) for doc in docs]
    assert verdicts == [False, True, True, True, True]
    plans = got._stream_plans
    assert build_mega_spec(plans, k=k) is not None
    assert max(p.n_patterns for p in plans) <= MEGA_P_MAX and len(plans) == 4
    for plan in plans:
        want_rows = np.stack([np.frombuffer(pats[i], np.uint8) for i in plan.ids])
        np.testing.assert_array_equal(plan.patterns.numpy(), want_rows)
    order, ref_order = E.plan_order(plans), E.plan_order(got.plans)
    for doc in docs[:2]:
        mega = StreamScanner(plans, 2048, k=k, use_kernel=True).count_many(doc)
        plain = StreamScanner(got.plans, 2048, k=k, use_kernel=False).count_many(doc)
        by_pattern = np.zeros(len(pats), np.int64)
        by_pattern[order] = mega
        np.testing.assert_array_equal(by_pattern[ref_order], plain)


class _StubWatchdog:
    """Flags the step whose host work took longer than ``limit_s``."""

    class Ev:
        def __init__(self, step, duration_s):
            self.step, self.duration_s, self.median_s, self.factor = step, duration_s, 0.0, 1.0

    def __init__(self, limit_s, raise_on_flag=False):
        self.limit_s, self.raise_on_flag, self.events = limit_s, raise_on_flag, []

    def start_step(self, step):
        import time

        self.step, self.t0 = step, time.perf_counter()

    def end_step(self):
        import time

        d = time.perf_counter() - self.t0
        if d <= self.limit_s:
            return None
        self.events.append(self.Ev(self.step, d))
        if self.raise_on_flag:
            raise RuntimeError("straggler")
        return self.events[-1]


def test_stream_watchdog_flags_stalled_chunk(rng):
    """A watchdog armed around each chunk's host step sees the stall; a
    raising one aborts the scan; a logging one reports to on_straggler and
    records an event without changing the counts."""
    import time

    text = make_text(rng, 40_000, 4)
    plans = _plans([text[100:108].copy()])
    want = StreamScanner(plans, 1024).count_many(text)

    def stalling():
        for i in range(0, len(text), 1024):
            if i == 20_480:
                time.sleep(0.2)
            yield text[i : i + 1024]

    with pytest.raises(RuntimeError, match="straggler"):
        StreamScanner(plans, 1024, watchdog=_StubWatchdog(0.1, True)).count_many(stalling())
    seen, rec = [], Recorder(enabled=True)
    wd = _StubWatchdog(0.1)
    got = StreamScanner(plans, 1024, watchdog=wd, on_straggler=seen.append, recorder=rec).count_many(stalling())
    np.testing.assert_array_equal(got, want)
    assert seen == wd.events and len(seen) == 1 and seen[0].duration_s > 0.1
    assert len(rec.events_named("straggler")) == 1


def test_recorder_spans_and_counters(rng):
    """An enabled recorder traces host_prep / device_put / dispatch per chunk
    and counts dispatches and bytes, masks included."""
    text = make_text(rng, 5_000, 4)
    plans = _plans([text[100:108].copy(), text[7:9].copy()])
    rec = Recorder(enabled=True, fence=True)
    sc = StreamScanner(plans, 1024, recorder=rec, lane="s0")
    sc.count_many(text)
    n = sc.dispatch_count
    spans = rec.summary()["spans"]
    # host_prep also times the last read, the one that finds the source drained
    assert spans["host_prep"]["count"] == n + 1 and spans["device_put"]["count"] == n
    assert spans["dispatch"]["count"] == n
    counters = rec.summary()["metrics"]["counters"]
    assert counters["dispatches"] == n and counters["bytes_scanned"] == len(text)
    list(sc.masks(text))
    assert rec.summary()["metrics"]["counters"]["dispatches"] == 2 * n
