"""Byte-level LM data pipeline with the paper's technique as a first-class
stage: EPSM multi-pattern blocklist filtering and fingerprint near-dup
detection run over every document before batching.

The port's copy of ``repro.data.pipeline``.  Documents -> [batched EPSM
blocklist filter] -> [fingerprint dedup] -> pack into fixed-length token
sequences -> (tokens, targets) batches.  Byte-level tokenization (vocab 256
+ BOS) keeps the pipeline self-contained.

The blocklist stage is batched on the device: documents are collected into
a padded (FILTER_BATCH, L) matrix (L bucketed to powers of two) and one
``PatternSet.blocked`` call verdicts the whole batch against every
blocklist pattern at once.  Padding rows carry their true lengths, so
patterns never match inside padding or across document boundaries.
Documents larger than MAX_FILTER_LEN stream through the bounded-memory
scanner (``PatternSet.contains_any_stream``, megascan on the card) instead
of inflating any batch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.epsm import EPSMC_KBITS
from repro_torch.core.multipattern import PatternSet
from repro_torch.core.packing import fingerprint_weights, resolve_device

# Constants copied from the reference (tests/test_torch_pipeline.py pins them).
BOS = 256  # byte-level vocab: 0..255 bytes + BOS
VOCAB = 257

# documents per blocklist dispatch; the last (ragged) batch is padded up to
# this so the filter sees one stable batch dimension
FILTER_BATCH = 32
# docs longer than this stream through the bounded-memory scanner: one giant
# document must not inflate the whole (B, L) batch matrix to B x its bucket
MAX_FILTER_LEN = 1 << 18


def _bucket_len(n: int, floor: int = 256) -> int:
    """Round a document length up to a power-of-two bucket (bounds the
    number of distinct (B, L) shapes the filter sees)."""
    L = floor
    while L < n:
        L *= 2
    return L


@dataclasses.dataclass
class PipelineStats:
    docs_in: int = 0
    docs_blocked: int = 0
    docs_deduped: int = 0
    docs_out: int = 0


class FingerprintDeduper:
    """Near-duplicate detection by EPSMc-style block fingerprints.

    A document's signature is the set of its k-bit aligned-block fingerprints
    (the same hash the matcher uses); documents sharing > threshold of their
    signature with a previously seen one are dropped.  Runs on the host.
    """

    def __init__(self, beta: int = 8, kbits: int = EPSMC_KBITS, threshold: float = 0.9):
        self.beta = beta
        self.kbits = kbits
        self.threshold = threshold
        # int32 bits of odd weights below 2^31: as uint32, then widened
        self.weights = fingerprint_weights(beta).numpy().view(np.uint32).astype(np.int64)
        self._seen: List[frozenset] = []

    def signature(self, doc: np.ndarray) -> frozenset:
        n = (len(doc) // self.beta) * self.beta
        if n == 0:
            return frozenset()
        blocks = doc[:n].reshape(-1, self.beta).astype(np.int64)
        h = (blocks * self.weights[None, :]).sum(axis=1)
        return frozenset((h & ((1 << self.kbits) - 1)).tolist())

    def is_duplicate(self, doc: np.ndarray) -> bool:
        sig = self.signature(doc)
        if not sig:
            return False
        for prev in self._seen:
            inter = len(sig & prev)
            if inter / max(len(sig), 1) > self.threshold:
                return True
        self._seen.append(sig)
        if len(self._seen) > 4096:  # bounded memory
            self._seen = self._seen[-2048:]
        return False


class LMDataPipeline:
    def __init__(
        self,
        documents: Iterable[np.ndarray],
        seq_len: int,
        batch_size: int,
        blocklist: Optional[Sequence[bytes]] = None,
        dedup: bool = False,
        seed: int = 0,
        blocklist_k: int = 0,
        *,
        device=None,
    ):
        """``blocklist_k`` is a Hamming mismatch budget: with k > 0 a
        document is dropped when any blocklist pattern occurs within <= k
        byte substitutions.  The batched verdict path is unchanged: the
        k-compiled PatternSet flows through the same single engine call per
        batch.  The filter runs on ``device`` (default: the card)."""
        self.device = resolve_device(device)
        self.documents = iter(documents)
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.pattern_set = (
            PatternSet(blocklist, k=blocklist_k, device=self.device) if blocklist else None
        )
        self.deduper = FingerprintDeduper() if dedup else None
        self.stats = PipelineStats()
        self._buffer = np.zeros(0, dtype=np.int32)
        # ONE persistent generator: _fill breaks out mid-iteration, and a
        # fresh generator per fill would drop the filtered docs still
        # buffered inside the suspended batch loop
        self._clean = self._clean_docs()

    def _filtered_batches(self) -> Iterator[List[np.ndarray]]:
        """Pull FILTER_BATCH docs, blocklist-filter them in ONE device call."""
        while True:
            docs: List[np.ndarray] = []
            for doc in self.documents:
                docs.append(np.asarray(doc, dtype=np.uint8).reshape(-1))
                if len(docs) >= FILTER_BATCH:
                    break
            if not docs:
                return
            self.stats.docs_in += len(docs)
            if self.pattern_set is None:
                yield docs
                continue
            small = [i for i, d in enumerate(docs) if len(d) <= MAX_FILTER_LEN]
            hit = np.zeros(len(docs), bool)
            if small:
                L = _bucket_len(max(len(docs[i]) for i in small))
                mat = np.zeros((FILTER_BATCH, L), np.uint8)
                lengths = np.zeros((FILTER_BATCH,), np.int32)
                for row, i in enumerate(small):
                    mat[row, : len(docs[i])] = docs[i]
                    lengths[row] = len(docs[i])
                verdict = self.pattern_set.blocked(mat, lengths).cpu().numpy()
                hit[small] = verdict[: len(small)]
            for i, d in enumerate(docs):
                if len(d) > MAX_FILTER_LEN:
                    # oversize: stream through the bounded-memory scanner —
                    # O(chunk) device memory and early exit on a hit
                    hit[i] = self.pattern_set.contains_any_stream(
                        d, chunk_bytes=MAX_FILTER_LEN
                    )
            kept = [d for d, h in zip(docs, hit) if not h]
            self.stats.docs_blocked += len(docs) - len(kept)
            yield kept

    def _clean_docs(self) -> Iterator[np.ndarray]:
        for batch in self._filtered_batches():
            for doc in batch:
                if self.deduper is not None and self.deduper.is_duplicate(doc):
                    self.stats.docs_deduped += 1
                    continue
                self.stats.docs_out += 1
                yield doc

    def _fill(self, need: int):
        chunks = [self._buffer]
        have = len(self._buffer)
        for doc in self._clean:
            tok = np.concatenate([[BOS], doc.astype(np.int32)])
            chunks.append(tok)
            have += len(tok)
            if have >= need:
                break
        self._buffer = np.concatenate(chunks) if chunks else self._buffer

    def __iter__(self):
        return self

    def __next__(self):
        need = self.batch_size * (self.seq_len + 1)
        if len(self._buffer) < need:
            self._fill(need)
        if len(self._buffer) < need:
            raise StopIteration
        flat = self._buffer[:need].reshape(self.batch_size, self.seq_len + 1)
        self._buffer = self._buffer[need:]
        return {
            "tokens": flat[:, :-1].astype(np.int32),
            "targets": flat[:, 1:].astype(np.int32),
        }
