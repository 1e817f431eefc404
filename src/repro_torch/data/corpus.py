"""Synthetic corpora mirroring the paper's three benchmark texts
(Section 4: a genome sequence, a protein sequence, a natural-language text,
4MB each, from the SMART tool).  Deterministic given a seed.

A copy of ``repro.data.corpus`` that gives the same bytes for the same seed;
``english`` draws its random numbers in bulk instead of one word at a time.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

GENOME_ALPHABET = b"ACGT"
PROTEIN_ALPHABET = b"ACDEFGHIKLMNPQRSTVWY"

# a small Zipf-weighted lexicon for english-like text
_WORDS = (
    "the of and to a in that is was he for it with as his on be at by i this "
    "had not are but from or have an they which one you were her all she "
    "there would their we him been has when who will more no if out so said "
    "what up its about into than them can only other new some could time "
    "these two may then do first any my now such like our over man me even "
    "most made after also did many before must through back years where much "
    "your way well down should because each just those people mr how too "
    "little state good very make world still own see men work long get here "
    "between both life being under never day same another know while last "
    "might us great old year off come since against go came right used take "
    "three states himself few house use during without again place american "
    "around however home small found mrs thought went say part once general "
    "high upon school every don does got united left number course war "
    "until always away something fact though water less public put think "
    "almost hand enough far took head yet government system better set told "
    "nothing night end why called didn eyes find going look asked later "
    "knew point next program city business give group toward young days let "
    "room within children side social given order often national"
).split()


def genome(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    alpha = np.frombuffer(GENOME_ALPHABET, dtype=np.uint8)
    return alpha[rng.randint(0, len(alpha), size=n)]


def protein(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    alpha = np.frombuffer(PROTEIN_ALPHABET, dtype=np.uint8)
    return alpha[rng.randint(0, len(alpha), size=n)]


def english(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, len(_WORDS) + 1, dtype=np.float64)
    probs = (1.0 / ranks) / (1.0 / ranks).sum()  # Zipf
    # RandomState.choice(p=...) draws one uniform and searches the cdf; each
    # word is followed by one rand() for its separator.  Every piece is at
    # least 2 bytes, so n // 2 + 1 pieces reach n bytes.
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    u = rng.random_sample(2 * (n // 2 + 1))
    words = cdf.searchsorted(u[0::2], side="right")
    seps = u[1::2] > 0.12
    pieces = [w.encode() + sep for w in _WORDS for sep in (b". ", b" ")]
    out = b"".join([pieces[2 * w + s] for w, s in zip(words.tolist(), seps.tolist())])
    return np.frombuffer(out[:n], dtype=np.uint8)


CORPORA = {"genome": genome, "protein": protein, "english": english}


def make_corpus(name: str, n: int, seed: int = 0) -> np.ndarray:
    return CORPORA[name](n, seed)


def documents(
    name: str, n_docs: int, doc_len: int = 2048, seed: int = 0
) -> Iterator[np.ndarray]:
    """Stream of documents (uint8 arrays) from one corpus family."""
    for i in range(n_docs):
        yield make_corpus(name, doc_len, seed=seed * 100003 + i)


def pattern_starts(n: int, m: int, count: int, seed: int = 0) -> np.ndarray:
    """Start positions in an n-byte text of the patterns ``extract_patterns``
    takes with the same arguments."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, n - m + 1, size=count)


def extract_patterns(text: np.ndarray, m: int, count: int, seed: int = 0) -> np.ndarray:
    """Random pattern set extracted from the text (the paper's methodology:
    'sets of patterns of fixed length m randomly extracted from the text')."""
    starts = pattern_starts(len(text), m, count, seed)
    return np.stack([text[s : s + m] for s in starts])
