"""Core EPSM library in PyTorch: the parts of ``repro.core`` ported so far.

Ported: ``packing``, the single-pattern EPSM path (``epsm``), the shared-text
batched engine (``engine``, k-mismatch routes and the dictionary-scale
automaton route included), the packed Aho-Corasick automaton
(``automaton``), the multi-pattern API over the engine (``multipattern``),
the bounded-memory streaming scan (``stream``), sharded streaming
(``shard_stream``, ``distributed``, ``remote_source``) and the paper's
baselines (``baselines``).
"""

from repro_torch.core.epsm import (
    EPSMA_MAX,
    EPSMB_MAX,
    EPSMC_BETA,
    EPSMC_KBITS,
    count,
    epsma,
    epsmb,
    epsmc,
    find,
    positions,
    select_algo,
    select_algo_tuned,
)
from repro_torch.core.engine import (
    FingerprintBank,
    PatternPlan,
    TextIndex,
    any_many,
    build_index,
    compile_patterns,
    count_many,
    match_many,
)
from repro_torch.core.multipattern import PatternSet, contains_any, count_multi, find_multi
from repro_torch.core.stream import (
    Compressed,
    StreamScanner,
    auto_chunk_bytes,
    find_stream,
    stream_count,
)
from repro_torch.core.shard_stream import (
    PartialScanResult,
    ShardedStreamScanner,
    StealEvent,
    shard_stream_count,
)
from repro_torch.core.remote_source import FakeObjectStore, RemoteRangeReader
from repro_torch.core.baselines import BASELINES, naive_np

__all__ = [
    "BASELINES",
    "Compressed",
    "EPSMA_MAX",
    "EPSMB_MAX",
    "EPSMC_BETA",
    "EPSMC_KBITS",
    "FakeObjectStore",
    "FingerprintBank",
    "PartialScanResult",
    "PatternPlan",
    "PatternSet",
    "RemoteRangeReader",
    "ShardedStreamScanner",
    "StealEvent",
    "StreamScanner",
    "TextIndex",
    "any_many",
    "auto_chunk_bytes",
    "build_index",
    "compile_patterns",
    "contains_any",
    "count",
    "count_many",
    "count_multi",
    "epsma",
    "epsmb",
    "epsmc",
    "find",
    "find_multi",
    "find_stream",
    "match_many",
    "naive_np",
    "positions",
    "select_algo",
    "select_algo_tuned",
    "shard_stream_count",
    "stream_count",
]
