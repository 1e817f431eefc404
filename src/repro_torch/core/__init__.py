"""Core EPSM library in PyTorch: the parts of ``repro.core`` ported so far.

Only the single-pattern EPSM path (``packing`` and ``epsm``) is ported; the
engine, streams and shards are still to come (ROADMAP.md queue 1).
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

__all__ = [
    "EPSMA_MAX",
    "EPSMB_MAX",
    "EPSMC_BETA",
    "EPSMC_KBITS",
    "count",
    "epsma",
    "epsmb",
    "epsmc",
    "find",
    "positions",
    "select_algo",
    "select_algo_tuned",
]
