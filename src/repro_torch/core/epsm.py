"""EPSM — Exact Packed String Matching (Faro & Kulekci, 2012) in PyTorch.

The PyTorch twin of ``repro.core.epsm``.  The paper dispatches on pattern
length m:

  * EPSMa (0 < m < 4):   per-character compare + shifted AND;
  * EPSMb (4 <= m < 16): packed 4-gram anchor compare + verification;
  * EPSMc (m >= 16):     8-byte block fingerprint filter at stride
                         (floor(m/8)-1)*8, then verification.

Every function returns ``mask: bool[n]`` with mask[i] True iff an occurrence
of ``pattern`` starts at text position i.  On a CUDA tensor each algorithm
launches its hand-written kernel (``repro_torch.kernels.<algo>``); on a CPU
tensor it runs that kernel's plain PyTorch version.  Host inputs go to the
card unless ``device="cpu"`` is passed (``packing.resolve_device``).
``k > 0`` (k-mismatch search) goes through the engine's approximate routes
(``repro_torch.approx``), and ``stream`` through ``core/stream.py``.

The kernels are imported inside the functions: they take ``EPSMC_BETA`` and
``_epsmc_stride`` from this module, and importing this module needs no
compiler.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.packing import PACK, as_u8

# Paper regime thresholds (Section 3).
EPSMA_MAX = 4
EPSMB_MAX = 16
# EPSMc fingerprint block width: the paper's crc32 on an 8-byte block.
# Must satisfy m >= 2*beta.
EPSMC_BETA = 8
EPSMC_KBITS = 11  # paper: k = 11


def _to_tensors(text, pattern, device=None):
    t = as_u8(text, device)
    p = as_u8(pattern, t.device)
    if p.ndim != 1 or t.ndim != 1:
        raise ValueError("text and pattern must be 1-D byte arrays")
    return t, p


def epsma(text, pattern, *, device=None) -> torch.Tensor:
    """Shifted-AND of per-character equality masks (paper Fig. 1, top)."""
    t, p = _to_tensors(text, pattern, device)
    from repro_torch.kernels.epsma import ops

    return ops.epsma(t, p)


def epsmb(text, pattern, *, device=None) -> torch.Tensor:
    """Packed 4-gram anchor filter + verification (paper Fig. 1, middle)."""
    t, p = _to_tensors(text, pattern, device)
    if p.shape[0] < PACK:
        return epsma(t, p)
    from repro_torch.kernels.epsmb import ops

    return ops.epsmb(t, p)


def _epsmc_stride(m: int, beta: int) -> int:
    """Inspected-block stride in characters: (floor(m/beta) - 1) * beta.

    Every occurrence window [x, x+m) contains an inspected aligned block whose
    start lies in [x, x+m-beta].  Requires m >= 2*beta.
    """
    q = m // beta
    return max(1, q - 1) * beta


def epsmc(text, pattern, *, device=None) -> torch.Tensor:
    """Strided block fingerprint filter + verification (paper Fig. 1, bottom).

    Fixed at beta = EPSMC_BETA and kbits = EPSMC_KBITS, the values the kernel
    is built for.
    """
    t, p = _to_tensors(text, pattern, device)
    if p.shape[0] < 2 * EPSMC_BETA:
        return epsmb(t, p)
    from repro_torch.kernels.epsmc import ops

    return ops.epsmc(t, p)


# ---------------------------------------------------------------------------
# Dispatcher (paper Section 3: EPSMa m<4, EPSMb 4<=m<16, EPSMc m>=16)
# ---------------------------------------------------------------------------

_ALGOS = {
    "epsma": epsma,
    "epsmb": epsmb,
    "epsmc": epsmc,
}


def select_algo(m: int) -> str:
    """Paper-faithful regime thresholds."""
    if m < EPSMA_MAX:
        return "epsma"
    if m < EPSMB_MAX:
        return "epsmb"
    return "epsmc"


# The reference's measured crossover; to be re-measured on the card.
TUNED_EPSMC_MIN = 16


def select_algo_tuned(m: int) -> str:
    if m < EPSMA_MAX:
        return "epsma"
    if m < TUNED_EPSMC_MIN:
        return "epsmb"
    return "epsmc"


# Host inputs at least this long stream under algo="auto" in the reference;
# device tensors never auto-stream.
STREAM_AUTO_BYTES = 1 << 26


def _host_bytes(text) -> int:
    """Length of a HOST-side text (0 for tensors: never auto-stream)."""
    if isinstance(text, (bytes, bytearray, memoryview, str)):
        return len(text)
    if isinstance(text, np.ndarray):
        return text.size
    return 0


def _streams(text, algo: str, stream: Optional[bool]) -> bool:
    """``stream``, or under None the auto rule: host texts of
    STREAM_AUTO_BYTES or more stream under the default regime dispatch."""
    if stream is None:
        return algo == "auto" and _host_bytes(text) >= STREAM_AUTO_BYTES
    return bool(stream)


def find(text, pattern, *, algo: str = "auto", k: int = 0,
         stream: Optional[bool] = None, device=None):
    """Match-start mask for all occurrences of pattern in text.

    Same contract as ``repro.core.epsm.find``; ``device`` places host inputs
    (default: the card).  ``k`` is a Hamming mismatch budget: k > 0 reports
    every position whose m-byte window differs from the pattern in at most
    k bytes (``algo`` is ignored).  ``stream`` scans the text chunk by chunk
    in O(chunk) device memory and returns a HOST numpy bool mask (``algo``
    is ignored); None streams host texts of STREAM_AUTO_BYTES or more under
    ``algo="auto"`` only.  Results are identical to the resident scan.
    """
    if _streams(text, algo, stream):
        from repro_torch.core.stream import find_stream

        return find_stream(text, pattern, k=k, device=device)
    t, p = _to_tensors(text, pattern, device)
    m = p.shape[0]
    if m == 0:
        raise ValueError("empty pattern")
    if k:
        from repro_torch.approx import find_kmismatch

        return find_kmismatch(t, p, k)
    if algo == "auto":
        name = select_algo(m)
    elif algo == "tuned":
        name = select_algo_tuned(m)
    else:
        name = algo
    if name not in _ALGOS:
        raise ValueError(
            f"unknown algo {name!r}; choose from {sorted(_ALGOS)} or auto/tuned"
        )
    return _ALGOS[name](t, p)


def count(text, pattern, *, algo: str = "auto", k: int = 0,
          stream: Optional[bool] = None, device=None):
    """Occurrence count: a 0-d int32 tensor on the text's device, as the
    reference's ``count`` returns; with ``stream`` a numpy int32 from the
    streaming counts, which never materialize a whole-text mask."""
    if _streams(text, algo, stream):
        from repro_torch.core.stream import stream_count

        return stream_count(text, [pattern], k=k, device=device)[0]
    mask = find(text, pattern, algo=algo, k=k, stream=False, device=device)
    return mask.sum(dtype=torch.int32)


def positions(text, pattern, *, algo: str = "auto", k: int = 0,
              stream: Optional[bool] = None, device=None) -> np.ndarray:
    """Occurrence start positions as a host int64 array (forces a sync)."""
    mask = find(text, pattern, algo=algo, k=k, stream=stream, device=device)
    if isinstance(mask, np.ndarray):  # the streaming path's host mask
        return np.nonzero(mask)[0]
    return torch.nonzero(mask).flatten().cpu().numpy()
