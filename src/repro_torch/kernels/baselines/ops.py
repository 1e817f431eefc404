"""Public ops of the baselines' device loops: the CUDA kernel on the card,
its plain version on the CPU.  Each takes the text, the pattern, the host
table (a tensor on the text's device) and the segment width ``seg``."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.baselines.baselines import (
    bndm_cuda,
    hash3_cuda,
    kmp_dfa_cuda,
    shift_or_cuda,
)
from repro_torch.kernels.baselines.ref import bndm_ref, hash3_ref, kmp_dfa_ref, shift_or_ref


def shift_or(text, pattern, table, seg: int) -> torch.Tensor:
    return _build.on_device(text, shift_or_cuda, shift_or_ref)(text, pattern, table, seg)


def kmp_dfa(text, pattern, table, seg: int) -> torch.Tensor:
    return _build.on_device(text, kmp_dfa_cuda, kmp_dfa_ref)(text, pattern, table, seg)


def hash3(text, pattern, table, seg: int) -> torch.Tensor:
    return _build.on_device(text, hash3_cuda, hash3_ref)(text, pattern, table, seg)


def bndm(text, pattern, table, seg: int) -> torch.Tensor:
    return _build.on_device(text, bndm_cuda, bndm_ref)(text, pattern, table, seg)
