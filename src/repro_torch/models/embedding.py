"""Sparse embedding substrate for the recsys family, in PyTorch.

The port's copy of ``repro.models.embedding``: lookups are gathers and
multi-hot bags are a gather plus a segment reduction (``index_add`` for
sum and mean, ``scatter_reduce`` for max), as the reference builds them
from ``jnp.take`` and ``jax.ops.segment_*``.  A lookup's gradient is a
dense (V, d) tensor, as ``jnp.take``'s is.  The reference's row-sharded
strategies ("gspmd", "psum", the all-to-all exchange) belong to the
multi-device layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import normal_init

_U32 = 0xFFFFFFFF
_HASH_MULT = 0x45D9F3B


@dataclasses.dataclass(frozen=True)
class TableSpec:
    name: str
    vocab: int
    dim: int


def init_table(gen: torch.Generator, spec: TableSpec, dtype=torch.float32) -> torch.Tensor:
    # rows scaled ~ 1/sqrt(dim) as in DLRM
    return normal_init(gen, (spec.vocab, spec.dim), dtype, stddev=1.0 / math.sqrt(spec.dim))


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-hot lookup: (V, d), (...,) int -> (..., d)."""
    return F.embedding(ids, table)


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,  # (nnz,) int
    segment_ids: torch.Tensor,  # (nnz,) int bag index per id
    num_bags: int,
    combiner: str = "sum",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """torch.nn.EmbeddingBag equivalent: gather + segment reduce.  An empty
    bag gives 0 under sum and mean and -inf under max, as the reference's
    segment_sum and segment_max do."""
    v = F.embedding(ids, table)  # (nnz, d)
    if weights is not None:
        v = v * weights[:, None]
    seg = segment_ids.long()
    zeros = v.new_zeros((num_bags, v.shape[1]))
    if combiner == "sum":
        return zeros.index_add(0, seg, v)
    if combiner == "mean":
        s = zeros.index_add(0, seg, v)
        c = v.new_zeros((num_bags, 1)).index_add(0, seg, v.new_ones((ids.shape[0], 1)))
        return s / torch.clamp(c, min=1.0)
    if combiner == "max":
        out = torch.full_like(zeros, -math.inf)
        return out.scatter_reduce(0, seg[:, None].expand_as(v), v, "amax", include_self=False)
    raise ValueError(f"unknown combiner {combiner}")


def hash_bucket(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Hash arbitrary ids into table rows (quotient-remainder-free variant).

    The reference hashes in uint32 with wraparound; torch on the CPU has no
    uint32 arithmetic, so the value is carried in int64 and masked to 32
    bits after each multiply (negative ids wrap as ``astype(uint32)``
    does)."""
    x = ids.to(torch.int64) & _U32
    x = ((x ^ (x >> 16)) * _HASH_MULT) & _U32
    x = ((x ^ (x >> 16)) * _HASH_MULT) & _U32
    x = x ^ (x >> 16)
    return (x % vocab).to(torch.int32)


def masked_mean_pool(emb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, T, d) x (B, T) -> (B, d)."""
    m = mask.to(emb.dtype)[..., None]
    return (emb * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
