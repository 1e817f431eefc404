"""Byte-range partitioning of one logical stream across shards (DESIGN.md
§10), in the PyTorch port.

The port's copy of the range functions of ``repro.dist.sharding``: they are
plain integer arithmetic, equal to the reference's on every input.  The
reference module's model sharding tables belong to the training scaffold
and are not part of this module.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def range_partition(
    total: int, n_shards: int, *, align: int = 1
) -> Tuple[Tuple[int, int], ...]:
    """n_shards contiguous (start, stop) byte ranges covering [0, total).

    Interior boundaries are rounded DOWN to `align` (the stream seam rule
    needs every shard start on a beta block boundary so chunk-local aligned
    block fingerprints coincide with the global ones); the last shard absorbs
    the un-aligned remainder.  Degenerate shards (start == stop) are legal —
    they own no end positions and scan nothing."""
    total, n_shards, align = int(total), int(n_shards), int(align)
    if total < 0 or n_shards < 1 or align < 1:
        raise ValueError("range_partition needs total >= 0, n_shards/align >= 1")
    bounds = [
        min(total, (total * i) // n_shards // align * align)
        for i in range(n_shards + 1)
    ]
    bounds[0], bounds[-1] = 0, total
    return tuple((bounds[i], bounds[i + 1]) for i in range(n_shards))


def merge_ranges(ranges) -> Tuple[Tuple[int, int], ...]:
    """Sorted union of (start, stop) byte ranges: overlapping and adjacent
    ranges coalesce, empty ranges drop.  The canonical form PartialScanResult
    reports covered/missing coverage in (DESIGN.md §12)."""
    out: list = []
    for s, e in sorted((int(s), int(e)) for s, e in ranges):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return tuple(out)


def complement_ranges(ranges, total: int) -> Tuple[Tuple[int, int], ...]:
    """[0, total) minus the given ranges (merged first)."""
    out, pos = [], 0
    for s, e in merge_ranges(ranges):
        if s > pos:
            out.append((pos, s))
        pos = max(pos, e)
    if pos < int(total):
        out.append((pos, int(total)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class StreamShardSpec:
    """Range-partition plan for one logical stream scanned by many hosts.

    Shard i scans ``ranges[i]`` with ``overlap`` bytes of carried prefix
    (the bytes immediately before its start) injected into its first window;
    end-position attribution makes it own exactly the occurrences whose last
    byte falls inside its range."""

    total_bytes: int
    ranges: Tuple[Tuple[int, int], ...]
    overlap: int  # carried prefix bytes at each interior boundary
    align: int    # boundary alignment (the EPSMc beta block)

    @property
    def n_shards(self) -> int:
        return len(self.ranges)

    def prefix_range(self, i: int) -> Tuple[int, int]:
        """Byte range of shard i's injected overlap prefix (empty for i=0 or
        a shard starting at 0)."""
        s = self.ranges[i][0]
        return (max(0, s - self.overlap), s)


def make_stream_shard_spec(
    total: int, n_shards: int, *, overlap: int, align: int
) -> StreamShardSpec:
    if overlap < 0 or overlap % align:
        raise ValueError("overlap must be a non-negative multiple of align")
    return StreamShardSpec(
        total_bytes=int(total),
        ranges=range_partition(total, n_shards, align=align),
        overlap=int(overlap),
        align=int(align),
    )
