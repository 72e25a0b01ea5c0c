"""Position blocks — the paper's core intermediate representation.

PosDB's positional operators exchange blocks of row ids instead of value
tuples.  As in the reference every buffer has a fixed capacity: a position
block is an ``int32`` vector plus a live count, and dead slots hold an
out-of-range sentinel so downstream gathers give zeros (see
``ColumnTable.take``).  A batch of roots adds a leading lane axis: an
``(L, cap)`` block with ``(L,)`` counts, each lane compacted and appended
on its own along the last axis.

The reference's scatters DROP out-of-range indices; torch on CUDA would
assert instead.  So every dropping scatter here writes into a copy with one
spare slot, routes the dropped entries there, and slices it off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .csr import lane_cumsum

__all__ = ["PosBlock", "empty_block", "compact_mask", "block_from_mask",
           "append_block", "take_late", "sort_positions_by_key"]


class PosBlock(NamedTuple):
    """Fixed-capacity block of row positions.

    positions : (cap,) int32 — valid entries first, sentinel padding after
    count     : ()     int32 — number of live entries
    (``(L, cap)`` and ``(L,)`` with a lane axis)
    """

    positions: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.positions.shape[-1]

    def valid_mask(self) -> torch.Tensor:
        slots = torch.arange(self.capacity, dtype=torch.int32,
                             device=self.positions.device)
        return slots < self.count[..., None]


def empty_block(capacity: int, sentinel: int, device) -> PosBlock:
    return PosBlock(
        positions=torch.full((capacity,), sentinel, dtype=torch.int32,
                             device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def compact_mask(mask: torch.Tensor, capacity: int, sentinel: int
                 ) -> PosBlock:
    """Turn a boolean row mask into a compacted position block (the columnar
    Filter operator).  Ascending order; matches beyond ``capacity`` are
    dropped (callers compare ``count`` with the capacity).  A cumsum
    compaction: no host sync.  An ``(L, n)`` mask compacts each lane."""
    n = mask.shape[-1]
    lead = mask.shape[:-1]
    count = mask.sum(-1, dtype=torch.int32)
    rank = lane_cumsum(mask) - 1
    slot = torch.where(mask & (rank < capacity), rank, capacity)
    out = torch.full(lead + (capacity + 1,), sentinel, dtype=torch.int32,
                     device=mask.device)
    out.scatter_(-1, slot.long(), torch.arange(
        n, dtype=torch.int32, device=mask.device).expand(mask.shape))
    return PosBlock(out[..., :capacity], count.clamp(max=capacity))


def block_from_mask(values: torch.Tensor, mask: torch.Tensor, capacity: int,
                    sentinel: int) -> tuple[PosBlock, torch.Tensor]:
    """Compact ``values[mask]`` into a block of ``capacity``: the selected
    values first, in their order in ``values`` (a stable compaction, the
    slots :func:`compact_mask` finds), ``sentinel`` after them, including
    the slots past ``n`` when ``capacity > n``.  Returns (block,
    overflow), the overflow ``count > capacity`` as a 0-d tensor."""
    n = values.shape[-1]
    count = mask.sum(-1, dtype=torch.int32)
    slots = compact_mask(mask, capacity, n).positions      # n: no value
    ext = torch.cat([values.to(torch.int32),
                     values.new_full(values.shape[:-1] + (1,), sentinel,
                                     dtype=torch.int32)], -1)
    out = torch.gather(ext, -1, slots.long())
    return PosBlock(out, count.clamp(max=capacity)), count > capacity


def append_block(buf: torch.Tensor, buf_count: torch.Tensor, block: PosBlock
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append a block's live entries into a larger result buffer.

    Returns (new_buffer, new_count, overflowed).  Entries past the buffer
    capacity are dropped (and flagged) rather than wrapped.  ``buf`` itself
    is not modified.  With a lane axis each lane appends to its own row."""
    cap_r = buf.shape[-1]
    slots = buf_count[..., None] + torch.arange(
        block.capacity, dtype=torch.int32, device=buf.device)
    live = block.valid_mask() & (slots < cap_r)
    ext = torch.cat([buf, buf.new_zeros(buf.shape[:-1] + (1,))], -1)
    ext.scatter_(-1, torch.where(live, slots, cap_r).long(),
                 torch.where(live, block.positions, 0))
    new_count = (buf_count + block.count).clamp(max=cap_r)
    return ext[..., :cap_r], new_count, (buf_count + block.count) > cap_r


# ---------------------------------------------------------------------------
# Late materialization + positional processing primitives
# ---------------------------------------------------------------------------

def take_late(table, block: PosBlock, names=None):
    """The Materialize operator: one gather at the very end of a positional
    plan.  ``table`` is a ColumnTable; returns a dict of (cap, ...) tensors
    with dead slots zeroed."""
    return table.take(block.positions, names)


def sort_positions_by_key(keys: torch.Tensor, num_buckets: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable-sort positions by an integer bucket key: (order, counts),
    ``order`` the original positions grouped by bucket (int32) and
    ``counts`` the (num_buckets,) int32 bucket sizes.  A key in
    [-num_buckets, 0) counts from the end once; any other key outside
    [0, num_buckets) is counted nowhere (the reference's dropping scatter),
    through the spare slot."""
    order = torch.argsort(keys, stable=True).to(torch.int32)
    k = torch.where(keys < 0, keys + num_buckets, keys)
    slot = torch.where((k >= 0) & (k < num_buckets), k, num_buckets)
    counts = torch.zeros(num_buckets + 1, dtype=torch.int32,
                         device=keys.device)
    counts.index_add_(0, slot.long(), torch.ones_like(slot, dtype=torch.int32))
    return order, counts[:num_buckets]
