"""EmbeddingBag wrapper with the reference wrapper's contract, and the
DeepFM per-field lookup.

``embedding_bag(table, indices, segment_ids, num_bags, weights)`` is
``out[b] = sum_{i: seg[i]=b} weights[i] * table[indices[i]]``: segments
need not be sorted, bags may be empty (zero), an index >= R contributes
zero, a negative one in [-R, 0) counts from the end once, and a segment id
outside [0, num_bags) is dropped, as the plain version drops it.  On CPU
tensors it runs the plain version (``ref.py``).  On CUDA tensors it groups
the entries by bag with one stable sort (``spmm_segment``'s
:func:`segments`) and the hand-written kernel sums each bag; it launches
or raises.  :func:`embedding_bag_sorted` is the kernel's half, for entries
already in bag order.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..late_gather.ops import late_gather
from ..late_gather.ref import require_rows
from ..spmm_segment.ops import segments
from .embedding_bag import embedding_bag_cuda
from .ref import check_combiner, embedding_bag_ref

LAUNCHES = 0


def embedding_bag_sorted(table: torch.Tensor, indices: torch.Tensor,
                         seg: torch.Tensor, weights: Optional[torch.Tensor],
                         offsets: torch.Tensor, *, combiner: str = "sum"
                         ) -> torch.Tensor:
    """:func:`embedding_bag` on entries in :func:`segments` order:
    ``indices``, ``seg`` and ``weights`` are permuted by ``order``.  The
    kernel reads ``offsets`` and no ``seg``; the plain version reads
    ``seg``."""
    global LAUNCHES
    require_rows(table.shape[0], indices.shape[0])
    if table.device.type == "cpu" and indices.device.type == "cpu":
        return embedding_bag_ref(table, indices, seg, offsets.shape[0] - 1,
                                 weights, combiner=combiner)
    check_combiner(combiner)
    out = embedding_bag_cuda(table, indices, weights, offsets,
                             mean=combiner == "mean")
    if out.numel():
        LAUNCHES += 1
    return out


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, num_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  *, combiner: str = "sum") -> torch.Tensor:
    """(R, D) ``table``, (I,) int32 ``indices`` and ``segment_ids`` (any
    order), (I,) ``weights`` (None: all ones) -> (num_bags, D).
    ``combiner="mean"`` divides each bag by its count of indices < R, at
    least 1.  On the card the table must be float32.  An empty table
    (R = 0) raises IndexError unless I = 0, before any launch."""
    require_rows(table.shape[0], indices.shape[0])
    if table.device.type == "cpu" and indices.device.type == "cpu":
        return embedding_bag_ref(table, indices, segment_ids, num_bags,
                                 weights, combiner=combiner)
    s = segments(segment_ids, num_bags)
    return embedding_bag_sorted(
        table, indices[s.order], s.seg,
        None if weights is None else weights[s.order], s.offsets,
        combiner=combiner)


def fixed_hot_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, K) int32 ids -> (B, K, D) rows in the table's dtype: the DeepFM
    per-field lookup (one id per field, fields stacked), the degenerate
    bag.  A pure gather, through ``late_gather``: its kernel on CUDA
    tensors, its plain version on CPU tensors; an id in [-R, 0) counts
    from the end once, one >= R or below -R gives a zero row."""
    b, k = ids.shape
    rows = late_gather(table, ids.reshape(-1).to(torch.int32))
    return rows.reshape(b, k, table.shape[1])
