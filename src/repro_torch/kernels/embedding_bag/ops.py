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
already in bag order.  ``LAUNCHES`` counts kernel launches.  On tensors
all on the ``meta`` device both give an empty (num_bags, D) output and
launch nothing; :func:`work` is a call's declared work
(``kernels/accounting.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..accounting import Work, charged, on_meta
from ..late_gather.ops import late_gather
from ..late_gather.ref import require_rows
from ..spmm_segment.ops import segments
from .embedding_bag import embedding_bag_cuda
from .ref import check_combiner, embedding_bag_ref

LAUNCHES = 0


def _work(table: torch.Tensor, indices: torch.Tensor,
          weights: Optional[torch.Tensor], num_bags: int) -> Work:
    """The bags' offsets, every entry's index (and weight), at most
    min(I, R) distinct rows read once, the (num_bags, D) output written
    once; a multiply-add (an add unweighted) per entry and column."""
    i, d = indices.shape[0], table.shape[1]
    entry = indices.element_size() + (0 if weights is None
                                      else weights.element_size())
    row = d * table.element_size()
    return Work(flops=(1.0 if weights is None else 2.0) * i * d,
                bytes=(num_bags + 1) * 4 + i * entry + min(i, table.shape[0])
                * row + num_bags * row)


def work_sorted(table, indices, seg, weights, offsets, *, combiner="sum"
                ) -> Work:
    return _work(table, indices, weights, offsets.shape[0] - 1)


def work(table, indices, segment_ids, num_bags, weights=None, *,
         combiner="sum") -> Work:
    return _work(table, indices, weights, num_bags)


@charged("embedding_bag", work_sorted)
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
    if on_meta(table, indices, seg, weights, offsets):
        check_combiner(combiner)
        return table.new_empty((offsets.shape[0] - 1, table.shape[1]))
    if table.device.type == "cpu" and indices.device.type == "cpu":
        return embedding_bag_ref(table, indices, seg, offsets.shape[0] - 1,
                                 weights, combiner=combiner)
    check_combiner(combiner)
    out = embedding_bag_cuda(table, indices, weights, offsets,
                             mean=combiner == "mean")
    if out.numel():
        LAUNCHES += 1
    return out


@charged("embedding_bag", work)
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
    if on_meta(table, indices, segment_ids, weights):
        check_combiner(combiner)
        return table.new_empty((num_bags, table.shape[1]))
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
