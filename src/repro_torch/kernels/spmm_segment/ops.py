"""Segment-SpMM wrapper with the reference wrapper's contract.

``spmm_segment(x, src, dst, weights, num_out)`` is
``out[v, :] = sum_{e: dst[e]=v} weights[e] * x[src[e], :]``: rows with no
edge are zero, a ``src`` outside [0, N) contributes zero (callers pad with
N) and a ``dst`` outside [0, num_out) is dropped, as the plain version
drops it.  On CPU tensors it runs the plain version (``ref.py``).  On CUDA
tensors it orders the edges by destination with one stable sort, as the
reference wrapper does, and the hand-written kernel sums each row; it
launches or raises.

The two halves are public for a caller whose destinations stay fixed over
many calls: :func:`segments` sorts once, :func:`spmm_segment_sorted` runs
the kernel on edges already in that order (the weighted dense step sorts
once per request, not once per level).  It also takes a lane axis: (L, N,
D) ``x`` and an (L, N) source mask, the lanes of a batch of roots over
the same edges, in one kernel call.  ``LAUNCHES`` counts kernel calls,
one for all lanes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ref import spmm_segment_lanes_ref, spmm_segment_ref
from .spmm_segment import spmm_segment_cuda

LAUNCHES = 0


class Segments(NamedTuple):
    """Edges grouped by destination."""

    order: torch.Tensor     # (E,) int64 stable argsort of dst
    seg: torch.Tensor       # (E,) dst in that order
    offsets: torch.Tensor   # (num_out + 1,) int32: row v owns the sorted
    #   edges offsets[v]:offsets[v + 1] (a dst outside [0, num_out) falls
    #   before offsets[0] or after offsets[num_out])


def segments(dst: torch.Tensor, num_out: int) -> Segments:
    seg, order = torch.sort(dst, stable=True)
    bounds = torch.arange(num_out + 1, dtype=seg.dtype, device=seg.device)
    return Segments(order, seg,
                    torch.searchsorted(seg, bounds, out_int32=True))


def spmm_segment_sorted(x: torch.Tensor, src: torch.Tensor, seg: torch.Tensor,
                        weights: torch.Tensor, offsets: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`spmm_segment` on edges in :func:`segments` order: ``src``,
    ``seg`` and ``weights`` are permuted by ``order``.  The kernel reads
    ``offsets`` and no ``seg``; the plain version reads ``seg``.  With
    (L, N, D) ``x`` every lane sums the same edges over its own ``x``, and
    an optional (L, N) bool ``mask`` counts an edge whose source is masked
    off in its lane as padding: (L, num_out, D) in one kernel call, no
    launch for L = 0.  A mask goes with the lane axis only."""
    global LAUNCHES
    if mask is not None and x.dim() != 3:
        raise ValueError(f"a source mask needs (L, N, D) x, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu" and src.device.type == "cpu":
        num_out = offsets.shape[0] - 1
        if x.dim() == 3:
            return spmm_segment_lanes_ref(x, src, seg, weights, num_out, mask)
        return spmm_segment_ref(x, src, seg, weights, num_out)
    out = spmm_segment_cuda(x, src, weights, offsets, mask)
    if out.numel():
        LAUNCHES += 1
    return out


def spmm_segment(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 weights: Optional[torch.Tensor], num_out: int
                 ) -> torch.Tensor:
    """(N, D) ``x``, (E,) int32 ``src``/``dst``, (E,) ``weights`` (None:
    all ones) -> (num_out, D)."""
    if weights is None:
        weights = x.new_ones((src.shape[0],))
    if x.device.type == "cpu" and src.device.type == "cpu":
        return spmm_segment_ref(x, src, dst, weights, num_out)
    s = segments(dst, num_out)
    return spmm_segment_sorted(x, src[s.order], s.seg, weights[s.order],
                               s.offsets)


def _segment_count(idx: torch.Tensor, n: int, like: torch.Tensor
                   ) -> torch.Tensor:
    """(n,) count of ``idx`` per value; values outside [0, n) dropped."""
    slot = torch.where((idx >= 0) & (idx < n), idx, n).long()
    ones = like.new_ones(idx.shape)
    return like.new_zeros((n + 1,)).index_add_(0, slot, ones)[:n]


def gcn_norm_spmm(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  num_nodes: int) -> torch.Tensor:
    """Symmetric-normalized aggregation: out = D^{-1/2} A D^{-1/2} x, with
    D the mean of in- and out-degree, at least 1."""
    deg = (_segment_count(dst, num_nodes, x)
           + _segment_count(src, num_nodes, x))
    inv = torch.rsqrt(torch.clamp(deg * 0.5, min=1.0))
    w = (inv[src.clamp(0, num_nodes - 1).long()]
         * inv[dst.clamp(0, num_nodes - 1).long()])
    return spmm_segment(x, src, dst, w, num_nodes)
