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

The one-lane (N, D) call is differentiable in ``x``: where a gradient is
required it runs through :class:`SpmmSegment`, whose backward is the
same sum over the transposed edges (:func:`transpose_grouping`), so the
hand-written kernel on the card and the plain version on the CPU, in
both directions.  No gradient flows to ``weights``, and none through
the lane axis or a mask: those raise where one is required.

On tensors all on the ``meta`` device every call gives an empty output of
the kernel's shape and dtype and launches nothing; :func:`work` is a
call's declared work (``kernels/accounting.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..accounting import Work, charged, on_meta
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


class Grouping(NamedTuple):
    """The arguments of :func:`spmm_segment_sorted` after ``x``: edges in
    :func:`segments` order of their ``seg``."""

    src: torch.Tensor
    seg: torch.Tensor
    weights: torch.Tensor
    offsets: torch.Tensor


def transpose_grouping(src: torch.Tensor, seg: torch.Tensor,
                       weights: torch.Tensor, num_src: int) -> Grouping:
    """The same edges grouped by source, for the transposed sum
    ``grad_x[u] = sum_{e: src[e]=u} w[e] * grad_out[seg[e]]`` over N =
    ``num_src`` rows: one stable sort of ``src``.  Padding carries over
    with no special case: a ``src`` outside [0, N) falls outside every
    row and is dropped, and a ``seg`` outside [0, num_out), dropped by the
    forward sum, becomes a padded source of the transposed one."""
    s = segments(src, num_src)
    return Grouping(seg.index_select(0, s.order), s.seg,
                    weights.index_select(0, s.order), s.offsets)


def _work(x: torch.Tensor, src: torch.Tensor, weights: Optional[torch.Tensor],
          num_out: int, mask: Optional[torch.Tensor]) -> Work:
    """The (num_out + 1,) offsets, ``src`` and ``w`` read once, for each
    lane at most min(E, N) distinct x rows (and, with a mask, their mask
    bytes) read once and the (num_out, D) output written once; a
    multiply-add per edge, column and lane."""
    lanes = x.shape[0] if x.dim() == 3 else 1
    n, d, e = x.shape[-2], x.shape[-1], src.shape[0]
    w_bytes = (weights if weights is not None else x).element_size()
    rows = min(e, n)
    per_lane = rows * d * x.element_size() + num_out * d * x.element_size() \
        + (rows if mask is not None else 0)
    return Work(flops=2.0 * lanes * e * d,
                bytes=(num_out + 1) * 4 + e * (src.element_size() + w_bytes)
                + lanes * per_lane)


def work_sorted(x, src, seg, weights, offsets, mask=None, **_) -> Work:
    return _work(x, src, weights, offsets.shape[0] - 1, mask)


def work(x, src, dst, weights, num_out) -> Work:
    return _work(x, src, weights, num_out, None)


def _meta_out(x: torch.Tensor, num_out: int) -> torch.Tensor:
    return x.new_empty(tuple(x.shape[:-2]) + (num_out, x.shape[-1]))


@charged("spmm_segment", work_sorted)
def _sum_sorted(x: torch.Tensor, src: torch.Tensor, seg: torch.Tensor,
                weights: torch.Tensor, offsets: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version on CPU tensors, an empty output on meta tensors,
    else one kernel call."""
    global LAUNCHES
    if on_meta(x, src, seg, weights, offsets, mask):
        return _meta_out(x, offsets.shape[0] - 1)
    if x.device.type == "cpu" and src.device.type == "cpu":
        num_out = offsets.shape[0] - 1
        if x.dim() == 3:
            return spmm_segment_lanes_ref(x, src, seg, weights, num_out, mask)
        return spmm_segment_ref(x, src, seg, weights, num_out)
    out = spmm_segment_cuda(x, src, weights, offsets, mask)
    if out.numel():
        LAUNCHES += 1
    return out


class SpmmSegment(torch.autograd.Function):
    """The one-lane sum with its gradient in ``x``: the same sum over the
    edges grouped by source, ``transposed`` when the caller grouped them
    (once for many calls over the same edges), else grouped here."""

    @staticmethod
    def forward(ctx, x, src, seg, weights, offsets, transposed):
        ctx.num_src = x.shape[0]
        ctx.transposed = transposed
        if transposed is None:
            ctx.save_for_backward(src, seg, weights)
        return _sum_sorted(x, src, seg, weights, offsets)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        t = ctx.transposed
        if t is None:
            t = transpose_grouping(*ctx.saved_tensors, ctx.num_src)
        return (_sum_sorted(grad_out.contiguous(), *t),
                None, None, None, None, None)


@charged("spmm_segment", work_sorted)
def spmm_segment_sorted(x: torch.Tensor, src: torch.Tensor, seg: torch.Tensor,
                        weights: torch.Tensor, offsets: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, *,
                        transposed: Optional[Grouping] = None
                        ) -> torch.Tensor:
    """:func:`spmm_segment` on edges in :func:`segments` order: ``src``,
    ``seg`` and ``weights`` are permuted by ``order``.  The kernel reads
    ``offsets`` and no ``seg``; the plain version reads ``seg``.  With
    (L, N, D) ``x`` every lane sums the same edges over its own ``x``, and
    an optional (L, N) bool ``mask`` counts an edge whose source is masked
    off in its lane as padding: (L, num_out, D) in one kernel call, no
    launch for L = 0.  A mask goes with the lane axis only.

    Where autograd needs the gradient of (N, D) ``x``, the call goes
    through :class:`SpmmSegment`; ``transposed``, the
    :func:`transpose_grouping` of these edges, saves its backward the
    sort."""
    if mask is not None and x.dim() != 3:
        raise ValueError(f"a source mask needs (L, N, D) x, got "
                         f"{tuple(x.shape)}")
    if not torch.is_grad_enabled() or not (x.requires_grad
                                           or weights.requires_grad):
        return _sum_sorted(x, src, seg, weights, offsets, mask)
    if weights.requires_grad:
        raise ValueError("spmm_segment has no gradient in its weights")
    if x.dim() != 2 or mask is not None:
        raise ValueError("spmm_segment's gradient takes the one-lane "
                         f"(N, D) call with no mask, got x "
                         f"{tuple(x.shape)}")
    return SpmmSegment.apply(x, src, seg, weights, offsets, transposed)


@charged("spmm_segment", work)
def spmm_segment(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 weights: Optional[torch.Tensor], num_out: int
                 ) -> torch.Tensor:
    """(N, D) ``x``, (E,) int32 ``src``/``dst``, (E,) ``weights`` (None:
    all ones) -> (num_out, D)."""
    if on_meta(x, src, dst, weights):
        return _meta_out(x, num_out)
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
