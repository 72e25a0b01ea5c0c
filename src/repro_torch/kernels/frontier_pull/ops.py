"""Bottom-up pull-step wrapper with the engine's contract.

``frontier_pull_fused(rcsr, join_src, join_dst, frontier, visited,
layout=None)`` is a drop-in for the ``expand_fn`` slot of ``PullStep`` and
``HybridPullStep`` (:mod:`repro_torch.core.operators`): the (V,) bool next
frontier, every unvisited vertex with an in-neighbor in ``frontier``.  On
CPU tensors it runs the plain version (``ref.py``) and ignores ``layout``.
On CUDA tensors the hand-written kernel walks ``layout``, the
:class:`PullLayout` of ``rcsr`` that ``Dataset`` builds once per
orientation; without one the call builds its own first (two host syncs
and a dozen torch ops a call, so slower, same result).  It launches or
raises.  An empty ``perm`` gives a zero mask without a launch.  (L, V)
planes (a batch of roots) pull every lane in the same one C call.
``LAUNCHES`` counts kernel launches (one C call, 1 or 2 device launches).
On tensors all on the ``meta`` device it gives an empty mask and launches
nothing; :func:`work` is a call's declared work
(``kernels/accounting.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.csr import CSRIndex
from ..accounting import Work, charged, on_meta
from .frontier_pull import frontier_pull_cuda
from .layout import PullLayout, build_pull_layout
from .ref import frontier_pull_ref

LAUNCHES = 0


def work(rcsr: CSRIndex, join_src: torch.Tensor, join_dst: torch.Tensor,
         frontier: torch.Tensor, visited: torch.Tensor, *,
         layout: Optional[PullLayout] = None) -> Work:
    """The per-entry byte count at its most: ``perm``, ``join_dst`` and
    ``join_src`` over all E entries read once, and for each lane the (V,)
    visited plane, at most min(E, V) frontier bytes and the (V,) output
    written once."""
    lanes = frontier.shape[0] if frontier.dim() == 2 else 1
    v, e = frontier.shape[-1], rcsr.perm.shape[0]
    shared = e * (rcsr.perm.element_size() + join_dst.element_size()
                  + join_src.element_size())
    return Work(bytes=shared + lanes * (v * visited.element_size()
                                        + min(e, v) + v))


@charged("frontier_pull", work)
def frontier_pull_fused(rcsr: CSRIndex, join_src: torch.Tensor,
                        join_dst: torch.Tensor, frontier: torch.Tensor,
                        visited: torch.Tensor, *,
                        layout: Optional[PullLayout] = None) -> torch.Tensor:
    global LAUNCHES
    if on_meta(rcsr, join_src, join_dst, frontier, visited, layout):
        return torch.empty_like(frontier)
    if frontier.device.type == "cpu" and rcsr.perm.device.type == "cpu":
        return frontier_pull_ref(rcsr, join_src, join_dst, frontier,
                                 visited)
    no_lane = frontier.dim() == 2 and frontier.shape[0] == 0
    if rcsr.perm.shape[0] == 0 or no_lane:
        return torch.zeros_like(frontier)
    if layout is None:
        layout = build_pull_layout(rcsr, join_src, join_dst,
                                   frontier.shape[-1])
    # bool is one byte: the kernel reads and writes the same bytes as uint8
    out = frontier_pull_cuda(layout, frontier.contiguous().view(torch.uint8),
                             visited.contiguous().view(torch.uint8))
    LAUNCHES += 1
    return out.view(torch.bool)
