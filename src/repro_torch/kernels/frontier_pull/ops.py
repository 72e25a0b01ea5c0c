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
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.csr import CSRIndex
from .frontier_pull import frontier_pull_cuda
from .layout import PullLayout, build_pull_layout
from .ref import frontier_pull_ref

LAUNCHES = 0


def frontier_pull_fused(rcsr: CSRIndex, join_src: torch.Tensor,
                        join_dst: torch.Tensor, frontier: torch.Tensor,
                        visited: torch.Tensor, *,
                        layout: Optional[PullLayout] = None) -> torch.Tensor:
    global LAUNCHES
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
