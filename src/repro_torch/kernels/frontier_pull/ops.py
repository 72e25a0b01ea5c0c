"""Bottom-up pull-step wrapper with the engine's contract.

``frontier_pull_fused(rcsr, join_src, join_dst, frontier, visited)`` is a
drop-in for the ``expand_fn`` slot of ``PullStep`` and ``HybridPullStep``
(:mod:`repro_torch.core.operators`): the (V,) bool next frontier, every
unvisited vertex with an in-neighbor in ``frontier``.  On CPU tensors it
runs the plain version (``ref.py``).  On CUDA tensors the perm-ordered
gathers, the membership test and the per-vertex OR run as ONE
hand-written kernel; it launches or raises.  An empty ``perm`` gives a
zero mask without a launch.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from ...core.csr import CSRIndex
from .frontier_pull import frontier_pull_cuda
from .ref import frontier_pull_ref

LAUNCHES = 0


def frontier_pull_fused(rcsr: CSRIndex, join_src: torch.Tensor,
                        join_dst: torch.Tensor, frontier: torch.Tensor,
                        visited: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if frontier.device.type == "cpu" and rcsr.perm.device.type == "cpu":
        return frontier_pull_ref(rcsr, join_src, join_dst, frontier,
                                 visited)
    if rcsr.perm.shape[0] == 0:
        return torch.zeros_like(frontier)
    # bool is one byte: the kernel reads and writes the same bytes as uint8
    out = frontier_pull_cuda(rcsr.perm, join_src, join_dst,
                             frontier.contiguous().view(torch.uint8),
                             visited.contiguous().view(torch.uint8))
    LAUNCHES += 1
    return out.view(torch.bool)
