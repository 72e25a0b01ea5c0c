"""Plain PyTorch version of the bottom-up (pull) frontier step.

It is also the engine's reverse-CSR pull where no kernel is plugged in
(``_dense_pull`` in :mod:`repro_torch.core.operators`, non-bidirectional
branch): per reverse-adjacency entry, test the in-neighbor's frontier
membership under the unvisited candidate mask, then segment-OR per owning
vertex."""
from __future__ import annotations

import torch

from ...core.csr import CSRIndex
from ...core.semiring import or_combine


def frontier_pull_ref(rcsr: CSRIndex, join_src: torch.Tensor,
                      join_dst: torch.Tensor, frontier: torch.Tensor,
                      visited: torch.Tensor) -> torch.Tensor:
    nv = frontier.shape[0]
    cand = ~visited
    perm = rcsr.perm
    nbr = join_src[perm].clamp(0, nv - 1)
    vtx = join_dst[perm].clamp(0, nv - 1)
    contrib = cand[vtx] & frontier[nbr]
    nxt = or_combine(torch.zeros_like(frontier), vtx, contrib)
    return nxt & cand
