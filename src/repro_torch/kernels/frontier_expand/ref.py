"""Plain PyTorch version of the BFS frontier expansion — the PRecursive hot
loop.  It is the engine's own vectorized expansion
(:func:`repro_torch.core.csr.expand_frontier`), re-exported so the kernel is
held against exactly what the engine computes without the kernel."""
from __future__ import annotations

from ...core.csr import CSRIndex, expand_frontier


def frontier_expand_ref(csr: CSRIndex, targets, valid, capacity: int):
    return expand_frontier(csr, targets, valid, capacity)
