"""Frontier-expansion wrapper with the engine's contract.

``frontier_expand_fused(csr, targets, valid, capacity)`` is a drop-in for
:func:`repro_torch.core.csr.expand_frontier` and for ``CSRIndexJoin``'s
``expand_fn``.  On CPU tensors it runs the plain version (``ref.py``).  On
CUDA tensors the degrees, their inclusive cumsum and the CSR range starts
stay plain torch, as in the reference wrapper, and the rank inversion plus
the ``perm`` gather run as ONE hand-written kernel; it launches or raises.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from ...core.csr import CSRIndex, csr_degrees
from .frontier_expand import expand_index_cuda
from .ref import frontier_expand_ref

LAUNCHES = 0


def frontier_expand_fused(csr: CSRIndex, targets: torch.Tensor,
                          valid: torch.Tensor, capacity: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (edge_positions (capacity,) int32, min(total, capacity),
    total > capacity), the last two as 0-d tensors on the input's device."""
    global LAUNCHES
    if targets.device.type == "cpu" and csr.perm.device.type == "cpu":
        return frontier_expand_ref(csr, targets, valid, capacity)
    deg = csr_degrees(csr, targets, valid)
    ends = torch.cumsum(deg, 0, dtype=torch.int32)
    v = targets.clamp(0, csr.num_vertices - 1)
    estart = torch.where(deg > 0, csr.indptr[v], 0)
    epos = expand_index_cuda(ends, estart, deg, csr.perm, capacity)
    LAUNCHES += 1
    total = ends[-1]
    return epos, total.clamp(max=capacity), total > capacity
