"""Frontier-expansion wrapper with the engine's contract.

``frontier_expand_fused(csr, targets, valid, capacity)`` is a drop-in for
:func:`repro_torch.core.csr.expand_frontier` and for ``CSRIndexJoin``'s
``expand_fn``.  On CPU tensors it runs the plain version (``ref.py``).  On
CUDA tensors the degrees, their scan, the rank inversion and the ``perm``
gather run as hand-written kernels, three launches from one C call and no
torch op; it launches or raises.  ``(L, F)`` targets and flags (a batch
of roots) expand every lane in the same one C call.  ``LAUNCHES`` counts
calls that launched, one per BFS level.
"""
from __future__ import annotations

import torch

from ...core.csr import CSRIndex
from .frontier_expand import frontier_expand_cuda
from .ref import frontier_expand_ref

LAUNCHES = 0


def frontier_expand_fused(csr: CSRIndex, targets: torch.Tensor,
                          valid: torch.Tensor, capacity: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (edge_positions (capacity,) int32, min(total, capacity),
    total > capacity), the last two as 0-d tensors on the input's device;
    with a lane axis (L, capacity), (L,) and (L,)."""
    global LAUNCHES
    if targets.device.type == "cpu" and csr.perm.device.type == "cpu":
        return frontier_expand_ref(csr, targets, valid, capacity)
    out = frontier_expand_cuda(csr.indptr, csr.perm, targets, valid,
                               capacity)
    if targets.dim() == 1 or targets.shape[0]:      # no lane, no launch
        LAUNCHES += 1
    return out
