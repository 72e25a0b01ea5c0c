"""Frontier-expansion wrapper with the engine's contract.

``frontier_expand_fused(csr, targets, valid, capacity)`` is a drop-in for
:func:`repro_torch.core.csr.expand_frontier` and for ``CSRIndexJoin``'s
``expand_fn``.  On CPU tensors it runs the plain version (``ref.py``).  On
CUDA tensors the degrees, their scan, the rank inversion and the ``perm``
gather run as hand-written kernels, three launches from one C call and no
torch op; it launches or raises.  ``(L, F)`` targets and flags (a batch
of roots) expand every lane in the same one C call.  ``LAUNCHES`` counts
calls that launched, one per BFS level.  On tensors all on the ``meta``
device it gives empty outputs of the kernel's shapes and dtypes and
launches nothing; :func:`work` is a call's declared work
(``kernels/accounting.py``).
"""
from __future__ import annotations

import torch

from ...core.csr import CSRIndex
from ..accounting import Work, charged, on_meta
from .frontier_expand import frontier_expand_cuda
from .ref import frontier_expand_ref

LAUNCHES = 0


def work(csr: CSRIndex, targets: torch.Tensor, valid: torch.Tensor,
         capacity: int) -> Work:
    """A lane's (F,) targets and flags read once, two ``indptr`` entries
    a target, at most min(E, capacity) ``perm`` entries reached, the
    (capacity,) positions, the count and the flag written once."""
    lanes = targets.shape[0] if targets.dim() == 2 else 1
    f, e = targets.shape[-1], csr.perm.shape[0]
    per_lane = f * (targets.element_size() + valid.element_size()) \
        + 2 * f * csr.indptr.element_size() \
        + min(e, capacity) * csr.perm.element_size() + capacity * 4 + 4 + 1
    return Work(bytes=lanes * per_lane)


@charged("frontier_expand", work)
def frontier_expand_fused(csr: CSRIndex, targets: torch.Tensor,
                          valid: torch.Tensor, capacity: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (edge_positions (capacity,) int32, min(total, capacity),
    total > capacity), the last two as 0-d tensors on the input's device;
    with a lane axis (L, capacity), (L,) and (L,)."""
    global LAUNCHES
    if on_meta(csr, targets, valid):
        lead = tuple(targets.shape[:-1])
        return (targets.new_empty(lead + (capacity,), dtype=torch.int32),
                targets.new_empty(lead, dtype=torch.int32),
                targets.new_empty(lead, dtype=torch.bool))
    if targets.device.type == "cpu" and csr.perm.device.type == "cpu":
        return frontier_expand_ref(csr, targets, valid, capacity)
    out = frontier_expand_cuda(csr.indptr, csr.perm, targets, valid,
                               capacity)
    if targets.dim() == 1 or targets.shape[0]:      # no lane, no launch
        LAUNCHES += 1
    return out
