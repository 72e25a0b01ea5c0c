"""Public wrapper of the positional Materialize gather.

On a CPU tensor it runs the plain version (``ref.py``); on a CUDA tensor it
launches the hand-written kernel or raises.  ``LAUNCHES`` counts kernel
launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from .late_gather import late_gather_cuda
from .ref import late_gather_ref

LAUNCHES = 0


def late_gather(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """(R, W) table, (P,) int32 positions -> (P, W) rows in the table's own
    dtype; a zero row where a position is not a row of the table."""
    global LAUNCHES
    if table.device.type == "cpu" and positions.device.type == "cpu":
        return late_gather_ref(table, positions)
    out = late_gather_cuda(table, positions)
    if out.numel():
        LAUNCHES += 1
    return out
