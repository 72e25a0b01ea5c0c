"""Public wrappers of the positional Materialize gather.

On CPU tensors they run the plain version (``ref.py``); on CUDA tensors
they launch the hand-written kernel or raise.  ``LAUNCHES`` counts kernel
launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .late_gather import MAX_COLUMNS, late_gather_cuda
from .ref import late_gather_columns_ref, require_rows

LAUNCHES = 0


def late_gather_columns(tables: Sequence[torch.Tensor],
                        positions: torch.Tensor) -> list[torch.Tensor]:
    """(R, W_c) tables of one R, (P,) int32 positions -> the (P, W_c) rows
    of each table in its own dtype: row p for 0 <= p < R, row p + R for
    -R <= p < 0 (counted from the end once), a zero row for p >= R (the
    padding sentinel ``num_rows``) or p < -R.  An empty table (R = 0)
    raises IndexError unless P = 0, before any launch.  On the card one
    launch per MAX_COLUMNS columns, none when the outputs are empty."""
    global LAUNCHES
    tables = list(tables)
    if tables:
        require_rows(tables[0].shape[0], positions.shape[0])
    if positions.device.type == "cpu" and \
            all(t.device.type == "cpu" for t in tables):
        return late_gather_columns_ref(tables, positions)
    outs = []
    for k in range(0, len(tables), MAX_COLUMNS):
        group = late_gather_cuda(tables[k:k + MAX_COLUMNS], positions)
        if any(o.numel() for o in group):
            LAUNCHES += 1
        outs += group
    return outs


def late_gather(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """(R, W) table, (P,) int32 positions -> (P, W) rows: the one-column
    case of :func:`late_gather_columns`."""
    return late_gather_columns([table], positions)[0]
