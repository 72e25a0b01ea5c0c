"""Public wrappers of the positional Materialize gather.

On CPU tensors they run the plain version (``ref.py``); on CUDA tensors
they launch the hand-written kernel or raise.  ``LAUNCHES`` counts kernel
launches, so a run can show that its path went through the kernel.

Where autograd needs a table's gradient, the gather runs through
:class:`LateGather`: the same forward, and a backward that adds each
output row's gradient into the table row it came from (``index_add_``,
as the reference's gradient of ``jnp.take`` is XLA's scatter-add).  On
the card those adds are atomics, so the sums are not bit-reproducible.

On tensors all on the ``meta`` device the gather gives empty outputs of
its shapes and dtypes and launches nothing; :func:`work` is a call's
declared work (``kernels/accounting.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..accounting import Work, charged, on_meta
from .late_gather import MAX_COLUMNS, late_gather_cuda
from .ref import late_gather_columns_ref, require_rows

LAUNCHES = 0


def _needs_grad(tables: Sequence[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tables)


def work(tables: Sequence[torch.Tensor], positions: torch.Tensor) -> Work:
    """(P,) positions read once, at most min(P, R) distinct rows of each
    table read once, the (P, W_c) outputs written once."""
    p = positions.shape[0]
    r = tables[0].shape[0] if len(tables) else 0
    row = sum(t.shape[1] * t.element_size() for t in tables)
    return Work(bytes=p * positions.element_size() + min(p, r) * row
                + p * row)


def _gather(tables: list, positions: torch.Tensor) -> list[torch.Tensor]:
    """The plain version on CPU tensors, empty outputs on meta tensors,
    else one launch per MAX_COLUMNS columns."""
    global LAUNCHES
    if tables:
        require_rows(tables[0].shape[0], positions.shape[0])
    if on_meta(tables, positions):
        return [t.new_empty((positions.shape[0],) + tuple(t.shape[1:]))
                for t in tables]
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


class LateGather(torch.autograd.Function):
    """One table's gather with its gradient in the table: the gradient of
    output row i goes to row p_i (p_i + R for p_i in [-R, 0)); a position
    outside [-R, R), whose output row is zero, adds nothing."""

    @staticmethod
    def forward(ctx, table, positions):
        ctx.save_for_backward(positions)
        ctx.rows = table.shape[0]
        return _gather([table], positions)[0]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        (positions,) = ctx.saved_tensors
        r = ctx.rows
        p = positions.long()
        p = torch.where(p < 0, p + r, p)
        slot = torch.where((p >= 0) & (p < r), p, r)   # row r: the dropped
        grad = grad_out.new_zeros((r + 1,) + tuple(grad_out.shape[1:]))
        return grad.index_add_(0, slot, grad_out)[:r], None


@charged("late_gather", work)
def late_gather_columns(tables: Sequence[torch.Tensor],
                        positions: torch.Tensor) -> list[torch.Tensor]:
    """(R, W_c) tables of one R, (P,) int32 positions -> the (P, W_c) rows
    of each table in its own dtype: row p for 0 <= p < R, row p + R for
    -R <= p < 0 (counted from the end once), a zero row for p >= R (the
    padding sentinel ``num_rows``) or p < -R.  An empty table (R = 0)
    raises IndexError unless P = 0, before any launch.  On the card one
    launch per MAX_COLUMNS columns, none when the outputs are empty.
    Where a table's gradient is required, each table goes through
    :class:`LateGather` on its own (one launch a table)."""
    tables = list(tables)
    if _needs_grad(tables):
        require_rows(tables[0].shape[0], positions.shape[0])
        return [LateGather.apply(t, positions) for t in tables]
    return _gather(tables, positions)


def late_gather(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """(R, W) table, (P,) int32 positions -> (P, W) rows: the one-column
    case of :func:`late_gather_columns`."""
    return late_gather_columns([table], positions)[0]
