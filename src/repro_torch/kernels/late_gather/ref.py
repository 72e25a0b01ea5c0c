"""Plain PyTorch version of the positional Materialize gather: the
correctness oracle of the CUDA kernel, and what runs on CPU tensors."""
from __future__ import annotations

from typing import Sequence

import torch


def require_rows(num_rows: int, count: int) -> None:
    """An empty table has no row to take: raise IndexError for one or more
    positions, as the reference's ``jnp.take`` does."""
    if num_rows == 0 and count > 0:
        raise IndexError(f"cannot take {count} positions from a table of "
                         "0 rows")


def late_gather_ref(table: torch.Tensor, positions: torch.Tensor
                    ) -> torch.Tensor:
    """out[i] = table[positions[i]], a position in [-R, 0) counting from
    the end once (row p + R), as a JAX index does; a zero row where the
    position is >= R (the padding sentinel ``num_rows``) or < -R.  An empty
    table (R = 0) raises IndexError unless P = 0.

    table: (R, W) any dtype; positions: (P,) int32.  Returns (P, W)."""
    r = table.shape[0]
    require_rows(r, positions.shape[0])
    if r == 0:
        return table.new_zeros((0, table.shape[1]))
    p = positions.long()
    p = torch.where(p < 0, p + r, p)
    valid = (p >= 0) & (p < r)
    out = table.index_select(0, p.clamp(0, r - 1))
    return out.masked_fill(~valid[:, None], 0)


def late_gather_columns_ref(tables: Sequence[torch.Tensor],
                            positions: torch.Tensor) -> list[torch.Tensor]:
    """:func:`late_gather_ref` of each (R, W_c) table at one set of
    positions."""
    return [late_gather_ref(t, positions) for t in tables]
