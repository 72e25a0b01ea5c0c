"""Plain PyTorch version of the positional Materialize gather: the
correctness oracle of the CUDA kernel, and what runs on CPU tensors."""
from __future__ import annotations

import torch


def late_gather_ref(table: torch.Tensor, positions: torch.Tensor
                    ) -> torch.Tensor:
    """out[i] = table[positions[i]]; a zero row where positions[i] is not a
    row of the table (the sentinel ``num_rows``, or a negative position).

    table: (R, W) any dtype; positions: (P,) int32.  Returns (P, W)."""
    r = table.shape[0]
    valid = (positions >= 0) & (positions < r)
    out = table.index_select(0, positions.clamp(0, r - 1))
    return out.masked_fill(~valid[:, None], 0)
