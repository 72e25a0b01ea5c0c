"""The boolean ⊕ of the reach workload.  The rest of the semiring value
plane comes with the weighted slice of the port."""
from __future__ import annotations

import torch

__all__ = ["or_combine"]


def or_combine(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor
               ) -> torch.Tensor:
    """Boolean scatter-or: ``arr[idx[i]] |= vals[i]``, spelled as the
    scatter-max it is in the reference.  ``scatter_reduce`` takes no bool, so
    the max runs on int32.  Indices outside [0, len(arr)) are dropped: they
    go to a spare slot that is sliced off.  ``arr`` is not modified."""
    n = arr.shape[0]
    in_range = (idx >= 0) & (idx < n)
    ext = torch.zeros((n + 1,), dtype=torch.int32, device=arr.device)
    ext[:n] = arr
    ext.scatter_reduce_(0, torch.where(in_range, idx, n).long(),
                        vals.to(torch.int32), "amax")
    return ext[:n].bool()
