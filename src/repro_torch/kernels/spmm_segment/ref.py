"""Plain PyTorch version of the fused gather-scale-segment-sum (SpMM).

It is also the engine's CPU combine wherever a caller plugs the kernel
wrapper in: gather, then scale, then one ``index_add_``."""
from __future__ import annotations

import torch


def spmm_segment_ref(x: torch.Tensor, src: torch.Tensor, seg: torch.Tensor,
                     weights: torch.Tensor, num_out: int) -> torch.Tensor:
    """out[v] = sum_{e: seg[e]=v} weights[e] * x[src[e]].

    ``x`` (N, D) features; ``src``/``seg`` (E,) int32 (``seg`` is the
    destination, in any order); ``weights`` (E,).  A ``src`` outside
    [0, N) is padding and contributes zero (callers pad with N); a ``seg``
    outside [0, num_out) is dropped.  Rows with no edge are zero."""
    n, d = x.shape
    live = (src >= 0) & (src < n)
    rows = x[src.clamp(0, n - 1).long()]
    rows = torch.where(live[:, None], rows, 0.0) * weights[:, None]
    slot = torch.where((seg >= 0) & (seg < num_out), seg, num_out).long()
    out = x.new_zeros((num_out + 1, d)).index_add_(0, slot, rows)
    return out[:num_out]
