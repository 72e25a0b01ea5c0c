"""CSR adjacency index — the engine's join index over ``edges.from``.

    perm    : (E,) int32 — edge positions sorted by their ``from`` vertex
    indptr  : (V+1,) int32 — per-vertex range into ``perm``

Lookup of "all edges with from == v" is the contiguous slice
``perm[indptr[v] : indptr[v+1]]``: positions in, positions out, no values
touched.  This is what makes the PRecursive expansion purely positional.

Every gather here clamps its indices explicitly: an out-of-range index on a
CUDA tensor is a device-side assert, not a clamped read.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CSRIndex", "build_csr", "expand_frontier", "csr_degrees",
           "merged_indptr", "bidir_degrees", "expand_frontier_both",
           "lane_cumsum", "lane_take"]


class CSRIndex(NamedTuple):
    indptr: torch.Tensor   # (V+1,) int32
    perm: torch.Tensor     # (E,)  int32 — edge positions grouped by source

    @property
    def num_vertices(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.perm.shape[0]


def build_csr(src: torch.Tensor, num_vertices: int) -> CSRIndex:
    """Build the index on ``src``'s device: a stable sort for ``perm``, a
    bincount plus cumsum for ``indptr``.  The counts follow the reference's
    dropping scatter-add: a negative source ``-k`` counts at ``V - k``, as
    a JAX index does, and a source still outside [0, V) is left out."""
    perm = torch.sort(src, stable=True).indices.to(torch.int32)
    wrapped = torch.where(src < 0, src + num_vertices, src)
    in_range = (wrapped >= 0) & (wrapped < num_vertices)
    bins = torch.where(in_range, wrapped, num_vertices).long()
    counts = torch.bincount(bins, minlength=num_vertices + 1)[:num_vertices]
    indptr = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                    device=src.device),
                        torch.cumsum(counts, 0, dtype=torch.int32)])
    return CSRIndex(indptr=indptr, perm=perm)


def csr_degrees(csr: CSRIndex, vertices: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
    v = vertices.clamp(0, csr.num_vertices - 1)
    deg = csr.indptr[v + 1] - csr.indptr[v]
    keep = valid & (vertices >= 0) & (vertices < csr.num_vertices)
    return torch.where(keep, deg, 0)


def expand_frontier(csr: CSRIndex, targets: torch.Tensor, valid: torch.Tensor,
                    capacity: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One BFS level: expand every live target vertex through the CSR index.

    For each live ``targets[i]`` emits the positions of all edges whose
    source is that vertex, concatenated in frontier order, padded to
    ``capacity`` with the sentinel ``E``.  Per-target degrees -> inclusive
    scan -> searchsorted inverts the scan so each output slot finds its
    producing target.  This is the plain version of the ``frontier_expand``
    kernel.

    Returns (edge_positions (capacity,), min(total, capacity),
    total > capacity), the last two as 0-d tensors.  ``(L, F)`` targets
    and flags (a batch of roots) expand each lane on its own: (L,
    capacity) positions and (L,) counts and flags."""
    f = targets.shape[-1]
    e = csr.num_edges
    deg = csr_degrees(csr, targets, valid)                        # (F,)
    ends = lane_cumsum(deg)                                       # inclusive
    starts = ends - deg
    total = ends[..., -1] if f > 0 else torch.zeros(
        targets.shape[:-1], dtype=torch.int32, device=targets.device)
    j = torch.arange(capacity, dtype=torch.int32, device=targets.device)
    if f == 0 or e == 0:
        return torch.full(targets.shape[:-1] + (capacity,), e,
                          dtype=torch.int32, device=targets.device), \
            total.clamp(max=capacity), total > capacity
    srcslot = _producing_slots(ends, j)
    within = j - lane_take(starts, srcslot)
    v = lane_take(targets, srcslot).clamp(0, csr.num_vertices - 1)
    epos = csr.perm[(csr.indptr[v] + within).clamp(0, e - 1)]
    live = j < total.clamp(max=capacity)[..., None]
    epos = torch.where(live, epos, e)                             # sentinel pad
    return epos, total.clamp(max=capacity), total > capacity


def lane_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum along the last axis.  With a lane axis it is
    one scan of the flattened lanes (in int64) less each lane's prefix: on
    the card a scan along a long last axis runs one row a block, about
    1.6 ms for 8 rows of 2^20 where the flat scan takes a few
    microseconds."""
    if x.dim() == 1:
        return torch.cumsum(x, 0, dtype=torch.int32)
    flat = torch.cumsum(x.reshape(-1), 0).view(x.shape)
    before = flat[..., -1:] - x.sum(-1, dtype=torch.int64, keepdim=True)
    return (flat - before).to(torch.int32)


def lane_take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]``, and with a lane axis each lane's row of ``arr`` at its
    own row of ``idx``."""
    return arr[idx] if arr.dim() == 1 else arr.gather(-1, idx.long())


def _producing_slots(ends: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """For each output slot ``j`` the frontier slot whose range holds it,
    ``#{ends <= j}`` clamped to the last slot (per lane with a lane
    axis)."""
    if ends.dim() > 1:
        j = j.expand(ends.shape[:-1] + j.shape).contiguous()
    srcslot = torch.searchsorted(ends, j, right=True, out_int32=True)
    return srcslot.clamp(max=ends.shape[-1] - 1)


# ---------------------------------------------------------------------------
# fused bidirectional CSR: ONE E-sized edge array per adjacency direction
# plus a merged indptr.  Join-space positions are 2E-VIRTUAL: p < E is edge
# p traversed forward, p >= E is edge p-E traversed backward.
# ---------------------------------------------------------------------------

def merged_indptr(out_csr: CSRIndex, in_csr: CSRIndex) -> torch.Tensor:
    """Per-vertex out-degree + in-degree, cumulated: (V+1,) int32."""
    out_deg = out_csr.indptr[1:] - out_csr.indptr[:-1]
    in_deg = in_csr.indptr[1:] - in_csr.indptr[:-1]
    return torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=out_deg.device),
        torch.cumsum(out_deg + in_deg, 0, dtype=torch.int32)])


def bidir_degrees(both_indptr: torch.Tensor, vertices: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Per-target merged (out+in) degree, masked like :func:`csr_degrees`."""
    nv = both_indptr.shape[0] - 1
    v = vertices.clamp(0, nv - 1)
    deg = both_indptr[v + 1] - both_indptr[v]
    return torch.where(valid & (vertices >= 0) & (vertices < nv), deg, 0)


def expand_frontier_both(out_csr: CSRIndex, in_csr: CSRIndex,
                         both_indptr: torch.Tensor, targets: torch.Tensor,
                         valid: torch.Tensor, capacity: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One BFS level over the fused bidirectional view: each target vertex
    emits its out-edge positions (forward, ``p``) followed by its in-edge
    positions (backward, ``E + p``).  Same contract as
    :func:`expand_frontier`, lane axis included; the join-space sentinel
    is ``2E``."""
    f = targets.shape[-1]
    e = out_csr.num_edges
    deg = bidir_degrees(both_indptr, targets, valid)              # (F,)
    ends = lane_cumsum(deg)
    starts = ends - deg
    total = ends[..., -1] if f > 0 else torch.zeros(
        targets.shape[:-1], dtype=torch.int32, device=targets.device)
    j = torch.arange(capacity, dtype=torch.int32, device=targets.device)
    if f == 0 or e == 0:
        return torch.full(targets.shape[:-1] + (capacity,), 2 * e,
                          dtype=torch.int32, device=targets.device), \
            total.clamp(max=capacity), total > capacity
    srcslot = _producing_slots(ends, j)
    within = j - lane_take(starts, srcslot)
    v = lane_take(targets, srcslot).clamp(0, out_csr.num_vertices - 1)
    out_deg = out_csr.indptr[v + 1] - out_csr.indptr[v]
    fwd = within < out_deg
    out_idx = (out_csr.indptr[v] + within).clamp(0, e - 1)
    in_idx = (in_csr.indptr[v] + within - out_deg).clamp(0, e - 1)
    epos = torch.where(fwd, out_csr.perm[out_idx], e + in_csr.perm[in_idx])
    live = j < total.clamp(max=capacity)[..., None]
    epos = torch.where(live, epos, 2 * e)                         # sentinel
    return epos, total.clamp(max=capacity), total > capacity
