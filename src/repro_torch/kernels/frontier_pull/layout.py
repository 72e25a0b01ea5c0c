"""The reverse layout that the ``frontier_pull`` kernel walks, built once per
dataset and orientation.

    ptr        : (V+1,) int32 — per-vertex range into ``nbr``
    nbr        : (E,)   int32 — the in-neighbor of each reverse-CSR entry,
                 clamped onto [0, V), in ``perm`` order
    tile_vtx   : (T,)   int32 — the owning vertex of each hub tile
    tile_start : (T,)   int32 — the first ``nbr`` entry of each hub tile

The reference clamps each entry's owner ``join_dst[perm]`` and in-neighbor
``join_src[perm]`` onto [0, V).  ``build_csr`` sorts the raw ids stably,
so the clamped owner is non-decreasing in ``perm`` order: negative ids sort
first and clamp to 0, ids >= V sort last and clamp to V - 1.  So
``nbr[ptr[v]:ptr[v+1]]`` holds exactly the entries the reference's
per-entry test gives to v, out-of-range ids included.  The reverse CSR's
own ``indptr`` can not serve: it counts a negative id -k at V - k.

A row of at most SHORT_ROW entries is walked by one thread; a longer row
(a hub) is cut into tiles of HUB_TILE entries, one warp each.  The tiles
are listed here, so the kernel needs no search.  About 4 (E + V) bytes
per orientation, 8 MiB at 2^20 edges.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.csr import CSRIndex

__all__ = ["HUB_TILE", "SHORT_ROW", "PullLayout", "build_pull_layout"]

SHORT_ROW = 16     # the longest row one thread walks
HUB_TILE = 256     # entries of one warp's tile of a longer row


class PullLayout(NamedTuple):
    ptr: torch.Tensor          # (V+1,) int32
    nbr: torch.Tensor          # (E,) int32
    tile_vtx: torch.Tensor     # (T,) int32
    tile_start: torch.Tensor   # (T,) int32

    @property
    def num_vertices(self) -> int:
        return self.ptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.nbr.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self)


def build_pull_layout(rcsr: CSRIndex, join_src: torch.Tensor,
                      join_dst: torch.Tensor, num_vertices: int
                      ) -> PullLayout:
    """The layout of the reverse CSR ``rcsr`` (grouping the join view's
    entries by ``join_dst``) on its device.  Raises ValueError when
    ``perm`` does not sort ``join_dst``: the per-vertex walk would then
    miss entries.  Syncs with the host twice (the order check and the hub
    count)."""
    nv = num_vertices
    if nv < 1:
        raise ValueError(f"a pull layout needs V >= 1, got {nv}")
    device = rcsr.perm.device
    vtx = join_dst[rcsr.perm].clamp(0, nv - 1).to(torch.int32)
    if vtx.shape[0] > 1 and not bool((vtx[1:] >= vtx[:-1]).all()):
        raise ValueError("the reverse CSR's perm does not sort join_dst: "
                         "build it with build_csr over join_dst")
    nbr = join_src[rcsr.perm].clamp(0, nv - 1).to(torch.int32)
    ptr = torch.searchsorted(
        vtx, torch.arange(nv + 1, dtype=torch.int32, device=device),
        out_int32=True)
    deg = ptr[1:] - ptr[:-1]
    hubs = torch.nonzero(deg > SHORT_ROW).flatten()
    per_hub = ((deg[hubs] + HUB_TILE - 1) // HUB_TILE).long()
    tile_vtx = torch.repeat_interleave(hubs, per_hub)
    first = torch.repeat_interleave(torch.cumsum(per_hub, 0) - per_hub,
                                    per_hub)
    within = torch.arange(tile_vtx.shape[0], device=device) - first
    tile_start = ptr[tile_vtx] + within * HUB_TILE
    return PullLayout(ptr=ptr, nbr=nbr, tile_vtx=tile_vtx.to(torch.int32),
                      tile_start=tile_start.to(torch.int32))
