"""Plain PyTorch versions of the bottom-up (pull) frontier step.

:func:`frontier_pull_ref` is also the engine's reverse-CSR pull where no
kernel is plugged in (``_dense_pull`` in :mod:`repro_torch.core.operators`,
non-bidirectional branch): per reverse-adjacency entry, test the
in-neighbor's frontier membership under the unvisited candidate mask, then
segment-OR per owning vertex.  :func:`frontier_pull_layout_ref` computes
the same mask from the kernel's :class:`PullLayout`, per vertex.

:func:`pull_case` makes the seeded inputs that take the kernel through its
thread rows, its hub tiles and the clamped ids, and :func:`pull_lanes_case`
stacks each as the lanes of one batched call, shared by the CPU parity
tests, the card tests and ``chip_smoke.py``.  Both plain versions take a
leading lane axis."""
from __future__ import annotations

import numpy as np
import torch

from ...core.csr import CSRIndex
from ...core.semiring import or_combine
from .layout import HUB_TILE, SHORT_ROW, PullLayout


def frontier_pull_ref(rcsr: CSRIndex, join_src: torch.Tensor,
                      join_dst: torch.Tensor, frontier: torch.Tensor,
                      visited: torch.Tensor) -> torch.Tensor:
    """(V,) bool frontier and visited -> the (V,) next frontier; (L, V)
    planes pull each lane over the one shared reverse CSR."""
    nv = frontier.shape[-1]
    cand = ~visited
    perm = rcsr.perm
    nbr = join_src[perm].clamp(0, nv - 1)
    vtx = join_dst[perm].clamp(0, nv - 1)
    contrib = cand[..., vtx] & frontier[..., nbr]
    nxt = or_combine(torch.zeros_like(frontier), vtx, contrib)
    return nxt & cand


def frontier_pull_layout_ref(layout: PullLayout, frontier: torch.Tensor,
                             visited: torch.Tensor) -> torch.Tensor:
    """``out[v] = ~visited[v] & any(frontier[nbr[ptr[v]:ptr[v+1]]])``: a
    vertex's row holds a frontier entry iff the running count of frontier
    entries grows across it.  (L, V) planes give each lane's row."""
    hits = frontier[..., layout.nbr].to(torch.int32)
    seen = torch.cat([hits.new_zeros(hits.shape[:-1] + (1,)),
                      torch.cumsum(hits, -1, dtype=torch.int32)], -1)
    return (seen[..., layout.ptr[1:]] > seen[..., layout.ptr[:-1]]) \
        & ~visited


# The cases of :func:`pull_case`.
PULL_CASES = ("random", "hub_early", "hub_last", "tile_edges",
              "out_of_range", "v_ragged", "empty_frontier", "all_visited",
              "e0")
HUB = 7                                  # the hub of the hub cases
# owner -> row length of ``tile_edges``: at and beside the thread row's
# limit and the tile's, and one row over two tiles
TILE_ROWS = {3: SHORT_ROW, 4: SHORT_ROW + 1, 5: HUB_TILE, 6: HUB_TILE + 1,
             8: 2 * HUB_TILE + 1}
NO_HIT = 8                               # the ``tile_edges`` row no entry hits


def pull_case(case: str):
    """Seeded host inputs of one pull level: (src (E,) int32, dst (E,)
    int32, frontier (V,) bool, visited (V,) bool), numpy arrays.  V =
    1,024 and E = 4,000 random edges, a random frontier of about 30% of
    the vertices and about 40% more visited, except:

    - ``hub_early`` / ``hub_last``: vertex 7 is unvisited and owns a row of
      3,001 entries (12 tiles, the last one short), appended after the
      other edges; its first entry's in-neighbor is in the frontier, or
      only its last one is;
    - ``tile_edges``: rows of 16, 17, 256, 257 and 513 entries on unvisited
      vertices 3, 4, 5, 6 and 8, each hit only at its last entry, except
      vertex 8, which no entry hits;
    - ``out_of_range``: ids in [-5, V + 5) in both columns, with vertices
      0 and V - 1 in the frontier and unvisited;
    - ``v_ragged``: V = 769, three blocks of 256 and one vertex;
    - ``empty_frontier``, ``all_visited``; ``e0``: no edges."""
    if case not in PULL_CASES:
        raise ValueError(f"unknown case {case!r}; have {PULL_CASES}")
    rng = np.random.default_rng(PULL_CASES.index(case) + 60)
    v = 769 if case == "v_ragged" else 1024
    e = 0 if case == "e0" else 4000
    lo, hi = (-5, v + 5) if case == "out_of_range" else (0, v)
    src = rng.integers(lo, hi, e).astype(np.int32)
    dst = rng.integers(lo, hi, e).astype(np.int32)
    frontier = rng.random(v) < 0.3
    visited = (rng.random(v) < 0.4) | frontier
    rows = {"hub_early": {HUB: 3001}, "hub_last": {HUB: 3001},
            "tile_edges": TILE_ROWS}.get(case, {})
    if rows:
        frontier[list(rows)] = False
        hot = np.flatnonzero(frontier)
        cold = np.setdiff1d(np.flatnonzero(~frontier), list(rows))
        # the long rows hold only the entries appended here
        dst = np.where(np.isin(dst, list(rows)), 0, dst).astype(np.int32)
        for owner, n in rows.items():
            nbr = rng.choice(cold, n)
            if case == "hub_early":
                nbr = np.concatenate([rng.choice(hot, 1),
                                      rng.integers(0, v, n - 1)])
            elif owner != NO_HIT:
                nbr[-1] = rng.choice(hot)
            src = np.concatenate([src, nbr.astype(np.int32)])
            dst = np.concatenate([dst, np.full(n, owner, np.int32)])
        visited[list(rows)] = False
    elif case == "out_of_range":
        frontier[[0, v - 1]] = True
        visited[[0, v - 1]] = False
    elif case == "empty_frontier":
        frontier[:] = False
    elif case == "all_visited":
        visited[:] = True
    return src, dst, frontier, visited


def pull_lanes_case(case: str):
    """:func:`pull_case` stacked as four lanes of one call over its graph:
    (src, dst, frontier (4, V), visited (4, V)).  Lane 0 is the case; lane
    1 has an empty frontier; lane 2's frontier is lane 0's moved on by one
    vertex, with it visited; lane 3 has visited only its frontier, so
    every other vertex is open."""
    src, dst, frontier, visited = pull_case(case)
    moved = np.roll(frontier, 1)
    return (src, dst,
            np.stack([frontier, np.zeros_like(frontier), moved, frontier]),
            np.stack([visited, visited, visited | moved, frontier]))
