"""Tree dataset generator mirroring the paper's experiment setup (§5.1).

A copy of the reference generator: the same numpy calls in the same order,
so the same seed gives the same arrays.  The table is an edge list with
columns ``id, from, to, name`` plus N auxiliary payload columns.  ``id`` is
a *permutation* of row positions, ``name`` a 15-char varchar and payloads
20-char varchars, emulated as fixed-width numeric columns of equivalent
byte width.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.table import payload_names

__all__ = ["TreeSpec", "random_tree_edges", "make_edge_table",
           "bfs_reference"]


class TreeSpec(NamedTuple):
    num_vertices: int
    height: int            # tree height (max BFS depth from root)
    payload_cols: int      # the paper's N
    seed: int = 0

    @property
    def num_edges(self) -> int:
        return self.num_vertices - 1


def random_tree_edges(spec: TreeSpec) -> tuple[np.ndarray, np.ndarray]:
    """Random tree with controlled height: vertices 1..V-1 attach to a parent
    drawn from the previous level (level widths split geometrically so the
    tree has exactly ``height`` levels when feasible)."""
    rng = np.random.default_rng(spec.seed)
    v, h = spec.num_vertices, max(1, spec.height)
    remaining = v - 1
    widths = []
    for lvl in range(h):
        levels_left = h - lvl
        if levels_left == 1:
            w = remaining
        else:
            lo = 1
            hi = max(1, remaining - (levels_left - 1))
            grow = min(hi, max(lo, int(remaining / levels_left * 1.5)))
            w = int(rng.integers(lo, grow + 1))
        widths.append(w)
        remaining -= w
    vid = np.arange(1, v)
    src = np.empty(v - 1, dtype=np.int64)
    prev = np.array([0])
    start = 1
    for w in widths:
        cur = vid[start - 1: start - 1 + w]
        src[start - 1: start - 1 + w] = rng.choice(prev, size=w)
        prev = cur
        start += w
    return src.astype(np.int32), vid.astype(np.int32)


def make_edge_table(spec: TreeSpec) -> dict[str, np.ndarray]:
    """The edge table as numpy columns (see ``convert.dataset_from_numpy``)."""
    rng = np.random.default_rng(spec.seed + 1)
    src, dst = random_tree_edges(spec)
    e = src.shape[0]
    ids = rng.permutation(e).astype(np.int32)
    cols = {
        "id": ids,
        "from": src,
        "to": dst,
        # name varchar(15) ~ 16 bytes -> 4 float32 slots
        "name": rng.standard_normal((e, 4)).astype(np.float32),
    }
    for pname in payload_names(spec.payload_cols):
        # varchar(20) ~ 20 bytes -> 5 float32 slots
        cols[pname] = rng.standard_normal((e, 5)).astype(np.float32)
    return cols


def bfs_reference(src: np.ndarray, dst: np.ndarray, root: int,
                  max_depth: int, num_vertices: int) -> list[set[int]]:
    """Pure-python oracle: per-level sets of emitted *edge positions* under
    BFS semantics (visited-vertex dedup), level 0 = edges out of root."""
    adj: list[list[int]] = [[] for _ in range(num_vertices)]
    for i, s in enumerate(src):
        adj[int(s)].append(i)
    visited = {int(root)}
    frontier = [int(root)]
    levels: list[set[int]] = []
    for _ in range(max_depth + 1):
        epos = [i for v in frontier for i in adj[v]]
        nxt = []
        emitted = set()
        for i in epos:
            t = int(dst[i])
            emitted.add(i)
            if t not in visited:
                visited.add(t)
                nxt.append(t)
        levels.append(emitted)
        frontier = nxt
        if not frontier:
            break
    return levels
