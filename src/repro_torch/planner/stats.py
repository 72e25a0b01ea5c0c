"""Graph statistics for the planner: degree histograms, frontier-growth
samples, and density/shape estimates, computed once per (Dataset, direction)
and cached on the Dataset (:meth:`repro_torch.core.engine.Dataset.stats`).

Everything here runs in numpy on the host — statistics are a build-time
artifact, like the CSR index, not a per-query cost.  The join columns come
to the host once per pass (``.cpu().numpy()``) from whichever device the
``Dataset`` lives on, so the numbers do not depend on the device.  The
frontier profile is measured, not modeled: a handful of deterministic
sample roots are traversed level by level, recording how many edges each
level emits and how many new vertices it discovers.  Those two per-level
series are exactly the cardinalities every operator's
:meth:`~repro_torch.core.operators.Operator.estimate` needs.

Two refinements feed the batched serving path:

* **root-conditional estimates** (:meth:`GraphStats.estimate_root`,
  :func:`root_estimates`): the per-sample-root profiles are kept, so a query
  root that WAS sampled gets its exact measured reach/depth; any other root
  gets the mean profile rescaled by its own out-degree (level 0 is exact —
  it is the degree — and later levels are degree-conditioned).  These are
  what the planner buckets a batch of roots by.
* **walk profiles** (``level_walk_edges``): raw UNION ALL semantics count
  *paths*, not vertices, so a cyclic or reconverging graph can legally emit
  far more than E rows within a depth bound.  The walk profile propagates
  per-vertex path counts level by level (one ``bincount`` per level) and is
  what sizes non-dedup result buffers.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

__all__ = ["GraphStats", "RootEstimate", "compute_stats", "root_estimates"]

_MAX_SAMPLE_ROOTS = 6
_MAX_SAMPLE_LEVELS = 64
_MAX_WALK_LEVELS = 40
_WALK_COUNT_CEIL = 1e15
_HIST_BUCKETS = 16


class RootEstimate(NamedTuple):
    """Predicted traversal shape for ONE root (depth-bounded).

    ``exact`` is True when the root was one of the sampled profile roots —
    then the numbers are measured, not modeled."""

    root: int
    reach_rows: float       # edge rows a depth-bounded BFS emits
    max_level_rows: float   # widest single level
    depth: int              # levels until the frontier dies (<= max_depth)
    exact: bool


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Per-direction statistics of one prepared :class:`Dataset`."""

    direction: str
    num_vertices: int
    num_edges: int                     # join-space edge count (2E for 'both')
    density: float                     # E / V
    avg_degree: float                  # mean out-degree of source vertices
    max_degree: int
    degree_histogram: Tuple[int, ...]  # log2-bucketed out-degrees (deg >= 1)
    is_forest: bool                    # unique-path graph: UNION ALL == BFS
    sample_roots: Tuple[int, ...]
    level_edges: Tuple[float, ...]     # mean edges emitted at level l
    level_vertices: Tuple[float, ...]  # mean new vertices found at level l
    max_level_edges: int               # widest level over all samples
    reach_edges: float                 # mean edges reached per sample root
    max_levels: int                    # longest sampled traversal
    root_profiles: Tuple[Tuple[int, Tuple[int, ...]], ...] = ()
    #   (root, edges-per-level) for EACH sample root — the exact branch of
    #   the root-conditional estimator
    level_walk_edges: Tuple[float, ...] = ()
    #   worst sampled UNION-ALL walk rows (path counts) emitted at level l

    def edges_at(self, level: int) -> float:
        if 0 <= level < len(self.level_edges):
            return self.level_edges[level]
        return 0.0

    def vertices_at(self, level: int) -> float:
        if 0 <= level < len(self.level_vertices):
            return self.level_vertices[level]
        return 0.0

    def total_edges(self, max_depth: int) -> float:
        """Expected result cardinality of a depth-bounded BFS."""
        return float(sum(self.level_edges[: max_depth + 1]))

    @property
    def _walk_sample_truncated(self) -> bool:
        """True iff the walk sample was CUT (level horizon or count
        ceiling) rather than terminated by the frontier dying — only a cut
        sample justifies extrapolating past its end."""
        w = self.level_walk_edges
        return bool(w) and (len(w) >= _MAX_WALK_LEVELS
                            or w[-1] >= _WALK_COUNT_CEIL)

    def _walk_levels(self, max_depth: int) -> list[float]:
        """Per-level walk rows up to ``max_depth``, geometrically
        extrapolated past the sampled horizon ONLY when the sample was
        truncated (walks on cyclic graphs never die, so their sample is
        cut, not terminated; a terminated walk contributes nothing past
        its last level)."""
        w = list(self.level_walk_edges[: max_depth + 1])
        n = max_depth + 1 - len(w)
        if (n > 0 and self._walk_sample_truncated
                and len(self.level_walk_edges) >= 2 and w and w[-1] > 0):
            tail = self.level_walk_edges[-2:]
            ratio = tail[1] / tail[0] if tail[0] > 0 else 1.0
            if ratio > 1.0:      # still growing when the sample was cut
                cur = w[-1]
                for _ in range(n):
                    cur = min(cur * ratio, _WALK_COUNT_CEIL)
                    w.append(cur)
        return w

    def total_walk_rows(self, max_depth: int) -> float:
        """Expected result cardinality of a depth-bounded raw UNION ALL
        walk (path-count semantics — can far exceed ``num_edges``)."""
        return float(min(sum(self._walk_levels(max_depth)),
                         _WALK_COUNT_CEIL))

    def max_walk_level_rows(self, max_depth: int) -> float:
        """Widest single walk level within the depth bound."""
        return float(max(self._walk_levels(max_depth), default=0.0))

    def estimate_root(self, root: int, out_degree: int, max_depth: int
                      ) -> RootEstimate:
        """Root-conditional reach/depth prediction (BFS semantics).

        Exact when ``root`` was a sample root; otherwise the mean profile is
        rescaled by ``out_degree`` (level 0 IS the degree; deeper levels are
        degree-conditioned and clamped to the graph totals)."""
        for r, prof in self.root_profiles:
            if r == root:
                lv = [float(x) for x in prof[: max_depth + 1]]
                return RootEstimate(
                    root=root,
                    reach_rows=float(sum(lv)),
                    max_level_rows=float(max(lv, default=0.0)),
                    depth=len(lv), exact=True)
        if out_degree <= 0:
            return RootEstimate(root=root, reach_rows=0.0,
                                max_level_rows=0.0, depth=0, exact=True)
        base = self.level_edges[0] if self.level_edges else 0.0
        scale = out_degree / base if base > 0 else 1.0
        lv = [float(out_degree)]
        for l in range(1, max_depth + 1):
            x = self.edges_at(l) * scale
            if x <= 0.0:
                break
            lv.append(min(x, float(self.num_edges)))
        return RootEstimate(
            root=root,
            reach_rows=float(min(sum(lv), self.num_edges)),
            max_level_rows=float(min(max(lv), self.num_edges)),
            depth=len(lv), exact=False)


def _chains_terminate(heads: np.ndarray, tails: np.ndarray,
                      num_vertices: int) -> bool:
    """Given a functional map (each head has at most one tail), True iff
    every chain escapes to the sentinel — i.e. no cycle.  Pointer doubling:
    tree vertices saturate at the sentinel, ring vertices chase forever."""
    v = num_vertices
    step = np.full(v + 1, v, dtype=np.int64)
    step[heads] = tails
    step[v] = v
    hops = 1
    while hops < v:
        step = step[step]
        hops *= 2
    return bool((step[:v] == v).all())


def _is_forest(src: np.ndarray, dst: np.ndarray, num_vertices: int) -> bool:
    """True iff every vertex is reachable by AT MOST ONE path from any
    single root — the regime where raw UNION ALL walks and BFS dedup
    coincide.  That holds when the graph is acyclic and either never
    reconverges (in-degree <= 1: a forest) or never branches (out-degree
    <= 1: e.g. a reversed forest, whose frontier is always one vertex)."""
    if dst.size == 0:
        return True
    indeg = np.bincount(dst, minlength=num_vertices)
    if indeg.max() <= 1:
        return _chains_terminate(dst, src, num_vertices)
    outdeg = np.bincount(src, minlength=num_vertices)
    if outdeg.max() <= 1:
        return _chains_terminate(src, dst, num_vertices)
    return False


def _bfs_profile(src: np.ndarray, dst: np.ndarray, root: int,
                 num_vertices: int, max_levels: int
                 ) -> tuple[list[int], list[int]]:
    """One sampled traversal: (edges emitted, new vertices) per level."""
    visited = np.zeros(num_vertices, bool)
    frontier = np.zeros(num_vertices, bool)
    visited[root] = frontier[root] = True
    edges, verts = [], []
    for _ in range(max_levels):
        hit = frontier[src]
        s = int(hit.sum())
        if s == 0:
            break
        new = np.zeros(num_vertices, bool)
        new[dst[hit]] = True
        new &= ~visited
        visited |= new
        edges.append(s)
        verts.append(int(new.sum()))
        frontier = new
    return edges, verts


def _walk_profile(src: np.ndarray, dst: np.ndarray, root: int,
                  num_vertices: int, max_levels: int) -> list[float]:
    """Raw UNION ALL walk rows per level: propagate per-vertex PATH counts
    (floats, capped — walks on cyclic graphs grow without bound)."""
    c = np.zeros(num_vertices)
    c[root] = 1.0
    rows = []
    for _ in range(max_levels):
        w = c[src]                       # walk count carried by each edge
        lvl = float(w.sum())
        if lvl <= 0.0:
            break
        rows.append(min(lvl, _WALK_COUNT_CEIL))
        if lvl >= _WALK_COUNT_CEIL:
            break
        c = np.bincount(dst, weights=w, minlength=num_vertices)
    return rows


def _pick_roots(src: np.ndarray, num_vertices: int) -> np.ndarray:
    """Deterministic sample roots: source vertices spread across the id
    range (always includes the smallest source vertex — the benchmark and
    example root)."""
    outdeg = np.bincount(src, minlength=num_vertices)
    cand = np.flatnonzero(outdeg > 0)
    if cand.size == 0:
        return np.zeros(1, dtype=np.int64)
    take = min(_MAX_SAMPLE_ROOTS, cand.size)
    idx = np.linspace(0, cand.size - 1, num=take).astype(np.int64)
    return cand[np.unique(idx)]


def compute_stats(ds, direction: str = "outbound") -> GraphStats:
    """Compute (host-side) the planner statistics for one direction view.
    Called through :meth:`Dataset.stats`, which caches the result.

    ``compute_stats.calls`` counts executions process-wide — the serving
    session's ``stats_calls`` counter (and the plan-store tests asserting a
    rehydrated session pays ZERO statistics passes) read it."""
    compute_stats.calls += 1
    ctx = ds.context(direction)
    src = ctx.join_src.cpu().numpy().astype(np.int64)
    dst = ctx.join_dst.cpu().numpy().astype(np.int64)
    if ctx.bidir:
        # the fused 'both' view keeps E-sized columns on device; the
        # HOST-side statistics pass materializes the virtual 2E join space
        # transiently (same numbers the old doubled view produced)
        src, dst = (np.concatenate([src, dst]), np.concatenate([dst, src]))
    v = int(ds.num_vertices)
    e = int(src.shape[0])

    outdeg = np.bincount(src, minlength=v)
    nonzero = outdeg[outdeg > 0]
    hist = np.zeros(_HIST_BUCKETS, dtype=np.int64)
    if nonzero.size:
        buckets = np.minimum(np.log2(nonzero).astype(np.int64),
                             _HIST_BUCKETS - 1)
        np.add.at(hist, buckets, 1)

    roots = _pick_roots(src, v)
    profiles = [_bfs_profile(src, dst, int(r), v, _MAX_SAMPLE_LEVELS)
                for r in roots]
    depth = max((len(p[0]) for p in profiles), default=0)
    level_edges = np.zeros(depth)
    level_verts = np.zeros(depth)
    for edges, verts in profiles:
        level_edges[:len(edges)] += edges
        level_verts[:len(verts)] += verts
    level_edges /= max(len(profiles), 1)
    level_verts /= max(len(profiles), 1)
    max_level = max((max(p[0]) for p in profiles if p[0]), default=0)

    # capacity is sized from walks, so take the WORST sampled root per level
    walks = [_walk_profile(src, dst, int(r), v, _MAX_WALK_LEVELS)
             for r in roots]
    wdepth = max((len(w) for w in walks), default=0)
    walk_edges = np.zeros(wdepth)
    for w in walks:
        walk_edges[:len(w)] = np.maximum(walk_edges[:len(w)], w)

    return GraphStats(
        direction=direction,
        num_vertices=v,
        num_edges=e,
        density=e / max(v, 1),
        avg_degree=float(nonzero.mean()) if nonzero.size else 0.0,
        max_degree=int(outdeg.max()) if v else 0,
        degree_histogram=tuple(int(x) for x in hist),
        is_forest=_is_forest(src, dst, v),
        sample_roots=tuple(int(r) for r in roots),
        level_edges=tuple(float(x) for x in level_edges),
        level_vertices=tuple(float(x) for x in level_verts),
        max_level_edges=int(max_level),
        reach_edges=float(sum(sum(p[0]) for p in profiles)
                          / max(len(profiles), 1)),
        max_levels=depth,
        root_profiles=tuple(
            (int(r), tuple(int(x) for x in p[0]))
            for r, p in zip(roots, profiles)),
        level_walk_edges=tuple(float(x) for x in walk_edges),
    )


compute_stats.calls = 0


def root_estimates(ds, direction: str, roots: Sequence[int], max_depth: int
                   ) -> list[RootEstimate]:
    """Root-conditional estimates for a whole batch of roots: exact for
    sampled roots, degree-conditioned otherwise.  Out-degrees come straight
    from the direction view's CSR ``indptr``: two entries per root,
    gathered on the dataset's device and read back in one copy."""
    stats = ds.stats(direction)
    ctx = ds.context(direction)
    indptr = ctx.both_indptr if ctx.bidir else ctx.csr.indptr
    v = stats.num_vertices
    roots = np.asarray(roots, dtype=np.int64).reshape(-1)
    ok = (roots >= 0) & (roots < v)
    at = torch.as_tensor(np.where(ok, roots, 0), device=indptr.device)
    deg = np.where(ok, (indptr[at + 1] - indptr[at]).cpu().numpy(), 0)
    return [stats.estimate_root(int(r), int(d), max_depth)
            for r, d in zip(roots, deg)]
