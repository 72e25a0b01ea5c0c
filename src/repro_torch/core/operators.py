"""Positional operator algebra + the fixed-point driver (PRecursive subset).

The paper's positional recursive CTE (Fig. 4) is a :class:`Pipeline`: a
seed operator, a tuple of per-level operators and a finisher, run by ONE
:func:`fixed_point` driver.  This slice of the port carries the operators
the PRecursive plan uses:

===================  ======================================================
``Seed``             the non-recursive CTE child (Filter on the root)
``ReadTargets``      per-level read of the join column out of the frontier
                     positions (one column gather)
``VisitedDedup``     BFS vertex dedup (visited bitmap + scatter-argmin)
``CSRIndexJoin``     Fig. 4's IndexJoin: frontier vertices -> edge positions
                     through the CSR join index
``AppendUnionAll``   the recursive UNION ALL: append the level block to the
                     working result, tagging each row with its BFS level
``LateMaterialize``  Fig. 4's single post-fixed-point Materialize
===================  ======================================================

Direction: the join view (``ctx.join_src``/``ctx.join_dst`` and the CSR
over ``join_src``) decides it.  ``outbound`` uses (from, to); ``inbound``
the reverse; ``both`` the FUSED bidirectional view (``ctx.bidir``) with a
VIRTUAL 2E join space (position ``p < E`` is edge ``p`` forward, ``p >= E``
backward) folded back onto real edges at append time.

Every gather clamps its indices and every dropping scatter routes dropped
entries to a spare slot: torch on CUDA asserts where JAX clamps or drops.
Public fields stay int32, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .csr import CSRIndex, expand_frontier, expand_frontier_both
from .positions import PosBlock, append_block, compact_mask
from .semiring import or_combine
from .table import ColumnTable

__all__ = [
    "DIRECTIONS", "check_direction", "EngineCaps", "BFSResult", "Context",
    "TraversalState", "Operator", "Seed", "ReadTargets", "VisitedDedup",
    "CSRIndexJoin", "AppendUnionAll", "LateMaterialize", "Pipeline",
    "fixed_point", "execute", "dedup_targets",
]

DIRECTIONS = ("outbound", "inbound", "both")


def check_direction(direction: str) -> None:
    if direction not in DIRECTIONS:
        raise ValueError(f"unknown direction {direction!r}; "
                         f"expected one of {DIRECTIONS}")


class EngineCaps(NamedTuple):
    """Static buffer capacities (the Volcano block sizes)."""

    frontier: int   # max edges emitted by a single BFS level
    result: int     # max edges in the full result


class BFSResult(NamedTuple):
    values: Dict[str, torch.Tensor]   # (result_cap, ...) materialized outputs
    positions: torch.Tensor           # (result_cap,) int32 edge positions
    count: torch.Tensor               # () int32 live rows
    depth: torch.Tensor               # () int32 levels actually executed
    overflow: torch.Tensor            # () bool any capacity overflow observed
    row_depths: Optional[torch.Tensor] = None   # (result_cap,) int32 level


@dataclasses.dataclass(frozen=True)
class Context:
    """Runtime inputs of a pipeline: storage + the direction-resolved join
    view.  ``join_src`` is the column the CSR indexes; ``join_dst`` holds the
    next vertex reached by each join-space edge.  ``rcsr`` is the reverse
    CSR of the join view; ``bidir=True`` selects the fused bidirectional
    view for ``direction='both'`` with ``both_indptr`` the merged out+in
    indptr."""

    table: ColumnTable
    csr: CSRIndex
    join_src: torch.Tensor
    join_dst: torch.Tensor
    rcsr: Optional[CSRIndex] = None
    both_indptr: Optional[torch.Tensor] = None
    bidir: bool = False


class TraversalState(NamedTuple):
    """The state the PRecursive operators share across levels."""

    frontier_pos: torch.Tensor     # (F,) int32 join-space edge positions
    frontier_count: torch.Tensor   # () int32 live frontier entries
    targets: torch.Tensor          # (F,) int32 target vertices
    keep: torch.Tensor             # (F,) bool survivors of dedup
    visited: torch.Tensor          # (V,) bool BFS visited set
    result_pos: torch.Tensor       # (R,) int32 real result positions
    result_depth: torch.Tensor     # (R,) int32 BFS level per result row
    result_count: torch.Tensor     # () int32
    depth: torch.Tensor            # () int32 levels executed
    overflow: torch.Tensor         # () bool


# ---------------------------------------------------------------------------
# shared primitives
# ---------------------------------------------------------------------------

def dedup_targets(targets: torch.Tensor, valid: torch.Tensor,
                  visited: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """BFS vertex dedup: drop already-visited targets and, within the level,
    keep only the first occurrence of each vertex (scatter-argmin ticket).

    Returns (keep_mask, new_visited)."""
    cap = targets.shape[0]
    nv = visited.shape[0]
    safe = targets.clamp(0, nv - 1)
    fresh = valid & ~visited[safe]
    slots = torch.arange(cap, dtype=torch.int32, device=targets.device)
    ticket = torch.full((nv,), cap, dtype=torch.int32, device=targets.device)
    ticket.scatter_reduce_(0, safe.long(), torch.where(fresh, slots, cap),
                           "amin")
    keep = fresh & (ticket[safe] == slots)
    return keep, or_combine(visited, safe, keep)


def _num_join(ctx: Context) -> int:
    """Join-space edge count EJ (2E under the fused bidirectional view —
    virtual: no 2E array backs it)."""
    n = ctx.join_src.shape[0]
    return 2 * n if ctx.bidir else n


def _to_real(ctx: Context, pos: torch.Tensor) -> torch.Tensor:
    """Fold join-space positions back to real edge positions: identity for
    outbound/inbound; under 'both' the backward copy of edge ``p`` (``E +
    p``) folds to ``p`` and the join-space sentinel ``2E`` to ``E``."""
    if not ctx.bidir:
        return pos
    e = ctx.table.num_rows
    return torch.where(pos < e, pos, pos - e)


def _join_dst_at(ctx: Context, pos: torch.Tensor) -> torch.Tensor:
    """The next-vertex column of the join view gathered at join-space
    positions (callers mask invalid lanes themselves).  Under the fused view
    forward positions resolve through ``to``, backward ones through
    ``from``."""
    if not ctx.bidir:
        ej = ctx.join_src.shape[0]
        return ctx.join_dst[pos.clamp(0, ej - 1)]
    e = ctx.join_src.shape[0]
    fwd = pos < e
    p = torch.where(fwd, pos, pos - e).clamp(0, e - 1)
    return torch.where(fwd, ctx.join_dst[p], ctx.join_src[p])


def _seed_mask(ctx: Context, root: int) -> torch.Tensor:
    """(EJ,) mask of join edges whose source is the root (the seed filter).
    Fused view: forward matches on ``from``, backward on ``to``."""
    if not ctx.bidir:
        return ctx.join_src == root
    return torch.cat([ctx.join_src == root, ctx.join_dst == root])


def _expand_join(ctx: Context, targets: torch.Tensor, keep: torch.Tensor,
                 capacity: int, expand_fn=None):
    """CSR expansion over the join view: ``expand_fn`` (the kernel wrapper)
    or the plain expansion over the direction CSR, or the fused
    bidirectional expansion when ``bidir`` (which takes no kernel, as in
    the reference)."""
    if ctx.bidir:
        return expand_frontier_both(ctx.csr, ctx.rcsr, ctx.both_indptr,
                                    targets, keep, capacity)
    expand = expand_fn or expand_frontier
    return expand(ctx.csr, targets, keep, capacity)


def _tag_depths(result_depth: torch.Tensor, count: torch.Tensor,
                block_cap: int, block_count: torch.Tensor, tag: torch.Tensor
                ) -> torch.Tensor:
    """Record the BFS level of every row the current append makes live."""
    cap_r = result_depth.shape[0]
    idx = torch.arange(block_cap, dtype=torch.int32,
                       device=result_depth.device)
    slots = count + idx
    live = (idx < block_count) & (slots < cap_r)
    ext = torch.cat([result_depth, result_depth.new_zeros((1,))])
    ext.scatter_(0, torch.where(live, slots, cap_r).long(),
                 tag.to(torch.int32).expand(block_cap))
    return ext[:cap_r]


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

class Operator:
    """Base operator: ``init`` runs once before the fixed point (seed-block
    handling), ``step`` once per level."""

    def init(self, ctx: Context, state: TraversalState, root: int
             ) -> TraversalState:
        return state

    def step(self, ctx: Context, state: TraversalState) -> TraversalState:
        return state


@dataclasses.dataclass(frozen=True)
class Seed(Operator):
    """The non-recursive child of the CTE: Filter[join_src = root]
    compacted to a position block, with the root marked visited."""

    def init(self, ctx, state, root):
        nv = state.visited.shape[0]
        visited = state.visited.clone()
        visited[min(max(root, 0), nv - 1)] = True
        blk = compact_mask(_seed_mask(ctx, root), state.frontier_pos.shape[0],
                           _num_join(ctx))
        return state._replace(frontier_pos=blk.positions,
                              frontier_count=blk.count, visited=visited)


@dataclasses.dataclass(frozen=True)
class ReadTargets(Operator):
    """Per-level read of the join column out of the frontier positions: the
    ONLY per-level value gather of the positional plan (one column)."""

    def step(self, ctx, state):
        cap = state.targets.shape[0]
        valid = torch.arange(cap, dtype=torch.int32,
                             device=state.targets.device) < state.frontier_count
        t = _join_dst_at(ctx, state.frontier_pos)
        return state._replace(targets=torch.where(valid, t, -1), keep=valid)


@dataclasses.dataclass(frozen=True)
class VisitedDedup(Operator):
    """BFS semantics: a vertex expands at most once (visited bitmap +
    within-level scatter-argmin)."""

    def step(self, ctx, state):
        keep, visited = dedup_targets(state.targets, state.keep,
                                      state.visited)
        return state._replace(targets=torch.where(keep, state.targets, -1),
                              keep=keep, visited=visited)


@dataclasses.dataclass(frozen=True)
class CSRIndexJoin(Operator):
    """Fig. 4's IndexJoin: expand frontier vertices into the positions of
    their out-edges through the CSR join index — positions in, positions
    out, no values touched.  ``expand_fn`` plugs in the kernel."""

    expand_fn: Optional[Callable] = None

    def step(self, ctx, state):
        cap = state.frontier_pos.shape[0]
        epos, total, ovf = _expand_join(ctx, state.targets, state.keep, cap,
                                        self.expand_fn)
        return state._replace(frontier_pos=epos, frontier_count=total,
                              overflow=state.overflow | ovf)


@dataclasses.dataclass(frozen=True)
class AppendUnionAll(Operator):
    """The recursive UNION ALL over positions: append the level's block to
    the working result, tagging every appended row with its BFS level.
    ``init`` appends the seed block as level 0; ``step`` appends level
    ``depth + 1``."""

    def init(self, ctx, state, root):
        return self._append(ctx, state, state.depth)

    def step(self, ctx, state):
        return self._append(ctx, state, state.depth + 1)

    def _append(self, ctx, state, tag):
        block = PosBlock(_to_real(ctx, state.frontier_pos),
                         state.frontier_count)
        rpos, rcount, ovf = append_block(state.result_pos,
                                         state.result_count, block)
        rdepth = _tag_depths(state.result_depth, state.result_count,
                             block.capacity, block.count, tag)
        return state._replace(result_pos=rpos, result_count=rcount,
                              result_depth=rdepth,
                              overflow=state.overflow | ovf)


@dataclasses.dataclass(frozen=True)
class LateMaterialize:
    """Fig. 4's single Materialize after the fixed point — the paper's core
    win: ALL output columns gathered exactly once, from positions."""

    cols: Tuple[str, ...]

    def finish(self, ctx, pipeline, state):
        values = ctx.table.take(state.result_pos, self.cols)
        return BFSResult(values, state.result_pos, state.result_count,
                         state.depth, state.overflow, state.result_depth)


# ---------------------------------------------------------------------------
# the pipeline + the fixed-point driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pipeline:
    """A declarative recursive plan: seed, per-level operators, finisher."""

    name: str
    seed: Seed
    ops: Tuple[Operator, ...]
    finisher: LateMaterialize
    caps: EngineCaps
    max_depth: int


def _initial_state(pipeline: Pipeline, ctx: Context, num_vertices: int
                   ) -> TraversalState:
    cap_f, cap_r = pipeline.caps.frontier, pipeline.caps.result
    dev = ctx.join_src.device

    def i32(shape, fill):
        return torch.full(shape, fill, dtype=torch.int32, device=dev)

    return TraversalState(
        frontier_pos=i32((cap_f,), _num_join(ctx)),
        frontier_count=i32((), 0),
        targets=i32((cap_f,), -1),
        keep=torch.zeros((cap_f,), dtype=torch.bool, device=dev),
        visited=torch.zeros((num_vertices,), dtype=torch.bool, device=dev),
        result_pos=i32((cap_r,), ctx.table.num_rows),
        result_depth=i32((cap_r,), -1),
        result_count=i32((), 0),
        depth=i32((), 0),
        overflow=torch.zeros((), dtype=torch.bool, device=dev))


def fixed_point(pipeline: Pipeline, ctx: Context, root: int,
                num_vertices: int) -> BFSResult:
    """Run a pipeline to its fixed point: the operator steps composed in
    order, once per level, while the frontier is live and the depth bound
    is not reached.  The loop reads ``frontier_count`` on the host once per
    level: one sync per level."""
    root = int(root)
    state = _initial_state(pipeline, ctx, num_vertices)
    state = pipeline.seed.init(ctx, state, root)
    for op in pipeline.ops:
        state = op.init(ctx, state, root)
    for _ in range(pipeline.max_depth):
        if int(state.frontier_count.item()) <= 0:
            break
        for op in pipeline.ops:
            state = op.step(ctx, state)
        state = state._replace(depth=state.depth + 1)
    return pipeline.finisher.finish(ctx, pipeline, state)


def execute(pipeline: Pipeline, ctx: Context, root: int, num_vertices: int
            ) -> BFSResult:
    """Single-root pipeline execution (the reference's jitted entry)."""
    return fixed_point(pipeline, ctx, root, num_vertices)
