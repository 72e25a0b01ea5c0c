"""Positional operator algebra + the fixed-point driver.

Every engine of the port is a :class:`Pipeline`: a seed operator, a tuple
of per-level operators and a finisher, run by ONE :func:`fixed_point`
driver.  The operators ported so far:

===================  ======================================================
``Seed``             the non-recursive CTE child (Filter on the root, or
                     the root bit of a dense bitmap / vertex-depth array)
``ReadTargets``      per-level read of the join column out of the frontier
                     positions (one column gather)
``VisitedDedup``     BFS vertex dedup (visited bitmap + scatter-argmin)
``CSRIndexJoin``     Fig. 4's IndexJoin: frontier vertices -> edge positions
                     through the CSR join index
``DenseBitmapStep``  beyond-paper dense-frontier level (boolean SpMV push)
``PullStep``         its Beamer bottom-up dual over the reverse CSR
``DirectionSwitch``  per level, push or pull from exact work terms
``HybridStep``       positional IndexJoin while the frontier is small,
                     dense push above a fraction of the vertices
``HybridPullStep``   the bottom-up twin of HybridStep's dense branch
``WeightedExpand``   the positional weighted level: per-vertex ⊕-combine,
                     winner select and IndexJoin in one step
``WeightedDenseStep`` the dense weighted level: ⊗ over the edge list, one
                     ⊕-scatter into the (V,) level plane
``AppendUnionAll``   the recursive UNION ALL: append the level block to the
                     working result, tagging each row with its BFS level
``LateMaterialize``  Fig. 4's single post-fixed-point Materialize
``CompactEmitted``   dense finisher: emitted-edge mask -> positions -> one
                     late gather
``DeferredEmit``     the same, deriving the emitted mask from per-vertex
                     depths in one pass after the fixed point
===================  ======================================================

Frontier representation per pipeline (``Pipeline.rep``): ``'pos'`` — a
block of edge positions (PRecursive, hybrid); ``'dense'`` — a boolean
vertex bitmap (bitmap) or, with deferred emission, the per-vertex depth
array (diropt).  State a pipeline does not use is a zero-size placeholder,
as in the reference; the semiring value plane (``Pipeline.semiring`` other
than ``'reach'``) adds a float32 frontier value and a (V,) per-vertex
accumulator, zero-size for ``reach``, so the boolean paths are unchanged.

Direction: the join view (``ctx.join_src``/``ctx.join_dst`` and the CSR
over ``join_src``) decides it.  ``outbound`` uses (from, to); ``inbound``
the reverse; ``both`` the FUSED bidirectional view (``ctx.bidir``) with a
VIRTUAL 2E join space (position ``p < E`` is edge ``p`` forward, ``p >= E``
backward) folded back onto real edges at append time.

The reference decides its data-dependent branches (``lax.cond``) on the
device; here they are Python branches on host values.  The fixed-point
loop copies the level's scalars to the host once per level, in one
transfer (:class:`HostCounts`), and the operators branch on those.

Every gather clamps its indices and every dropping scatter routes dropped
entries to a spare slot: torch on CUDA asserts where JAX clamps or drops.
Public fields stay int32 (``level_dirs`` int8), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.frontier_pull.ref import frontier_pull_ref
from ..kernels.spmm_segment.ops import segments
from .csr import CSRIndex, expand_frontier, expand_frontier_both
from .positions import PosBlock, append_block, compact_mask
from .semiring import (elem_combine, get_semiring, or_combine, propagate,
                       scatter_combine)
from .table import ColumnTable

__all__ = [
    "DIRECTIONS", "check_direction", "EngineCaps", "BFSResult", "Context",
    "HostCounts", "TraversalState", "Operator", "Seed", "ReadTargets",
    "VisitedDedup", "CSRIndexJoin", "DenseBitmapStep", "PullStep",
    "DirectionSwitch", "HybridStep", "HybridPullStep", "WeightedExpand",
    "WeightedDenseStep", "AppendUnionAll",
    "LateMaterialize", "CompactEmitted", "DeferredEmit", "Pipeline",
    "fixed_point", "execute", "dedup_targets", "bitmap_level",
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
    level_dirs: Optional[torch.Tensor] = None   # (L,) int8 per-level
    #   decision of a DirectionSwitch pipeline (-1 unused, 0 push, 1 pull)
    vertex_values: Optional[torch.Tensor] = None  # (V,) float32 semiring
    #   value plane of a weighted pipeline (None for the boolean reach)


@dataclasses.dataclass(frozen=True)
class Context:
    """Runtime inputs of a pipeline: storage + the direction-resolved join
    view.  ``join_src`` is the column the CSR indexes; ``join_dst`` holds the
    next vertex reached by each join-space edge.  ``rcsr`` is the reverse
    CSR of the join view (groups join edges by ``join_dst``; the pull
    operators walk it); ``bidir=True`` selects the fused bidirectional
    view for ``direction='both'`` with ``both_indptr`` the merged out+in
    indptr.  ``edge_weights`` is the (E,) float32 ⊗ weight per edge in
    real position order (shared by both orientations of the fused view);
    None for unweighted traffic, which traverses with all-ones."""

    table: ColumnTable
    csr: Optional[CSRIndex]
    join_src: torch.Tensor
    join_dst: torch.Tensor
    rcsr: Optional[CSRIndex] = None
    both_indptr: Optional[torch.Tensor] = None
    bidir: bool = False
    edge_weights: Optional[torch.Tensor] = None


class HostCounts(NamedTuple):
    """The level's scalars on the host, copied by the fixed-point loop once
    per level in one transfer: the depth of the level, its live frontier
    entries and (switch pipelines only) the vertices discovered before
    it."""

    depth: int = 0
    frontier: int = 0
    visited: int = 0


class TraversalState(NamedTuple):
    """The state the operators share across levels.  One frontier
    representation is active per pipeline; the others are zero-size."""

    frontier_pos: torch.Tensor     # (F,) int32 join-space edge positions
    frontier_count: torch.Tensor   # () int32 live frontier entries
    targets: torch.Tensor          # (F,) int32 target vertices
    keep: torch.Tensor             # (F,) bool survivors of dedup
    frontier_bits: torch.Tensor    # (V,) bool dense frontier
    emitted: torch.Tensor          # (EJ,) bool emitted-edge mask
    emit_depth: torch.Tensor       # (EJ,) int32 level of first emission
    visited: torch.Tensor          # (V,) bool BFS visited set
    result_pos: torch.Tensor       # (R,) int32 real result positions
    result_depth: torch.Tensor     # (R,) int32 BFS level per result row
    result_count: torch.Tensor     # () int32
    depth: torch.Tensor            # () int32 levels executed
    overflow: torch.Tensor         # () bool
    vertex_depth: torch.Tensor     # (V,) int32 BFS depth per vertex (-1 =
    #   undiscovered; deferred-emission pipelines derive the emitted mask
    #   from it ONCE, after the fixed point)
    visited_count: torch.Tensor    # () int32 discovered vertices so far
    #   (kept by the deferred steps so the switch reads no popcount)
    level_dirs: torch.Tensor       # (L,) int8 per-level switch decision
    #   (-1 = level not executed, 0 = push, 1 = pull)
    frontier_val: torch.Tensor     # weighted value plane of the frontier:
    #   (F,) value arriving along each frontier edge (positional rep) or
    #   (V,) per-vertex level values (dense rep); zero-size for 'reach'
    vertex_val: torch.Tensor       # (V,) float32 ⊕-accumulated value per
    #   vertex (semiring identity = unreached); zero-size for 'reach'
    host: HostCounts = HostCounts()   # this level's scalars on the host
    segments: Optional[Tuple[torch.Tensor, ...]] = None   # the dense
    #   weighted step's edges in destination order, (src, dst, weight,
    #   offsets), sorted once per request when a kernel is plugged in


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


def _join_src_at(ctx: Context, pos: torch.Tensor) -> torch.Tensor:
    """The source-vertex column of the join view at join-space positions."""
    if not ctx.bidir:
        ej = ctx.join_src.shape[0]
        return ctx.join_src[pos.clamp(0, ej - 1)]
    e = ctx.join_src.shape[0]
    fwd = pos < e
    p = torch.where(fwd, pos, pos - e).clamp(0, e - 1)
    return torch.where(fwd, ctx.join_src[p], ctx.join_dst[p])


def _seed_mask(ctx: Context, root: int) -> torch.Tensor:
    """(EJ,) mask of join edges whose source is the root (the seed filter).
    Fused view: forward matches on ``from``, backward on ``to``."""
    if not ctx.bidir:
        return ctx.join_src == root
    return torch.cat([ctx.join_src == root, ctx.join_dst == root])


def _hit_mask(ctx: Context, frontier_v: torch.Tensor) -> torch.Tensor:
    """(EJ,) mask of join edges whose SOURCE vertex is in ``frontier_v``:
    the rows one CTE level emits (push-side emission test)."""
    nv = frontier_v.shape[0]
    if not ctx.bidir:
        return frontier_v[ctx.join_src.clamp(0, nv - 1)]
    return torch.cat([frontier_v[ctx.join_src.clamp(0, nv - 1)],
                      frontier_v[ctx.join_dst.clamp(0, nv - 1)]])


def _edge_weights(ctx: Context) -> torch.Tensor:
    """The (E,) ⊗ weight of every real edge: the weight column, or all-ones
    for a weightless context (reach-compatible)."""
    if ctx.edge_weights is None:
        return torch.ones((ctx.join_src.shape[0],), dtype=torch.float32,
                          device=ctx.join_src.device)
    return ctx.edge_weights


def _edge_weight_at(ctx: Context, pos: torch.Tensor) -> torch.Tensor:
    """Per-edge ⊗ weight gathered at join-space positions (callers mask
    invalid lanes themselves).  Weights live in real position order, so the
    fused view's backward copy reads the same weight as its edge."""
    if ctx.edge_weights is None:
        return torch.ones(pos.shape, dtype=torch.float32, device=pos.device)
    e = ctx.edge_weights.shape[0]
    return ctx.edge_weights[_to_real(ctx, pos).clamp(0, e - 1)]


def _set_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``arr.at[idx].set(vals, mode="drop")`` for ``idx`` in [0, len]:
    the callers route every dropped entry to ``len``, a spare slot that is
    sliced off.  ``vals`` broadcasts to ``idx``; ``arr`` is not
    modified."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr.new_zeros((1,))])
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    ext.scatter_(0, idx.long(), vals.expand(idx.shape))
    return ext[:n]


def bitmap_level(from_col: torch.Tensor, to_col: torch.Tensor,
                 frontier_v: torch.Tensor, visited: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One dense push step.  Returns (edge_hit_mask, next_frontier,
    visited); edge_hit_mask marks the edges whose source is in the frontier
    (the rows the CTE emits this level)."""
    nv = frontier_v.shape[0]
    hit = frontier_v[from_col.clamp(0, nv - 1)]
    nxt = or_combine(torch.zeros_like(frontier_v), to_col.clamp(0, nv - 1),
                     hit)
    nxt = nxt & ~visited
    return hit, nxt, visited | nxt


def _dense_push(ctx: Context, frontier_v: torch.Tensor,
                visited: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One dense PUSH step over the join view.  Returns
    (edge_hit_mask (EJ,), next_frontier, visited)."""
    if not ctx.bidir:
        return bitmap_level(ctx.join_src, ctx.join_dst, frontier_v, visited)
    nv = frontier_v.shape[0]
    src = ctx.join_src.clamp(0, nv - 1)
    dst = ctx.join_dst.clamp(0, nv - 1)
    hit_f = frontier_v[src]
    hit_b = frontier_v[dst]
    nxt = or_combine(or_combine(torch.zeros_like(frontier_v), dst, hit_f),
                     src, hit_b)
    nxt = nxt & ~visited
    return torch.cat([hit_f, hit_b]), nxt, visited | nxt


def _dense_pull(ctx: Context, frontier_v: torch.Tensor,
                visited: torch.Tensor, pull_fn=None) -> torch.Tensor:
    """One dense PULL (Beamer bottom-up) step: the next frontier is every
    UNVISITED vertex with an in-neighbor (over the join view) in the
    frontier bitmap.  Over the reverse CSR, ``pull_fn`` (the
    ``frontier_pull`` kernel wrapper) or, without one, its plain version
    computes it.  The fused view takes no kernel, as in the reference."""
    nv = frontier_v.shape[0]
    cand = ~visited
    empty = torch.zeros_like(frontier_v)
    if ctx.bidir:
        # fused view: both orientations contribute, natural edge order
        src = ctx.join_src.clamp(0, nv - 1)
        dst = ctx.join_dst.clamp(0, nv - 1)
        nxt = or_combine(or_combine(empty, dst, cand[dst] & frontier_v[src]),
                         src, cand[src] & frontier_v[dst])
        return nxt & cand
    if pull_fn is not None and ctx.rcsr is None:
        raise ValueError(
            "the frontier_pull kernel walks the reverse CSR; call "
            "Dataset.ensure_reverse() before plugging it into a pull step")
    if ctx.rcsr is not None:
        pull = pull_fn or frontier_pull_ref
        return pull(ctx.rcsr, ctx.join_src, ctx.join_dst, frontier_v,
                    visited)
    # no reverse CSR built (an outbound-only dataset on the CPU): the same
    # bottom-up test in natural edge order, with an identical result
    src = ctx.join_src.clamp(0, nv - 1)
    dst = ctx.join_dst.clamp(0, nv - 1)
    nxt = or_combine(empty, dst, cand[dst] & frontier_v[src])
    return nxt & cand


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
    return _set_drop(result_depth, torch.where(live, slots, cap_r), tag)


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
    """The non-recursive child of the CTE.

    kind='edges' — Filter[join_src = root] compacted to a position block;
    kind='dense' — the root bit in a dense vertex bitmap.
    A deferred-emission pipeline (one that carries ``vertex_depth``) seeds
    the root's depth 0 instead of any bitmap.  ``mark_emitted`` seeds the
    emitted-edge mask of the positional pipelines that carry one.
    ``semiring != 'reach'`` also seeds the value plane: the root's vertex
    value is the semiring's seed value and (edge kind) each seed edge
    carries seed ⊗ weight."""

    kind: str = "edges"
    mark_emitted: bool = False
    semiring: str = "reach"

    def _init_weighted(self, ctx, state, root):
        sr = get_semiring(self.semiring)
        nv = state.visited.shape[0]
        r = min(max(root, 0), nv - 1)
        visited = state.visited.clone()
        visited[r] = True
        vertex_val = state.vertex_val.clone()
        vertex_val[r] = sr.seed_value
        if self.kind == "dense":
            bits = torch.zeros_like(visited)
            bits[r] = True
            fval = torch.full((nv,), sr.identity, dtype=torch.float32,
                              device=visited.device)
            fval[r] = sr.seed_value
            return state._replace(frontier_bits=bits, visited=visited,
                                  vertex_val=vertex_val, frontier_val=fval,
                                  frontier_count=torch.ones_like(
                                      state.frontier_count))
        ej = _num_join(ctx)
        cap = state.frontier_pos.shape[0]
        blk = compact_mask(_seed_mask(ctx, root), cap, ej)
        seed = torch.tensor(sr.seed_value, dtype=torch.float32,
                            device=visited.device)
        fval = torch.where(blk.valid_mask(),
                           propagate(sr, seed,
                                     _edge_weight_at(ctx, blk.positions)),
                           sr.identity)
        return state._replace(frontier_pos=blk.positions,
                              frontier_count=blk.count, visited=visited,
                              vertex_val=vertex_val, frontier_val=fval)

    def init(self, ctx, state, root):
        if self.semiring != "reach":
            return self._init_weighted(ctx, state, root)
        if state.vertex_depth.shape[0]:
            # deferred emission: the per-vertex depth array IS the visited
            # set and the frontier (no separate bitmaps)
            nvd = state.vertex_depth.shape[0]
            vd = state.vertex_depth.clone()
            vd[min(max(root, 0), nvd - 1)] = 0
            one = torch.ones_like(state.visited_count)
            return state._replace(vertex_depth=vd, visited_count=one,
                                  frontier_count=one)
        nv = state.visited.shape[0]
        r = min(max(root, 0), nv - 1)
        visited = state.visited.clone()
        visited[r] = True
        if self.kind == "dense":
            bits = torch.zeros_like(visited)
            bits[r] = True
            return state._replace(frontier_bits=bits, visited=visited,
                                  frontier_count=torch.ones_like(
                                      state.frontier_count))
        ej = _num_join(ctx)
        cap = state.frontier_pos.shape[0]
        blk = compact_mask(_seed_mask(ctx, root), cap, ej)
        state = state._replace(frontier_pos=blk.positions,
                               frontier_count=blk.count, visited=visited)
        if self.mark_emitted:
            valid = blk.valid_mask()
            idx = torch.where(valid, blk.positions, ej)
            state = state._replace(
                emitted=_set_drop(state.emitted, idx, valid),
                emit_depth=_set_drop(state.emit_depth, idx, 0))
        return state


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


def _record_deferred(state: TraversalState, new: torch.Tensor
                     ) -> TraversalState:
    """Deferred-emission bookkeeping: the loop carries ONLY the per-vertex
    depth array (frontier = ``vd == depth``, visited = ``vd >= 0``) plus
    the scalar visited count the switch predicate reads.  Newly discovered
    vertices get depth ``state.depth + 1``; the emitted mask is derived
    once, after the fixed point."""
    count = new.sum(dtype=torch.int32)
    vd = torch.where(new, state.depth + 1, state.vertex_depth)
    return state._replace(vertex_depth=vd, frontier_count=count,
                          visited_count=state.visited_count + count)


@dataclasses.dataclass(frozen=True)
class DenseBitmapStep(Operator):
    """Beyond-paper dense level: the frontier is a vertex bitmap and one
    level is a masked scatter over the full edge list (boolean-semiring
    SpMV): O(E) work and no data-dependent shapes.

    ``deferred=True`` (the direction-optimizing pipelines) skips the
    per-level emitted-mask/emit-depth upkeep and records per-vertex depths
    instead; :class:`DeferredEmit` rebuilds the identical emitted set in
    ONE O(E) pass after the fixed point."""

    deferred: bool = False

    def deferred_new(self, ctx, state):
        """The newly discovered vertices from the per-vertex depth array
        alone (DirectionSwitch exchanges only this (V,) mask)."""
        vd = state.vertex_depth
        nv = vd.shape[0]
        src = ctx.join_src.clamp(0, nv - 1)
        dst = ctx.join_dst.clamp(0, nv - 1)
        # frontier membership fused into the edge gather (vd[src] == depth)
        empty = torch.zeros((nv,), dtype=torch.bool, device=vd.device)
        tgt = or_combine(empty, dst, vd[src] == state.depth)
        if ctx.bidir:
            tgt = or_combine(tgt, src, vd[dst] == state.depth)
        return tgt & (vd < 0)

    def step(self, ctx, state):
        if self.deferred:
            return _record_deferred(state, self.deferred_new(ctx, state))
        hit, nxt, visited = _dense_push(ctx, state.frontier_bits,
                                        state.visited)
        new = hit & ~state.emitted
        return state._replace(
            frontier_bits=nxt, visited=visited, emitted=state.emitted | hit,
            emit_depth=torch.where(new, state.depth, state.emit_depth),
            frontier_count=nxt.sum(dtype=torch.int32))


@dataclasses.dataclass(frozen=True)
class PullStep(Operator):
    """Beamer-style bottom-up level: gather over the REVERSE CSR from
    unvisited vertices, testing membership of their in-neighbors in the
    frontier bitmap (the pull dual of :class:`DenseBitmapStep`'s push).
    ``expand_fn`` plugs in the ``frontier_pull`` kernel wrapper.

    In deferred mode a pull level touches no emitted-edge state at all; in
    emitted mode the push-side hit mask is still computed (emission is
    defined by the SQL join, not by how the next frontier was found)."""

    deferred: bool = False
    expand_fn: Optional[Callable] = None

    def deferred_new(self, ctx, state):
        """See DenseBitmapStep.deferred_new."""
        vd = state.vertex_depth
        return _dense_pull(ctx, vd == state.depth, vd >= 0, self.expand_fn)

    def step(self, ctx, state):
        if self.deferred:
            return _record_deferred(state, self.deferred_new(ctx, state))
        nxt = _dense_pull(ctx, state.frontier_bits, state.visited,
                          self.expand_fn)
        hit = _hit_mask(ctx, state.frontier_bits)
        new = hit & ~state.emitted
        return state._replace(
            frontier_bits=nxt, visited=state.visited | nxt,
            emitted=state.emitted | hit,
            emit_depth=torch.where(new, state.depth, state.emit_depth),
            frontier_count=nxt.sum(dtype=torch.int32))


@dataclasses.dataclass(frozen=True)
class DirectionSwitch(Operator):
    """The direction-optimizing combinator: per level it picks the push or
    the pull operator by comparing the estimated work terms, frontier
    occupancy x avg out-degree against unvisited count x avg in-degree:

        pull  iff  alpha * n_f * avg_out > (V - visited) * avg_in
              and  beta * n_f >= V

    The reference evaluates this in float32 inside a ``lax.cond``; here it
    is evaluated in float32 on the host, from the counts the fixed-point
    loop copied for the level (``state.host``), so it adds no sync.  The
    decision is recorded in ``level_dirs``."""

    push: Operator
    pull: Operator
    alpha: float = 1.0
    beta: float = 64.0

    def use_pull(self, ctx, state) -> bool:
        f32 = np.float32
        nv = state.vertex_depth.shape[0] or state.visited.shape[0]
        avg = f32(float(_num_join(ctx)) / max(float(nv), 1.0))
        n_f = f32(state.host.frontier)
        if state.frontier_bits.shape[0] or state.vertex_depth.shape[0]:
            # dense/deferred frontier: the count is VERTICES, scaled by
            # the average out-degree to the push side's edge work
            m_f = n_f * avg
        else:                       # positional frontier: the edge block
            m_f = n_f               # IS the push side's work
        m_u = f32(nv - state.host.visited) * avg
        return bool((f32(self.alpha) * m_f > m_u)
                    & (f32(self.beta) * n_f >= f32(nv)))

    def step(self, ctx, state):
        use_pull = self.use_pull(ctx, state)
        if state.level_dirs.shape[0]:
            # written in place: the state's level_dirs belongs to this run
            idx = min(state.host.depth, state.level_dirs.shape[0] - 1)
            state.level_dirs[idx] = int(use_pull)
        # a Python branch runs only the chosen side: for the deferred steps
        # that is the reference's narrow exchange of one (V,) mask
        return (self.pull if use_pull else self.push).step(ctx, state)


def _install_edge_frontier(ctx: Context, state: TraversalState,
                           nxt: PosBlock, visited: torch.Tensor,
                           ovf: torch.Tensor) -> TraversalState:
    """Shared positional-frontier bookkeeping (HybridStep and its pull
    twin): install the next edge block and mark its positions emitted at
    ``depth + 1``.  ``new`` reads ``emitted`` before it is written."""
    ej = _num_join(ctx)
    valid = nxt.valid_mask()
    idx = torch.where(valid, nxt.positions, ej)
    new = valid & ~state.emitted[nxt.positions.clamp(0, ej - 1)]
    return state._replace(
        frontier_pos=nxt.positions, frontier_count=nxt.count,
        visited=visited, emitted=_set_drop(state.emitted, idx, valid),
        emit_depth=_set_drop(state.emit_depth,
                             torch.where(new, nxt.positions, ej),
                             state.depth + 1),
        overflow=state.overflow | ovf)


@dataclasses.dataclass(frozen=True)
class HybridStep(Operator):
    """Direction-optimizing level: positional IndexJoin while the frontier
    is small, dense push once it covers ``switch_frac`` of the vertices.
    The branch is taken on the host count of the level's frontier.
    ``expand_fn`` plugs a kernel into the sparse branch's IndexJoin."""

    switch_frac: float = 0.05
    expand_fn: Optional[Callable] = None

    def step(self, ctx, state):
        ej = _num_join(ctx)
        nv = state.visited.shape[0]
        cap = state.frontier_pos.shape[0]
        threshold = max(1, int(nv * self.switch_frac))
        frontier = PosBlock(state.frontier_pos, state.frontier_count)
        fvalid = frontier.valid_mask()
        if state.host.frontier < threshold:
            targets = torch.where(
                fvalid, _join_dst_at(ctx, frontier.positions), -1)
            keep, visited = dedup_targets(targets, fvalid, state.visited)
            targets = torch.where(keep, targets, -1)
            epos, total, ovf = _expand_join(ctx, targets, keep, cap,
                                            self.expand_fn)
            nxt = PosBlock(epos, total)
        else:
            targets = _join_dst_at(ctx, frontier.positions)
            # boolean OR (scatter-max): padded slots (clamped onto a real
            # vertex) must never UNSET a vertex another slot reached
            tgt_v = or_combine(torch.zeros_like(state.visited),
                               targets.clamp(0, nv - 1), fvalid)
            tgt_v = tgt_v & ~state.visited
            visited = state.visited | tgt_v
            hit = _hit_mask(ctx, tgt_v)
            nxt = compact_mask(hit, cap, ej)
            ovf = hit.sum(dtype=torch.int32) > cap
        return _install_edge_frontier(ctx, state, nxt, visited, ovf)


@dataclasses.dataclass(frozen=True)
class HybridPullStep(Operator):
    """The pull twin of :class:`HybridStep`'s dense branch, for positional
    (edge-block) frontiers: rebuild the previous level's VERTEX set from
    the frontier edges' join sources, bottom-up test the unvisited set
    against it, then emit and compact exactly like the push branch, so a
    :class:`DirectionSwitch` over (HybridStep, HybridPullStep) is
    level-for-level state-identical to plain HybridStep.  ``expand_fn``
    plugs in the ``frontier_pull`` kernel wrapper (the reference's twin
    has no such slot and always runs the plain pull)."""

    expand_fn: Optional[Callable] = None

    def step(self, ctx, state):
        ej = _num_join(ctx)
        nv = state.visited.shape[0]
        cap = state.frontier_pos.shape[0]
        fvalid = PosBlock(state.frontier_pos, state.frontier_count
                          ).valid_mask()
        srcs = _join_src_at(ctx, state.frontier_pos)
        prev_v = or_combine(torch.zeros_like(state.visited),
                            srcs.clamp(0, nv - 1), fvalid)
        tgt_v = _dense_pull(ctx, prev_v, state.visited, self.expand_fn)
        hit = _hit_mask(ctx, tgt_v)
        nxt = compact_mask(hit, cap, ej)
        ovf = hit.sum(dtype=torch.int32) > cap
        return _install_edge_frontier(ctx, state, nxt, state.visited | tgt_v,
                                      ovf)


def _level_plane(sr, nv: int, idx: torch.Tensor, vals: torch.Tensor
                 ) -> torch.Tensor:
    """The (V,) level plane: the arrivals ``vals`` ⊕-combined per target
    vertex ``idx`` (``nv`` drops a lane), the identity where none
    arrived."""
    return scatter_combine(sr, torch.full((nv,), sr.identity,
                                          dtype=torch.float32,
                                          device=vals.device), idx, vals)


def _fold_level(sr, lvl: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor, vertex_val: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """⊕-fold the level plane into the accumulator of the vertices that
    received an arrival (``idx`` where ``valid``).  Returns (received,
    vertex_val)."""
    nv = vertex_val.shape[0]
    received = or_combine(torch.zeros((nv,), dtype=torch.bool,
                                      device=lvl.device), idx, valid)
    return received, torch.where(received,
                                 elem_combine(sr, vertex_val, lvl),
                                 vertex_val)


def _combine_arrivals(ctx: Context, sr, state: TraversalState,
                      slots: torch.Tensor):
    """The positional frontier's arrivals (``slots`` = arange(F))
    ⊕-combined per target vertex and folded into the accumulator.  Returns
    (valid, targets, clamped targets, level plane, vertex_val)."""
    nv = state.vertex_val.shape[0]
    valid = slots < state.frontier_count
    t = _join_dst_at(ctx, state.frontier_pos)
    safe = t.clamp(0, nv - 1)
    idx = torch.where(valid, safe, nv)
    lvl = _level_plane(sr, nv, idx, state.frontier_val)
    _, new_vv = _fold_level(sr, lvl, idx, valid, state.vertex_val)
    return valid, t, safe, lvl, new_vv


@dataclasses.dataclass(frozen=True)
class WeightedExpand(Operator):
    """The positional weighted level: one fused ⊗-propagate / ⊕-combine /
    winner-select / IndexJoin step.

    Each frontier entry is a join-space edge position carrying the value
    that arrives along it (``frontier_val``).  The step ⊕-combines the
    arrivals per target vertex into the level plane, folds it into the
    per-vertex accumulator, picks ONE expansion slot per active vertex with
    the scatter-argmin ticket of :func:`dedup_targets` (⊗ distributes over
    ⊕, so expanding the combined value once equals expanding every path),
    and expands the winners through the CSR join index.  Improving
    semirings (``shortest_path``) re-expand only strictly improved
    vertices, so the driver's ``frontier_count > 0`` test is value
    stabilization; walk semirings re-expand every receiver.  ``expand_fn``
    plugs a kernel into the IndexJoin (the reference's operator has no such
    slot; the expansion is integer, so the result is the same)."""

    semiring: str
    expand_fn: Optional[Callable] = None

    def step(self, ctx, state):
        sr = get_semiring(self.semiring)
        cap = state.frontier_pos.shape[0]
        nv = state.vertex_val.shape[0]
        slots = torch.arange(cap, dtype=torch.int32,
                             device=state.frontier_pos.device)
        valid, t, safe, lvl, new_vv = _combine_arrivals(ctx, sr, state,
                                                        slots)
        if sr.improving:                 # frontier = strictly improved
            eligible = valid & (lvl < state.vertex_val)[safe]
        else:                            # frontier = every receiver
            eligible = valid
        ticket = torch.full((nv + 1,), cap, dtype=torch.int32,
                            device=slots.device)
        ticket.scatter_reduce_(0, torch.where(eligible, safe, nv).long(),
                               torch.where(eligible, slots, cap), "amin")
        winner = eligible & (ticket[safe] == slots)
        targets = torch.where(winner, t, -1)
        epos, total, ovf = _expand_join(ctx, targets, winner, cap,
                                        self.expand_fn)
        sval = lvl[_join_src_at(ctx, epos).clamp(0, nv - 1)]
        fval = torch.where(slots < total,
                           propagate(sr, sval, _edge_weight_at(ctx, epos)),
                           sr.identity)
        return state._replace(frontier_pos=epos, frontier_count=total,
                              frontier_val=fval, vertex_val=new_vv,
                              targets=targets, keep=winner,
                              overflow=state.overflow | ovf)


@dataclasses.dataclass(frozen=True)
class WeightedDenseStep(Operator):
    """The dense weighted level: ⊗ over the full edge list, then one
    ⊕-scatter into the (V,) level plane (the weighted generalization of
    :class:`DenseBitmapStep`'s boolean SpMV).

    For the (sum, ×) semiring that scatter IS the gather-scale-segment-sum
    of ``spmm_segment``: ``spmm_fn`` plugs its kernel wrapper
    (``spmm_segment_sorted``) in, inactive edges padded with the kernel's
    own ``src = V``.  The edges' destination order is fixed, so ``init``
    sorts them ONCE per request (``state.segments``) and each level only
    masks the sorted sources.  Every other ⊕, and a step without a kernel,
    uses :func:`scatter_combine`.  Single-direction views only.

    Where the reference drops an edge outside the frontier from its
    scatters, here it scatters the ⊕-identity (or ``False``) onto its own
    target, as :class:`DenseBitmapStep` does: no value changes, and no
    lane goes to a shared spare slot, whose atomics serialize on the
    card."""

    semiring: str
    spmm_fn: Optional[Callable] = None

    def _uses_kernel(self, sr) -> bool:
        return (self.spmm_fn is not None and sr.combine == "add"
                and sr.propagate == "mul")

    def init(self, ctx, state, root):
        if not self._uses_kernel(get_semiring(self.semiring)):
            return state
        nv = state.vertex_val.shape[0]
        s = segments(ctx.join_dst.clamp(0, nv - 1), nv)
        src = ctx.join_src.clamp(0, nv - 1)[s.order]
        return state._replace(segments=(src, s.seg,
                                        _edge_weights(ctx)[s.order],
                                        s.offsets))

    def step(self, ctx, state):
        sr = get_semiring(self.semiring)
        nv = state.vertex_val.shape[0]
        src = ctx.join_src.clamp(0, nv - 1)
        dst = ctx.join_dst.clamp(0, nv - 1)
        hit = state.frontier_bits[src]
        if self._uses_kernel(sr):
            s_src, s_dst, s_w, offsets = state.segments
            s_src = torch.where(state.frontier_bits[s_src], s_src, nv)
            lvl = self.spmm_fn(state.frontier_val[:, None], s_src, s_dst,
                               s_w, offsets)[:, 0]
        else:
            prop = propagate(sr, state.frontier_val[src], _edge_weights(ctx))
            lvl = _level_plane(sr, nv, dst,
                               torch.where(hit, prop, sr.identity))
        received, new_vv = _fold_level(sr, lvl, dst, hit, state.vertex_val)
        nxt = received & (lvl < state.vertex_val) if sr.improving \
            else received
        new = hit & ~state.emitted
        return state._replace(
            frontier_bits=nxt,
            frontier_val=torch.where(nxt, lvl, sr.identity),
            vertex_val=new_vv, visited=state.visited | nxt,
            emitted=state.emitted | hit,
            emit_depth=torch.where(new, state.depth, state.emit_depth),
            frontier_count=nxt.sum(dtype=torch.int32))


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


def _drain_value_frontier(ctx: Context, pipeline: "Pipeline",
                          state: TraversalState) -> torch.Tensor:
    """Fold the FINAL frontier's arrivals into the vertex accumulator.

    :class:`WeightedExpand` ⊕-combines the arrivals of the previous
    expansion at the start of each step, so when the depth bound (rather
    than convergence) stops the loop, the last expansion's rows are in the
    result but their values still sit in ``frontier_val``.  The dense step
    combines in the level it emits, so only the positional finisher needs
    this; it changes nothing on a converged (empty) frontier."""
    slots = torch.arange(state.frontier_pos.shape[0], dtype=torch.int32,
                         device=state.frontier_pos.device)
    return _combine_arrivals(ctx, get_semiring(pipeline.semiring), state,
                             slots)[-1]


@dataclasses.dataclass(frozen=True)
class LateMaterialize:
    """Fig. 4's single Materialize after the fixed point — the paper's core
    win: ALL output columns gathered exactly once, from positions."""

    cols: Tuple[str, ...]

    def finish(self, ctx, pipeline, state):
        values = ctx.table.take(state.result_pos, self.cols)
        vv = (_drain_value_frontier(ctx, pipeline, state)
              if pipeline.semiring != "reach" else None)
        return BFSResult(values, state.result_pos, state.result_count,
                         state.depth, state.overflow, state.result_depth,
                         vertex_values=vv)


@dataclasses.dataclass(frozen=True)
class CompactEmitted:
    """Dense-pipeline finisher: compact the emitted-edge mask into a
    position block, then late-materialize (one ``ColumnTable.take``): the
    dense plan keeps the positional contract."""

    cols: Tuple[str, ...]

    def finish(self, ctx, pipeline, state):
        return _emit(ctx, pipeline.caps.result, self.cols, state,
                     state.emitted, state.emit_depth)


@dataclasses.dataclass(frozen=True)
class DeferredEmit:
    """Deferred-emission finisher (the diropt pipelines): the loop carried
    only per-vertex depths, so the emitted-edge mask is DERIVED here in one
    O(EJ) pass (a join edge is emitted iff its source vertex was discovered
    strictly before the last executed level), then compacted and
    late-materialized exactly like :class:`CompactEmitted` (identical row
    set, order and depths)."""

    cols: Tuple[str, ...]

    def finish(self, ctx, pipeline, state):
        vd = state.vertex_depth
        nv = vd.shape[0]
        src_depth = vd[ctx.join_src.clamp(0, nv - 1)]
        if ctx.bidir:
            src_depth = torch.cat([src_depth,
                                   vd[ctx.join_dst.clamp(0, nv - 1)]])
        emitted = (src_depth >= 0) & (src_depth < state.depth)
        return _emit(ctx, pipeline.caps.result, self.cols, state, emitted,
                     src_depth)


def _emit(ctx: Context, cap_r: int, cols: Tuple[str, ...],
          state: TraversalState, emitted: torch.Tensor,
          edge_depth: torch.Tensor) -> BFSResult:
    """The dense finishers' shared tail: (EJ,) emitted mask and per-edge
    level -> compacted positions, one late gather, row depths."""
    ej = _num_join(ctx)
    blk = compact_mask(emitted, cap_r, ej)
    pos_real = _to_real(ctx, blk.positions)
    values = ctx.table.take(pos_real, cols)
    overflow = state.overflow | (emitted.sum(dtype=torch.int32) > cap_r)
    row_depths = torch.where(blk.valid_mask(),
                             edge_depth[blk.positions.clamp(0, ej - 1)], -1)
    dirs = state.level_dirs if state.level_dirs.shape[0] else None
    vv = state.vertex_val if state.vertex_val.shape[0] else None
    return BFSResult(values, pos_real, blk.count, state.depth, overflow,
                     row_depths, dirs, vv)


# ---------------------------------------------------------------------------
# the pipeline + the fixed-point driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pipeline:
    """A declarative recursive plan: seed, per-level operators, finisher."""

    name: str
    seed: Seed
    ops: Tuple[Operator, ...]
    finisher: object                 # LateMaterialize | CompactEmitted | ...
    caps: EngineCaps
    max_depth: int
    rep: str = "pos"                 # 'pos' | 'dense'
    inclusive: bool = False          # loop while depth <= max_depth (dense)
    tracks_emitted: bool = False     # carries the (EJ,) emitted-edge mask
    tracks_vertex_depth: bool = False  # deferred emission: (V,) depths
    tracks_switch: bool = False      # records per-level push/pull decisions
    semiring: str = "reach"          # value-plane workload; 'reach' = the
    #   boolean BFS with zero-size value placeholders


def _initial_state(pipeline: Pipeline, ctx: Context, num_vertices: int
                   ) -> TraversalState:
    cap_f, cap_r = pipeline.caps.frontier, pipeline.caps.result
    ej = _num_join(ctx)
    dev = ctx.join_src.device
    dense = pipeline.rep == "dense"
    track = pipeline.tracks_emitted
    deferred = pipeline.tracks_vertex_depth
    sr = (get_semiring(pipeline.semiring) if pipeline.semiring != "reach"
          else None)

    def full(shape, fill, dtype=torch.int32):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    def none(dtype=torch.int32):            # a zero-size placeholder
        return torch.zeros((0,), dtype=dtype, device=dev)

    # one 0-d zero serves every scalar: no operator writes a scalar in place
    zero = full((), 0)
    return TraversalState(
        frontier_pos=none() if dense else full((cap_f,), ej),
        frontier_count=zero,
        # deferred pipelines carry ONLY the vertex-depth array: no target
        # block, no dedup mask, no per-row result buffers in the loop
        targets=none() if deferred else full((cap_f,), -1),
        keep=none(torch.bool) if deferred else full((cap_f,), False,
                                                    torch.bool),
        frontier_bits=(full((num_vertices,), False, torch.bool)
                       if dense and not deferred else none(torch.bool)),
        emitted=full((ej,), False, torch.bool) if track else none(torch.bool),
        emit_depth=full((ej,), -1) if track else none(),
        visited=(none(torch.bool) if deferred
                 else full((num_vertices,), False, torch.bool)),
        result_pos=(full((cap_r,), ctx.table.num_rows)
                    if pipeline.rep == "pos" and not track else none()),
        result_depth=none() if track or deferred else full((cap_r,), -1),
        result_count=zero,
        depth=zero,
        overflow=full((), False, torch.bool),
        vertex_depth=full((num_vertices,), -1) if deferred else none(),
        visited_count=zero,
        level_dirs=(full((pipeline.max_depth + 2,), -1, torch.int8)
                    if pipeline.tracks_switch else none(torch.int8)),
        frontier_val=(none(torch.float32) if sr is None else
                      full((num_vertices if dense else cap_f,), sr.identity,
                           torch.float32)),
        vertex_val=(none(torch.float32) if sr is None else
                    full((num_vertices,), sr.identity, torch.float32)))


def _host_counts(pipeline: Pipeline, state: TraversalState, depth: int
                 ) -> HostCounts:
    """The level's scalars on the host, in ONE device-to-host copy: the
    frontier count, and for a switch pipeline also the discovered-vertex
    count its predicate reads (the deferred steps keep it as a scalar, the
    others pay a popcount of ``visited``)."""
    if not pipeline.tracks_switch:
        return HostCounts(depth, int(state.frontier_count.item()))
    visited = (state.visited_count if state.vertex_depth.shape[0]
               else state.visited.sum(dtype=torch.int32))
    frontier, visited = torch.stack([state.frontier_count, visited]).tolist()
    return HostCounts(depth, frontier, visited)


def fixed_point(pipeline: Pipeline, ctx: Context, root: int,
                num_vertices: int) -> BFSResult:
    """Run a pipeline to its fixed point: the operator steps composed in
    order, once per level, while the frontier is live and the depth bound
    is not reached (``depth <= max_depth`` for the inclusive dense
    pipelines).  The loop copies the level's scalars to the host once per
    level: one sync per level."""
    root = int(root)
    state = _initial_state(pipeline, ctx, num_vertices)
    state = pipeline.seed.init(ctx, state, root)
    for op in pipeline.ops:
        state = op.init(ctx, state, root)
    limit = pipeline.max_depth + (1 if pipeline.inclusive else 0)
    for depth in range(limit):
        host = _host_counts(pipeline, state, depth)
        if host.frontier <= 0:
            break
        state = state._replace(host=host)
        for op in pipeline.ops:
            state = op.step(ctx, state)
        state = state._replace(depth=state.depth + 1)
    return pipeline.finisher.finish(ctx, pipeline, state)


def execute(pipeline: Pipeline, ctx: Context, root: int, num_vertices: int
            ) -> BFSResult:
    """Single-root pipeline execution (the reference's jitted entry)."""
    return fixed_point(pipeline, ctx, root, num_vertices)
