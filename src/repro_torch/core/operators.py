"""Positional operator algebra + the fixed-point driver.

Every engine of the port is a :class:`Pipeline`: a seed operator, a tuple
of per-level operators and a finisher, run by ONE :func:`fixed_point`
driver.  The operators:

===================  ======================================================
``Seed``             the non-recursive CTE child (Filter on the root, the
                     root bit of a dense bitmap / vertex-depth array, or
                     the row store's SeqScan over interleaved rows)
``ReadTargets``      per-level read of the join column out of the frontier
                     (positions -> one column gather; tuples/rows -> free)
``VisitedDedup``     BFS vertex dedup (visited bitmap + scatter-argmin)
``CSRIndexJoin``     Fig. 4's IndexJoin: frontier vertices -> edge positions
                     through the CSR join index
``ScanHashJoin``     Fig. 3's HashJoin as PostgreSQL runs it on a heap
                     table: a full SeqScan probing the frontier hash
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
``EarlyMaterialize`` Fig. 3's per-level Materialize (tuple/row pipelines)
``AppendUnionAll``   the recursive UNION ALL: append the level block to the
                     working result, tagging each row with its BFS level
``LateMaterialize``  Fig. 4's single post-fixed-point Materialize
``EmitTuples``       tuple finisher: the rows materialized level by level
``ProjectRows``      row-store finisher: columns projected out of full rows
``TopLevelJoin``     the Exp-3 rewrite: ONE top-level join on ``id``
``CompactEmitted``   dense finisher: emitted-edge mask -> positions -> one
                     late gather
``DeferredEmit``     the same, deriving the emitted mask from per-vertex
                     depths in one pass after the fixed point
``MultiQuerySeed``   MS-BFS: each root's lane bit into one (V,) word
``MultiQueryWordSweep`` one bit-parallel level for every lane: segment-OR
                     of the in-neighbors' frontier words
``MultiQueryEmit``   per-lane deferred emission from the level snapshots
===================  ======================================================

Frontier representation per pipeline (``Pipeline.rep``): ``'pos'`` — a
block of edge positions (PRecursive, hybrid); ``'vals'`` — a block of
materialized column values (TRecursive); ``'rows'`` — a block of full
interleaved rows (the row-store emulation); ``'dense'`` — a boolean
vertex bitmap (bitmap) or, with deferred emission, the per-vertex depth
array (diropt).  State a pipeline does not use is a zero-size placeholder
(an empty dict for the value blocks), as in the reference; the semiring
value plane (``Pipeline.semiring`` other than ``'reach'``) adds a float32
frontier value and a (V,) per-vertex accumulator, zero-size for
``reach``, so the boolean paths are unchanged.

Positions contract: pipelines whose representation carries positions
(``'pos'``/``'dense'``, and any pipeline finished by :class:`TopLevelJoin`)
return real edge positions in ``BFSResult.positions``; pure tuple/row
pipelines return all ``-1`` (``Pipeline.carries_positions``).  Every
operator and finisher ``describe()``s itself; ``Pipeline.render`` draws
the plan's Volcano tree from them.

Direction: the join view (``ctx.join_src``/``ctx.join_dst`` and the CSR
over ``join_src``) decides it.  ``outbound`` uses (from, to); ``inbound``
the reverse; ``both`` the FUSED bidirectional view (``ctx.bidir``) with a
VIRTUAL 2E join space (position ``p < E`` is edge ``p`` forward, ``p >= E``
backward) folded back onto real edges at append time.

The reference decides its data-dependent branches (``lax.cond``) on the
device; here they are Python branches on host values.  The fixed-point
loop copies the level's scalars to the host once per level, in one
transfer (:class:`HostCounts`), and the operators branch on those.

Batched roots (:func:`fixed_point_batch`, the reference's vmap over one
``while_loop``): every state field gains a leading lane axis (the value
blocks' dicts too), and every operator runs on it, each lane along the
last axis: the weighted steps combine into (L, V) planes, each lane into
its own row, and the value appends land each lane's block at that lane's
own host count.  All lanes still in the loop share the level's depth; a
lane whose frontier dies is retired from the loop state, and one finisher
runs over every lane at the end.  Where lanes take different branches
(``HybridStep``'s sparse/dense, ``DirectionSwitch``'s push/pull) each side
runs on its own group of lanes (:func:`_lanes_split`).

Bit-parallel roots (:func:`multiquery_fixed_point`, MS-BFS): up to 32
roots are the bits of one word per vertex, and one sweep a level advances
them all; the result has the batch layout, lane ``i`` row-for-row equal
to the deferred-emission engines on ``roots[i]``.

Every gather clamps its indices and every dropping scatter routes dropped
entries to a spare slot: torch on CUDA asserts where JAX clamps or drops.
Public fields stay int32 (``level_dirs`` int8), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.frontier_pull.layout import PullLayout
from ..kernels.frontier_pull.ref import frontier_pull_ref
from ..kernels.spmm_segment.ops import segments
from .csr import CSRIndex, expand_frontier, expand_frontier_both, lane_take
from .positions import PosBlock, append_block, compact_mask
from .semiring import (elem_combine, get_semiring, or_combine, propagate,
                       scatter_combine)
from .table import ColumnTable, RowTable

__all__ = [
    "DIRECTIONS", "check_direction", "EngineCaps", "BFSResult", "Context",
    "HostCounts", "TraversalState", "Operator", "Seed", "ReadTargets",
    "VisitedDedup", "CSRIndexJoin", "ScanHashJoin", "DenseBitmapStep",
    "PullStep", "DirectionSwitch", "HybridStep", "HybridPullStep",
    "WeightedExpand", "WeightedDenseStep", "EarlyMaterialize",
    "AppendUnionAll", "LateMaterialize", "EmitTuples", "ProjectRows",
    "CompactEmitted", "DeferredEmit", "TopLevelJoin", "Pipeline",
    "fixed_point", "execute", "fixed_point_batch", "execute_batch",
    "dedup_targets", "bitmap_level", "append_values", "WORD_LANES",
    "MultiQueryState", "MultiQuerySeed", "MultiQueryWordSweep",
    "MultiQueryEmit", "multiquery_fixed_point", "execute_multiquery",
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
    """One root's result; a batch of roots adds a leading lane axis to
    every field."""

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
    None for unweighted traffic, which traverses with all-ones.
    ``pull_layout`` is the ``frontier_pull`` kernel's reverse layout of
    ``rcsr`` (None until the dataset builds it).  ``table`` is the column
    table and ``rows`` the row table (the row-store emulation's storage);
    either may be None where the pipeline reads only the other."""

    table: Optional[ColumnTable]
    csr: Optional[CSRIndex]
    join_src: torch.Tensor
    join_dst: torch.Tensor
    rcsr: Optional[CSRIndex] = None
    both_indptr: Optional[torch.Tensor] = None
    bidir: bool = False
    edge_weights: Optional[torch.Tensor] = None
    pull_layout: Optional[PullLayout] = None
    rows: Optional[RowTable] = None


class HostCounts(NamedTuple):
    """The level's scalars on the host, copied by the fixed-point loop once
    per level in one transfer: the depth of the level, its live frontier
    entries and (switch pipelines only) the vertices discovered before
    it.  ``appended`` is the rows appended to the working result so far:
    the frontier counts of the levels so far summed, this one's included,
    which (clamped to the result's capacity) is where the value appends
    write.  In a batch ``frontier``, ``visited`` and ``appended`` hold one
    int per lane still in the loop, which all share ``depth``."""

    depth: int = 0
    frontier: int | list[int] = 0
    visited: int | list[int] = 0
    appended: int | list[int] = 0


class TraversalState(NamedTuple):
    """The state the operators share across levels.  One frontier
    representation is active per pipeline; the others are zero-size.  In
    a batch every tensor field but ``depth`` has a leading lane axis (a
    zero-size field is (L, 0)); ``depth`` stays one 0-d tensor, the level
    shared by the lanes still in the loop, until the finisher gets each
    lane's own."""

    frontier_pos: torch.Tensor     # (F,) int32 join-space edge positions
    frontier_vals: Dict[str, torch.Tensor]  # tuple rep: name -> (F, ...)
    frontier_rows: torch.Tensor    # (F, W) float32 row-store rep
    frontier_count: torch.Tensor   # () int32 live frontier entries
    targets: torch.Tensor          # (F,) int32 target vertices
    keep: torch.Tensor             # (F,) bool survivors of dedup
    frontier_bits: torch.Tensor    # (V,) bool dense frontier
    emitted: torch.Tensor          # (EJ,) bool emitted-edge mask
    emit_depth: torch.Tensor       # (EJ,) int32 level of first emission
    visited: torch.Tensor          # (V,) bool BFS visited set
    result_pos: torch.Tensor       # (R,) int32 real result positions
    result_vals: Dict[str, torch.Tensor]  # tuple/row result buffers, name
    #   -> (R + F, ...): F spare rows past R take the dropped entries
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
    With a lane axis each lane has its own visited row and tickets: the
    first slot per vertex per lane.

    Returns (keep_mask, new_visited)."""
    cap = targets.shape[-1]
    nv = visited.shape[-1]
    safe = targets.clamp(0, nv - 1)
    fresh = valid & ~lane_take(visited, safe)
    slots = torch.arange(cap, dtype=torch.int32, device=targets.device)
    ticket = torch.full(visited.shape, cap, dtype=torch.int32,
                        device=targets.device)
    ticket.scatter_reduce_(-1, safe.long(), torch.where(fresh, slots, cap),
                           "amin")
    keep = fresh & (lane_take(ticket, safe) == slots)
    return keep, or_combine(visited, safe, keep)


def append_values(bufs: Dict[str, torch.Tensor], count: torch.Tensor,
                  vals: Dict[str, torch.Tensor], block_count: torch.Tensor,
                  cap_r: int, offset: int | list[int]
                  ) -> tuple[Dict[str, torch.Tensor], torch.Tensor,
                             torch.Tensor]:
    """Append a value block into larger result buffers (the tuple/row-store
    UNION ALL): the block's F rows go to slots ``count`` on, with its
    padding (rows from ``block_count`` on) masked to 0; only the first
    ``cap_r`` slots are results.  ``offset`` is ``count`` as the host knows
    it (:class:`HostCounts`), so the block lands by one contiguous copy:
    each buffer holds F spare rows past ``cap_r`` that take the rows past
    it, which are dropped, and padding lands on slots past the new count,
    which hold zeros.  The copy is in place (the buffers belong to the
    run).  With a lane axis (``count`` (L,), buffers (L, R + F, ...),
    blocks (L, F, ...), ``offset`` one int per lane) each lane's block
    lands at its own offset in its own rows, all lanes of a buffer by one
    ``index_copy_``.  Returns (bufs, new_count, overflowed)."""
    lead = count.dim()
    cap_f = next(iter(vals.values())).shape[lead]
    dev = count.device
    idx = torch.arange(cap_f, dtype=torch.int32, device=dev)
    if lead:
        # row i of lane l lands at flat row l * (R + F) + offset_l + i
        offs = torch.tensor(offset, dtype=torch.int64, device=dev)
        lanes = torch.arange(offs.shape[0], dtype=torch.int64, device=dev)
        rows = ((lanes * (cap_r + cap_f) + offs)[:, None] + idx).reshape(-1)
        live = (idx < block_count[:, None]) & (idx < cap_r - offs[:, None])
    else:
        live = (idx < block_count) & (idx < cap_r - offset)
    for k, buf in bufs.items():
        v = vals[k]
        mask = live.reshape(live.shape + (1,) * (v.dim() - live.dim()))
        block = torch.where(mask, v, 0)
        if lead:
            buf.flatten(0, 1).index_copy_(0, rows, block.flatten(0, 1))
        else:
            buf.narrow(0, offset, cap_f).copy_(block)
    new_count = (count + block_count).clamp(max=cap_r)
    return bufs, new_count, (count + block_count) > cap_r


def _num_real_rows(ctx: Context) -> int:
    """Real edge count E: of the column table, else of the row table."""
    if ctx.table is not None:
        return ctx.table.num_rows
    if ctx.rows is not None:
        return ctx.rows.num_rows
    return ctx.join_src.shape[0]


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
    e = _num_real_rows(ctx)
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


def _seed_mask(ctx: Context, root) -> torch.Tensor:
    """(EJ,) mask of join edges whose source is the root (the seed filter),
    or (L, EJ) for an (L, 1) tensor of roots.  Fused view: forward matches
    on ``from``, backward on ``to``."""
    if not ctx.bidir:
        return ctx.join_src == root
    return torch.cat([ctx.join_src == root, ctx.join_dst == root], -1)


def _hit_mask(ctx: Context, frontier_v: torch.Tensor) -> torch.Tensor:
    """(EJ,) mask of join edges whose SOURCE vertex is in ``frontier_v``:
    the rows one CTE level emits (push-side emission test); (L, EJ) for
    (L, V) lanes."""
    nv = frontier_v.shape[-1]
    if not ctx.bidir:
        return frontier_v[..., ctx.join_src.clamp(0, nv - 1)]
    return torch.cat([frontier_v[..., ctx.join_src.clamp(0, nv - 1)],
                      frontier_v[..., ctx.join_dst.clamp(0, nv - 1)]], -1)


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
    modified.  With a lane axis each lane sets its own row."""
    n = arr.shape[-1]
    ext = torch.cat([arr, arr.new_zeros(arr.shape[:-1] + (1,))], -1)
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    ext.scatter_(-1, idx.long(), vals.expand(idx.shape))
    return ext[..., :n]


def bitmap_level(from_col: torch.Tensor, to_col: torch.Tensor,
                 frontier_v: torch.Tensor, visited: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One dense push step.  Returns (edge_hit_mask, next_frontier,
    visited); edge_hit_mask marks the edges whose source is in the frontier
    (the rows the CTE emits this level).  (L, V) bitmaps step each lane."""
    nv = frontier_v.shape[-1]
    hit = frontier_v[..., from_col.clamp(0, nv - 1)]
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
    nv = frontier_v.shape[-1]
    src = ctx.join_src.clamp(0, nv - 1)
    dst = ctx.join_dst.clamp(0, nv - 1)
    hit_f = frontier_v[..., src]
    hit_b = frontier_v[..., dst]
    nxt = or_combine(or_combine(torch.zeros_like(frontier_v), dst, hit_f),
                     src, hit_b)
    nxt = nxt & ~visited
    return torch.cat([hit_f, hit_b], -1), nxt, visited | nxt


def _dense_pull(ctx: Context, frontier_v: torch.Tensor,
                visited: torch.Tensor, pull_fn=None) -> torch.Tensor:
    """One dense PULL (Beamer bottom-up) step: the next frontier is every
    UNVISITED vertex with an in-neighbor (over the join view) in the
    frontier bitmap.  Over the reverse CSR, ``pull_fn`` (the
    ``frontier_pull`` kernel wrapper, handed the context's pull layout) or,
    without one, its plain version computes it.  The fused view takes no
    kernel, as in the reference.  (L, V) bitmaps pull each lane, the kernel
    in one call for all of them."""
    nv = frontier_v.shape[-1]
    cand = ~visited
    empty = torch.zeros_like(frontier_v)
    if ctx.bidir:
        # fused view: both orientations contribute, natural edge order
        src = ctx.join_src.clamp(0, nv - 1)
        dst = ctx.join_dst.clamp(0, nv - 1)
        nxt = or_combine(
            or_combine(empty, dst, cand[..., dst] & frontier_v[..., src]),
            src, cand[..., src] & frontier_v[..., dst])
        return nxt & cand
    if pull_fn is not None and ctx.rcsr is None:
        raise ValueError(
            "the frontier_pull kernel walks the reverse CSR; call "
            "Dataset.ensure_reverse() before plugging it into a pull step")
    if ctx.rcsr is not None:
        if pull_fn is None:
            return frontier_pull_ref(ctx.rcsr, ctx.join_src, ctx.join_dst,
                                     frontier_v, visited)
        return pull_fn(ctx.rcsr, ctx.join_src, ctx.join_dst, frontier_v,
                       visited, layout=ctx.pull_layout)
    # no reverse CSR built (an outbound-only dataset on the CPU): the same
    # bottom-up test in natural edge order, with an identical result
    src = ctx.join_src.clamp(0, nv - 1)
    dst = ctx.join_dst.clamp(0, nv - 1)
    nxt = or_combine(empty, dst, cand[..., dst] & frontier_v[..., src])
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
    cap_r = result_depth.shape[-1]
    idx = torch.arange(block_cap, dtype=torch.int32,
                       device=result_depth.device)
    slots = count[..., None] + idx
    live = (idx < block_count[..., None]) & (slots < cap_r)
    return _set_drop(result_depth, torch.where(live, slots, cap_r), tag)


def _root_slot(root, n: int, device):
    """Where a root's entry sits in an (n,) vertex plane, clipped into
    [0, n) as the reference clips it; for a list of roots, the (lane,
    vertex) index of each lane's entry in an (L, n) plane."""
    if isinstance(root, int):
        return min(max(root, 0), n - 1)
    cols = torch.tensor([min(max(r, 0), n - 1) for r in root],
                        dtype=torch.int64, device=device)
    return torch.arange(len(root), device=device), cols


def _per_lane(fn, *counts):
    """``fn`` of one root's host counts, or the list of ``fn`` over the
    lanes of a batch's."""
    if isinstance(counts[0], list):
        return [fn(*c) for c in zip(*counts)]
    return fn(*counts)


def _lane_fields(state: TraversalState) -> dict:
    """The fields of a batch state with a lane axis: every tensor but the
    shared 0-d ``depth``, and the value-block dicts."""
    return {k: v for k, v in state._asdict().items()
            if (isinstance(v, torch.Tensor) and v.dim() > 0)
            or isinstance(v, dict)}


def _select_lanes(state: TraversalState, rows: list[int]) -> TraversalState:
    """The batch state of the lanes ``rows`` (in that order): every field
    with a lane axis copied by one ``index_select`` (each tensor of the
    value-block dicts too), the host counts cut to match.  The shared
    ``depth`` is kept."""
    idx = torch.tensor(rows, dtype=torch.int64, device=state.depth.device)

    def take(v):
        if isinstance(v, dict):
            return {k: t.index_select(0, idx) for k, t in v.items()}
        return v.index_select(0, idx)
    fields = {k: take(v) for k, v in _lane_fields(state).items()}
    host = state.host._replace(**{
        k: [v[i] for i in rows] for k, v in state.host._asdict().items()
        if isinstance(v, list)})
    return state._replace(host=host, **fields)


def _merge_lanes(parts: list, depth: torch.Tensor) -> TraversalState:
    """Put the states of ``parts``, a list of (lane rows, batch state) whose
    rows together are 0..L-1, back in lane order (their host counts too),
    with ``depth`` as the result's depth field."""
    rows = [r for part_rows, _ in parts for r in part_rows]
    first = parts[0][1]
    order = torch.empty(len(rows), dtype=torch.int64)
    order[torch.tensor(rows, dtype=torch.int64)] = torch.arange(len(rows))
    back = order.tolist()
    order = order.to(first.depth.device)

    def cat(vs):
        return torch.cat(vs).index_select(0, order)
    fields = {}
    for k, v in _lane_fields(first).items():
        if isinstance(v, dict):
            fields[k] = {name: cat([getattr(st, k)[name] for _, st in parts])
                         for name in v}
        else:
            fields[k] = cat([getattr(st, k) for _, st in parts])
    host = {}
    for k in first.host._fields:
        lists = [getattr(st.host, k) for _, st in parts]
        if all(isinstance(v, list) for v in lists):
            joined = [x for v in lists for x in v]
            host[k] = [joined[i] for i in back]
    return first._replace(depth=depth, host=first.host._replace(**host),
                          **fields)


def _lanes_split(state: TraversalState, flags, on_true, on_false
                 ) -> TraversalState:
    """A branch on host values: ``on_true(state)`` or ``on_false(state)``
    for one root (``flags`` a bool).  In a batch (``flags`` one bool per
    lane) each side runs on its own group of lanes, selected, stepped and
    put back in lane order; where every lane agrees, on the whole batch."""
    if isinstance(flags, bool):
        return on_true(state) if flags else on_false(state)
    if all(flags):
        return on_true(state)
    if not any(flags):
        return on_false(state)
    yes = [i for i, f in enumerate(flags) if f]
    no = [i for i, f in enumerate(flags) if not f]
    return _merge_lanes([(yes, on_true(_select_lanes(state, yes))),
                         (no, on_false(_select_lanes(state, no)))],
                        state.depth)


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

    def describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class Seed(Operator):
    """The non-recursive child of the CTE.

    kind='edges' — Filter[join_src = root] compacted to a position block;
    kind='dense' — the root bit in a dense vertex bitmap.
    scan='rows' emulates the PostgreSQL SeqScan: the filter reads the
    row table's ``label`` column, strided over the interleaved rows, cast
    to int32.  ``label`` names the filter column in the plan.
    A deferred-emission pipeline (one that carries ``vertex_depth``) seeds
    the root's depth 0 instead of any bitmap.  ``mark_emitted`` seeds the
    emitted-edge mask of the positional pipelines that carry one.
    ``semiring != 'reach'`` also seeds the value plane: the root's vertex
    value is the semiring's seed value and (edge kind) each seed edge
    carries seed ⊗ weight."""

    kind: str = "edges"
    scan: str = "columnar"
    label: str = "from"
    mark_emitted: bool = False
    semiring: str = "reach"

    def _init_weighted(self, ctx, state, root):
        sr = get_semiring(self.semiring)
        dev = state.depth.device
        r = _root_slot(root, state.visited.shape[-1], dev)
        visited = state.visited.clone()
        visited[r] = True
        vertex_val = state.vertex_val.clone()
        vertex_val[r] = sr.seed_value
        if self.kind == "dense":
            bits = torch.zeros_like(visited)
            bits[r] = True
            fval = torch.full(visited.shape, sr.identity,
                              dtype=torch.float32, device=dev)
            fval[r] = sr.seed_value
            return state._replace(frontier_bits=bits, visited=visited,
                                  vertex_val=vertex_val, frontier_val=fval,
                                  frontier_count=torch.ones_like(
                                      state.frontier_count))
        ej = _num_join(ctx)
        cap = state.frontier_pos.shape[-1]
        key = root if isinstance(root, int) else \
            torch.tensor(root, dtype=torch.int64, device=dev)[:, None]
        blk = compact_mask(_seed_mask(ctx, key), cap, ej)
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
        """``root`` is an int, or a list of ints for a batch."""
        if self.semiring != "reach":
            return self._init_weighted(ctx, state, root)
        dev = state.depth.device
        if state.vertex_depth.shape[-1]:
            # deferred emission: the per-vertex depth array IS the visited
            # set and the frontier (no separate bitmaps)
            vd = state.vertex_depth.clone()
            vd[_root_slot(root, vd.shape[-1], dev)] = 0
            one = torch.ones_like(state.visited_count)
            return state._replace(vertex_depth=vd, visited_count=one,
                                  frontier_count=one)
        r = _root_slot(root, state.visited.shape[-1], dev)
        visited = state.visited.clone()
        visited[r] = True
        if self.kind == "dense":
            bits = torch.zeros_like(visited)
            bits[r] = True
            return state._replace(frontier_bits=bits, visited=visited,
                                  frontier_count=torch.ones_like(
                                      state.frontier_count))
        ej = _num_join(ctx)
        cap = state.frontier_pos.shape[-1]
        key = root if isinstance(root, int) else \
            torch.tensor(root, dtype=torch.int64, device=dev)[:, None]
        mask = (ctx.rows.column(self.label).to(torch.int32) == key
                if self.scan == "rows" else _seed_mask(ctx, key))
        blk = compact_mask(mask, cap, ej)
        state = state._replace(frontier_pos=blk.positions,
                               frontier_count=blk.count, visited=visited)
        if self.mark_emitted:
            valid = blk.valid_mask()
            idx = torch.where(valid, blk.positions, ej)
            state = state._replace(
                emitted=_set_drop(state.emitted, idx, valid),
                emit_depth=_set_drop(state.emit_depth, idx, 0))
        return state

    def describe(self):
        if self.scan == "rows":
            return f"SeqScan[{self.label} = $root] -> full rows"
        if self.kind == "dense":
            return "SeedBitmap[$root]"
        return f"Filter[{self.label} = $root] -> PosBlock"


@dataclasses.dataclass(frozen=True)
class ReadTargets(Operator):
    """Per-level read of the join column out of the frontier.  For the
    positional rep (``source='pos'``) this is the ONLY per-level value
    gather (one column); the tuple (``'vals'``) and row (``'rows'``) reps
    already paid for it at materialization time and read column ``col``
    of the block, cast to int32."""

    source: str = "pos"     # 'pos' | 'vals' | 'rows'
    col: str = "to"

    def step(self, ctx, state):
        cap = state.targets.shape[-1]
        valid = torch.arange(cap, dtype=torch.int32,
                             device=state.targets.device) \
            < state.frontier_count[..., None]
        if self.source == "pos":
            t = _join_dst_at(ctx, state.frontier_pos)
        elif self.source == "vals":
            t = state.frontier_vals[self.col].to(torch.int32)
        else:
            t = state.frontier_rows[..., ctx.rows.slot(self.col)].to(
                torch.int32)
        return state._replace(targets=torch.where(valid, t, -1), keep=valid)

    def describe(self):
        what = {"pos": "positions", "vals": "tuple block",
                "rows": "row block"}[self.source]
        return f"ReadCol[{self.col}]({what})"


@dataclasses.dataclass(frozen=True)
class VisitedDedup(Operator):
    """BFS semantics: a vertex expands at most once (visited bitmap +
    within-level scatter-argmin)."""

    def step(self, ctx, state):
        keep, visited = dedup_targets(state.targets, state.keep,
                                      state.visited)
        return state._replace(targets=torch.where(keep, state.targets, -1),
                              keep=keep, visited=visited)

    def describe(self):
        return "VisitedDedup[bitmap]"


@dataclasses.dataclass(frozen=True)
class CSRIndexJoin(Operator):
    """Fig. 4's IndexJoin: expand frontier vertices into the positions of
    their out-edges through the CSR join index — positions in, positions
    out, no values touched.  ``expand_fn`` plugs in the kernel."""

    expand_fn: Optional[Callable] = None

    def step(self, ctx, state):
        cap = state.frontier_pos.shape[-1]
        epos, total, ovf = _expand_join(ctx, state.targets, state.keep, cap,
                                        self.expand_fn)
        return state._replace(frontier_pos=epos, frontier_count=total,
                              overflow=state.overflow | ovf)

    def describe(self):
        return "IndexJoin[CSR(join_src)](CTE, edges)"


@dataclasses.dataclass(frozen=True)
class ScanHashJoin(Operator):
    """Fig. 3's HashJoin as PostgreSQL executes it without an index: build a
    hash of the frontier's vertex set (an or-scatter), then SeqScan the
    WHOLE row table's ``from`` column, strided over its rows, probing it
    every level.  The hits compact into the next position block with no
    host sync; more hits than the block holds set the overflow flag."""

    def step(self, ctx, state):
        nv = state.visited.shape[-1]
        cap = state.frontier_pos.shape[-1]
        probe = or_combine(torch.zeros_like(state.visited),
                           state.targets.clamp(0, nv - 1), state.keep)
        scan_from = ctx.rows.column("from").to(torch.int32)   # full scan
        hit = probe[..., scan_from.clamp(0, nv - 1)] & (scan_from >= 0)
        blk = compact_mask(hit, cap, ctx.rows.num_rows)
        ovf = hit.sum(-1, dtype=torch.int32) > cap
        return state._replace(frontier_pos=blk.positions,
                              frontier_count=blk.count,
                              overflow=state.overflow | ovf)

    def describe(self):
        return "HashJoin[from = cte.to](Hash(cte), SeqScan(edges))"


def _record_deferred(state: TraversalState, new: torch.Tensor
                     ) -> TraversalState:
    """Deferred-emission bookkeeping: the loop carries ONLY the per-vertex
    depth array (frontier = ``vd == depth``, visited = ``vd >= 0``) plus
    the scalar visited count the switch predicate reads.  Newly discovered
    vertices get depth ``state.depth + 1``; the emitted mask is derived
    once, after the fixed point."""
    count = new.sum(-1, dtype=torch.int32)
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
        nv = vd.shape[-1]
        src = ctx.join_src.clamp(0, nv - 1)
        dst = ctx.join_dst.clamp(0, nv - 1)
        # frontier membership fused into the edge gather (vd[src] == depth)
        empty = torch.zeros(vd.shape, dtype=torch.bool, device=vd.device)
        tgt = or_combine(empty, dst, vd[..., src] == state.depth)
        if ctx.bidir:
            tgt = or_combine(tgt, src, vd[..., dst] == state.depth)
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
            frontier_count=nxt.sum(-1, dtype=torch.int32))

    def describe(self):
        tag = ", deferred emit" if self.deferred else ""
        return f"BitmapStep[push: frontier bits -> edge mask{tag}]"


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
            frontier_count=nxt.sum(-1, dtype=torch.int32))

    def describe(self):
        how = "kernel" if self.expand_fn is not None else "reverse CSR"
        return f"PullStep[bottom-up: unvisited <- frontier bits ({how})]"


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
    decision is recorded in ``level_dirs``.  In a batch each lane decides
    from its own counts, as under the reference's vmap."""

    push: Operator
    pull: Operator
    alpha: float = 1.0
    beta: float = 64.0

    def use_pull(self, ctx, state) -> bool | list[bool]:
        f32 = np.float32
        nv = state.vertex_depth.shape[-1] or state.visited.shape[-1]
        avg = f32(float(_num_join(ctx)) / max(float(nv), 1.0))
        # dense/deferred frontier: the count is VERTICES, scaled by the
        # average out-degree to the push side's edge work; a positional
        # frontier's edge block IS the push side's work
        dense = bool(state.frontier_bits.shape[-1]
                     or state.vertex_depth.shape[-1])

        def decide(frontier: int, visited: int) -> bool:
            n_f = f32(frontier)
            m_f = n_f * avg if dense else n_f
            m_u = f32(nv - visited) * avg
            return bool((f32(self.alpha) * m_f > m_u)
                        & (f32(self.beta) * n_f >= f32(nv)))

        return _per_lane(decide, state.host.frontier, state.host.visited)

    def step(self, ctx, state):
        def side(pull: bool):
            def run(s):
                if s.level_dirs.shape[-1]:
                    # written in place: the state's level_dirs belongs to
                    # this run
                    idx = min(s.host.depth, s.level_dirs.shape[-1] - 1)
                    s.level_dirs[..., idx] = int(pull)
                # a Python branch runs only the chosen side: for the
                # deferred steps that is the reference's narrow exchange of
                # one (V,) mask
                return (self.pull if pull else self.push).step(ctx, s)
            return run

        return _lanes_split(state, self.use_pull(ctx, state), side(True),
                            side(False))

    def describe(self):
        return (f"DirectionSwitch[a={self.alpha:g} b={self.beta:g}: "
                f"{self.push.describe()} | {self.pull.describe()}]")


def _install_edge_frontier(ctx: Context, state: TraversalState,
                           nxt: PosBlock, visited: torch.Tensor,
                           ovf: torch.Tensor) -> TraversalState:
    """Shared positional-frontier bookkeeping (HybridStep and its pull
    twin): install the next edge block and mark its positions emitted at
    ``depth + 1``.  ``new`` reads ``emitted`` before it is written."""
    ej = _num_join(ctx)
    valid = nxt.valid_mask()
    idx = torch.where(valid, nxt.positions, ej)
    new = valid & ~lane_take(state.emitted, nxt.positions.clamp(0, ej - 1))
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
    The branch is taken on the host count of the level's frontier, in a
    batch per lane.  ``expand_fn`` plugs a kernel into the sparse branch's
    IndexJoin."""

    switch_frac: float = 0.05
    expand_fn: Optional[Callable] = None

    def step(self, ctx, state):
        threshold = max(1, int(state.visited.shape[-1] * self.switch_frac))
        sparse = _per_lane(lambda f: f < threshold, state.host.frontier)
        return _lanes_split(state, sparse, lambda s: self._sparse(ctx, s),
                            lambda s: self._dense(ctx, s))

    def _sparse(self, ctx, state):
        cap = state.frontier_pos.shape[-1]
        frontier = PosBlock(state.frontier_pos, state.frontier_count)
        fvalid = frontier.valid_mask()
        targets = torch.where(
            fvalid, _join_dst_at(ctx, frontier.positions), -1)
        keep, visited = dedup_targets(targets, fvalid, state.visited)
        targets = torch.where(keep, targets, -1)
        epos, total, ovf = _expand_join(ctx, targets, keep, cap,
                                        self.expand_fn)
        return _install_edge_frontier(ctx, state, PosBlock(epos, total),
                                      visited, ovf)

    def _dense(self, ctx, state):
        nv = state.visited.shape[-1]
        cap = state.frontier_pos.shape[-1]
        frontier = PosBlock(state.frontier_pos, state.frontier_count)
        fvalid = frontier.valid_mask()
        targets = _join_dst_at(ctx, frontier.positions)
        # boolean OR (scatter-max): padded slots (clamped onto a real
        # vertex) must never UNSET a vertex another slot reached
        tgt_v = or_combine(torch.zeros_like(state.visited),
                           targets.clamp(0, nv - 1), fvalid)
        tgt_v = tgt_v & ~state.visited
        visited = state.visited | tgt_v
        hit = _hit_mask(ctx, tgt_v)
        nxt = compact_mask(hit, cap, _num_join(ctx))
        ovf = hit.sum(-1, dtype=torch.int32) > cap
        return _install_edge_frontier(ctx, state, nxt, visited, ovf)

    def describe(self):
        return (f"DirectionOpt[<{self.switch_frac:g}V: IndexJoin[CSR] | "
                f"else BitmapStep]")


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
        nv = state.visited.shape[-1]
        cap = state.frontier_pos.shape[-1]
        fvalid = PosBlock(state.frontier_pos, state.frontier_count
                          ).valid_mask()
        srcs = _join_src_at(ctx, state.frontier_pos)
        prev_v = or_combine(torch.zeros_like(state.visited),
                            srcs.clamp(0, nv - 1), fvalid)
        tgt_v = _dense_pull(ctx, prev_v, state.visited, self.expand_fn)
        hit = _hit_mask(ctx, tgt_v)
        nxt = compact_mask(hit, cap, ej)
        ovf = hit.sum(-1, dtype=torch.int32) > cap
        return _install_edge_frontier(ctx, state, nxt, state.visited | tgt_v,
                                      ovf)

    def describe(self):
        return "PullStep[bottom-up over reverse CSR -> edge block]"


def _level_plane(sr, nv: int, idx: torch.Tensor, vals: torch.Tensor
                 ) -> torch.Tensor:
    """The (V,) level plane: the arrivals ``vals`` ⊕-combined per target
    vertex ``idx`` (``nv`` drops a lane), the identity where none
    arrived.  (L, m) arrivals give (L, V) planes, each lane's arrivals in
    its own row and its dropped ones on its own spare slot; ``idx`` is
    (L, m) or one (m,) index shared by the lanes."""
    return scatter_combine(sr, torch.full(vals.shape[:-1] + (nv,),
                                          sr.identity, dtype=torch.float32,
                                          device=vals.device), idx, vals)


def _fold_level(sr, lvl: torch.Tensor, idx: torch.Tensor,
                valid: torch.Tensor, vertex_val: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """⊕-fold the level plane into the accumulator of the vertices that
    received an arrival (``idx`` where ``valid``), lane by lane for (L, V)
    planes.  Returns (received, vertex_val)."""
    received = or_combine(torch.zeros(vertex_val.shape, dtype=torch.bool,
                                      device=lvl.device), idx, valid)
    return received, torch.where(received,
                                 elem_combine(sr, vertex_val, lvl),
                                 vertex_val)


def _combine_arrivals(ctx: Context, sr, state: TraversalState,
                      slots: torch.Tensor):
    """The positional frontier's arrivals (``slots`` = arange(F))
    ⊕-combined per target vertex and folded into the accumulator, each
    lane of a batch into its own row.  Returns (valid, targets, clamped
    targets, level plane, vertex_val)."""
    nv = state.vertex_val.shape[-1]
    valid = slots < state.frontier_count[..., None]
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
    slot; the expansion is integer, so the result is the same).  In a
    batch every lane combines, tickets and expands on its own row, the
    expansion in one call for all lanes."""

    semiring: str
    expand_fn: Optional[Callable] = None

    def step(self, ctx, state):
        sr = get_semiring(self.semiring)
        cap = state.frontier_pos.shape[-1]
        nv = state.vertex_val.shape[-1]
        slots = torch.arange(cap, dtype=torch.int32,
                             device=state.frontier_pos.device)
        valid, t, safe, lvl, new_vv = _combine_arrivals(ctx, sr, state,
                                                        slots)
        if sr.improving:                 # frontier = strictly improved
            eligible = valid & lane_take(lvl < state.vertex_val, safe)
        else:                            # frontier = every receiver
            eligible = valid
        # one ticket row per lane, each with its own spare slot nv
        ticket = torch.full(state.vertex_val.shape[:-1] + (nv + 1,), cap,
                            dtype=torch.int32, device=slots.device)
        ticket.scatter_reduce_(-1, torch.where(eligible, safe, nv).long(),
                               torch.where(eligible, slots, cap), "amin")
        winner = eligible & (lane_take(ticket, safe) == slots)
        targets = torch.where(winner, t, -1)
        epos, total, ovf = _expand_join(ctx, targets, winner, cap,
                                        self.expand_fn)
        sval = lane_take(lvl, _join_src_at(ctx, epos).clamp(0, nv - 1))
        fval = torch.where(slots < total[..., None],
                           propagate(sr, sval, _edge_weight_at(ctx, epos)),
                           sr.identity)
        return state._replace(frontier_pos=epos, frontier_count=total,
                              frontier_val=fval, vertex_val=new_vv,
                              targets=targets, keep=winner,
                              overflow=state.overflow | ovf)

    def describe(self):
        return (f"WeightedExpand[{self.semiring}: combine(+)=per-vertex, "
                "winner -> IndexJoin[CSR(join_src)]]")


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
    masks the sorted sources; a batch hands the kernel every lane's values
    and frontier bits in one call, which masks each lane's sources itself.
    Every other ⊕, and a step without a kernel, uses
    :func:`scatter_combine`, each lane into its own row.  Single-direction
    views only.

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
        nv = state.vertex_val.shape[-1]
        s = segments(ctx.join_dst.clamp(0, nv - 1), nv)
        src = ctx.join_src.clamp(0, nv - 1)[s.order]
        return state._replace(segments=(src, s.seg,
                                        _edge_weights(ctx)[s.order],
                                        s.offsets))

    def step(self, ctx, state):
        sr = get_semiring(self.semiring)
        nv = state.vertex_val.shape[-1]
        src = ctx.join_src.clamp(0, nv - 1)
        dst = ctx.join_dst.clamp(0, nv - 1)
        hit = state.frontier_bits[..., src]
        if self._uses_kernel(sr):
            s_src, s_dst, s_w, offsets = state.segments
            if state.frontier_bits.dim() == 1:
                s_src = torch.where(state.frontier_bits[s_src], s_src, nv)
                lvl = self.spmm_fn(state.frontier_val[:, None], s_src,
                                   s_dst, s_w, offsets)[:, 0]
            else:   # every lane in one call, masked by its frontier bits
                lvl = self.spmm_fn(state.frontier_val[..., None], s_src,
                                   s_dst, s_w, offsets,
                                   state.frontier_bits.contiguous())[..., 0]
        else:
            prop = propagate(sr, state.frontier_val[..., src],
                             _edge_weights(ctx))
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
            frontier_count=nxt.sum(-1, dtype=torch.int32))

    def describe(self):
        how = ("spmm_segment kernel" if self.spmm_fn is not None
               else "(+)-scatter")
        return f"BitmapStep[weighted {self.semiring}: {how}]"


@dataclasses.dataclass(frozen=True)
class EarlyMaterialize(Operator):
    """Fig. 3's per-level Materialize: turn the positional join output into
    value tuples (or full interleaved rows) IMMEDIATELY — the (3+N) gathers
    per level that the positional plan avoids.  Column mode is one
    ``ColumnTable.take`` of ``cols``; row mode one ``RowTable.take_rows``.
    ``with_next`` also carries the join-space next-vertex column
    ``__next__`` (-1 on padding), which ``direction='both'`` needs once
    positions fold to real edges.  ``init`` materializes the seed block."""

    cols: Tuple[str, ...] = ()
    rows: bool = False
    with_next: bool = False

    def init(self, ctx, state, root):
        return self._materialize(ctx, state)

    def step(self, ctx, state):
        return self._materialize(ctx, state)

    def _materialize(self, ctx, state):
        pos_real = _to_real(ctx, state.frontier_pos)
        if self.rows:
            return state._replace(frontier_rows=ctx.rows.take_rows(pos_real))
        vals = ctx.table.take(pos_real, self.cols)
        if self.with_next:
            valid = state.frontier_pos < _num_join(ctx)
            vals["__next__"] = torch.where(
                valid, _join_dst_at(ctx, state.frontier_pos), -1)
        return state._replace(frontier_vals=vals)

    def describe(self):
        if self.rows:
            return "Materialize[* full rows](heap read)"
        return f"Materialize[{', '.join(self.cols)}](EVERY level)"


@dataclasses.dataclass(frozen=True)
class AppendUnionAll(Operator):
    """The recursive UNION ALL: append the level's block to the working
    result, tagging every appended row with its BFS level.  ``rep`` is the
    block appended: ``'pos'`` the real positions, ``'vals'`` the tuple
    columns ``cols``, ``'rows'`` the full rows (one ``'rows'`` buffer).
    The first value append allocates the result buffers in the values'
    dtypes; in a batch each lane's block lands at that lane's own count
    (:func:`append_values`).  ``init`` appends the seed block as level
    ``depth`` unless
    ``append_seed`` is off; ``step`` appends level ``depth +
    step_tag_offset``."""

    rep: str = "pos"            # 'pos' | 'vals' | 'rows'
    cols: Tuple[str, ...] = ()  # result columns for rep='vals'
    step_tag_offset: int = 1
    append_seed: bool = True

    def init(self, ctx, state, root):
        if not self.append_seed:
            return state
        return self._append(ctx, state, state.depth)

    def step(self, ctx, state):
        return self._append(ctx, state, state.depth + self.step_tag_offset)

    def _append(self, ctx, state, tag):
        if self.rep == "pos":
            block = PosBlock(_to_real(ctx, state.frontier_pos),
                             state.frontier_count)
            rpos, rcount, ovf = append_block(state.result_pos,
                                             state.result_count, block)
            rdepth = _tag_depths(state.result_depth, state.result_count,
                                 block.capacity, block.count, tag)
            return state._replace(result_pos=rpos, result_count=rcount,
                                  result_depth=rdepth,
                                  overflow=state.overflow | ovf)
        if self.rep == "vals":
            vals = {k: state.frontier_vals[k] for k in self.cols}
        else:
            vals = {"rows": state.frontier_rows}
        cap_r = state.result_depth.shape[-1]
        lead = state.result_count.dim()       # 1 with a lane axis
        bufs = state.result_vals
        if not bufs:     # the first append allocates the result buffers
            bufs = {k: torch.zeros(v.shape[:lead]
                                   + (cap_r + v.shape[lead],)
                                   + v.shape[lead + 1:],
                                   dtype=v.dtype, device=v.device)
                    for k, v in vals.items()}
        appended = state.host.appended
        if lead:
            lanes = state.result_count.shape[0]
            offset = [min(a, cap_r) for a in (
                appended if isinstance(appended, list)
                else [appended] * lanes)]
        else:
            offset = min(appended, cap_r)
        bufs, rcount, ovf = append_values(
            bufs, state.result_count, vals, state.frontier_count, cap_r,
            offset)
        block_cap = next(iter(vals.values())).shape[lead]
        rdepth = _tag_depths(state.result_depth, state.result_count,
                             block_cap, state.frontier_count, tag)
        return state._replace(result_vals=bufs, result_count=rcount,
                              result_depth=rdepth,
                              overflow=state.overflow | ovf)

    def describe(self):
        return "UnionAll[append working table]"


def _drain_value_frontier(ctx: Context, pipeline: "Pipeline",
                          state: TraversalState) -> torch.Tensor:
    """Fold the FINAL frontier's arrivals into the vertex accumulator.

    :class:`WeightedExpand` ⊕-combines the arrivals of the previous
    expansion at the start of each step, so when the depth bound (rather
    than convergence) stops the loop, the last expansion's rows are in the
    result but their values still sit in ``frontier_val``.  The dense step
    combines in the level it emits, so only the positional finisher needs
    this; it changes nothing on a converged (empty) frontier.  A batch
    drains each lane's frontier into its own row."""
    slots = torch.arange(state.frontier_pos.shape[-1], dtype=torch.int32,
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

    def describe(self):
        return (f"Materialize[{', '.join(self.cols)}]"
                "  <- ONE late gather, after the fixed point")


def _no_positions(state: TraversalState) -> torch.Tensor:
    """The (R,) positions of a tuple or row pipeline: all -1."""
    return torch.full(state.result_depth.shape, -1, dtype=torch.int32,
                      device=state.result_depth.device)


def _result_rows(state: TraversalState, name: str) -> torch.Tensor:
    """Result buffer ``name`` without its spare rows (each lane's, in a
    batch)."""
    return state.result_vals[name].narrow(state.result_depth.dim() - 1, 0,
                                          state.result_depth.shape[-1])


@dataclasses.dataclass(frozen=True)
class EmitTuples:
    """Tuple-pipeline finisher: the result was materialized level by level;
    positions are unavailable (all -1) — the Fig. 3 contract."""

    cols: Tuple[str, ...]

    def finish(self, ctx, pipeline, state):
        values = {k: _result_rows(state, k) for k in self.cols}
        return BFSResult(values, _no_positions(state), state.result_count,
                         state.depth, state.overflow, state.result_depth)

    def describe(self):
        return f"Emit[{', '.join(self.cols)}](pre-materialized; positions=-1)"


@dataclasses.dataclass(frozen=True)
class ProjectRows:
    """Row-store finisher: project the output columns (float32) back out of
    the gathered full rows; positions are unavailable (all -1)."""

    cols: Tuple[str, ...]

    def finish(self, ctx, pipeline, state):
        values = ctx.rows.project(_result_rows(state, "rows"), self.cols)
        return BFSResult(values, _no_positions(state), state.result_count,
                         state.depth, state.overflow, state.result_depth)

    def describe(self):
        return f"Project[{', '.join(self.cols)}](full rows)"


@dataclasses.dataclass(frozen=True)
class TopLevelJoin:
    """The paper's Exp-3 rewriting: the recursion carried only (id, to); the
    payload columns come back through ONE top-level hash join on ``id``,
    realized as an inverse-permutation probe array built by a scatter.  On
    the row store the probe reads the strided ``id`` column, cast to int32
    and clipped into [0, E - 1], and the join re-gathers full rows — the
    rewrite cannot rescue a heap table.  Its positions are real ones.

    Where ids repeat, the reference's scatter keeps the last row; here an
    ``amax`` scatter of the row numbers keeps the same one on every
    device.  An id outside [-E, E) is dropped and one in [-E, 0) counts
    from the end once, as a JAX ``.at[]`` does.  A batch probes the one
    array with every lane's ids, and its join is one take of every
    lane's rows."""

    cols: Tuple[str, ...]
    inner: object
    use_rows: bool = False

    def finish(self, ctx, pipeline, state):
        slim = self.inner.finish(ctx, pipeline, state)
        if self.use_rows:
            e = ctx.rows.num_rows
            idx = ctx.rows.column("id").to(torch.int32).clamp(0, e - 1)
        else:
            e = ctx.table.num_rows
            idx = ctx.table.column("id")
            idx = torch.where(idx < 0, idx + e, idx)
            idx = torch.where((idx >= 0) & (idx < e), idx, e)
        probe = torch.zeros((e + 1,), dtype=torch.int32, device=idx.device)
        probe.scatter_reduce_(0, idx.long(), torch.arange(
            e, dtype=torch.int32, device=idx.device), "amax")
        cap_r = slim.positions.shape[-1]
        live = torch.arange(cap_r, dtype=torch.int32,
                            device=idx.device) < slim.count[..., None]
        ids = torch.where(live, slim.values["id"].to(torch.int32), -1)
        pos = torch.where(live, probe[ids.clamp(0, e - 1)], e)
        if self.use_rows:
            values = ctx.rows.project(ctx.rows.take_rows(pos), self.cols)
        else:
            values = ctx.table.take(pos, self.cols)
        return BFSResult(values, pos, slim.count, slim.depth, slim.overflow,
                         slim.row_depths, vertex_values=slim.vertex_values)

    def describe(self):
        return (f"HashJoin[id = cte.id](Hash(id -> pos), "
                f"{self.inner.describe()})")


@dataclasses.dataclass(frozen=True)
class CompactEmitted:
    """Dense-pipeline finisher: compact the emitted-edge mask into a
    position block, then late-materialize (one ``ColumnTable.take``): the
    dense plan keeps the positional contract."""

    cols: Tuple[str, ...]

    def finish(self, ctx, pipeline, state):
        return _emit(ctx, pipeline.caps.result, self.cols, state.emitted,
                     state.emit_depth, *_state_tail(state))

    def describe(self):
        return (f"Materialize[{', '.join(self.cols)}](Compact(emitted mask))"
                "  <- ONE late gather")


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
        emitted, src_depth = _deferred_mask(ctx, state.vertex_depth,
                                            state.depth)
        return _emit(ctx, pipeline.caps.result, self.cols, emitted,
                     src_depth, *_state_tail(state))

    def describe(self):
        return (f"Materialize[{', '.join(self.cols)}]"
                "(Compact(vertex depths -> emitted))  <- ONE deferred pass")


def _deferred_mask(ctx: Context, vertex_depth: torch.Tensor,
                   depth: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Deferred emission: the (EJ,) emitted mask and per-edge level from
    per-vertex BFS depths (-1 = undiscovered).  A join edge is emitted iff
    its source vertex was discovered strictly before the last executed
    level ``depth``; (L, V) depths with (L,) ``depth`` give (L, EJ)."""
    nv = vertex_depth.shape[-1]
    src_depth = vertex_depth[..., ctx.join_src.clamp(0, nv - 1)]
    if ctx.bidir:
        src_depth = torch.cat(
            [src_depth, vertex_depth[..., ctx.join_dst.clamp(0, nv - 1)]],
            -1)
    return (src_depth >= 0) & (src_depth < depth[..., None]), src_depth


def _state_tail(state: TraversalState) -> tuple:
    """The result fields a finisher takes over from the loop state: depth,
    overflow, and the switch decisions and value plane where the pipeline
    has them."""
    dirs = state.level_dirs if state.level_dirs.shape[-1] else None
    vv = state.vertex_val if state.vertex_val.shape[-1] else None
    return state.depth, state.overflow, dirs, vv


def _emit(ctx: Context, cap_r: int, cols: Tuple[str, ...],
          emitted: torch.Tensor, edge_depth: torch.Tensor,
          depth: torch.Tensor, overflow: torch.Tensor,
          dirs: Optional[torch.Tensor] = None,
          vv: Optional[torch.Tensor] = None) -> BFSResult:
    """The dense finishers' shared tail: (EJ,) emitted mask and per-edge
    level -> compacted positions, one late gather, row depths (each lane
    compacted on its own, one gather for all lanes)."""
    ej = _num_join(ctx)
    blk = compact_mask(emitted, cap_r, ej)
    pos_real = _to_real(ctx, blk.positions)
    values = ctx.table.take(pos_real, cols)
    overflow = overflow | (emitted.sum(-1, dtype=torch.int32) > cap_r)
    row_depths = torch.where(
        blk.valid_mask(),
        lane_take(edge_depth, blk.positions.clamp(0, ej - 1)), -1)
    return BFSResult(values, pos_real, blk.count, depth, overflow,
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
    rep: str = "pos"                 # 'pos' | 'vals' | 'rows' | 'dense'
    inclusive: bool = False          # loop while depth <= max_depth (dense)
    tracks_emitted: bool = False     # carries the (EJ,) emitted-edge mask
    tracks_vertex_depth: bool = False  # deferred emission: (V,) depths
    tracks_switch: bool = False      # records per-level push/pull decisions
    semiring: str = "reach"          # value-plane workload; 'reach' = the
    #   boolean BFS with zero-size value placeholders

    @property
    def carries_positions(self) -> bool:
        """The positions contract: see the module docstring."""
        return (self.rep in ("pos", "dense")
                or isinstance(self.finisher, TopLevelJoin))

    def render(self, root=0) -> str:
        """The Volcano tree of the actual composition (Fig. 3/4 audit)."""
        loop = "\n".join(f"    {op.describe()}" for op in self.ops)
        seed = self.seed.describe().replace("$root", str(root))
        return (f"{self.finisher.describe()}\n"
                f"  {self.name}(maxrec={self.max_depth})\n"
                f"    {seed}            (non-recursive child)\n"
                f"{loop}")


def _initial_state(pipeline: Pipeline, ctx: Context, num_vertices: int,
                   lanes: Optional[int] = None) -> TraversalState:
    """The state before the seed; with ``lanes``, of a batch: every field
    but ``depth`` with a leading lane axis."""
    cap_f, cap_r = pipeline.caps.frontier, pipeline.caps.result
    ej = _num_join(ctx)
    dev = ctx.join_src.device
    dense = pipeline.rep == "dense"
    track = pipeline.tracks_emitted
    deferred = pipeline.tracks_vertex_depth
    sr = (get_semiring(pipeline.semiring) if pipeline.semiring != "reach"
          else None)
    lead = () if lanes is None else (lanes,)

    def full(shape, fill, dtype=torch.int32):
        return torch.full(lead + shape, fill, dtype=dtype, device=dev)

    def none(dtype=torch.int32):            # a zero-size placeholder
        return torch.zeros(lead + (0,), dtype=dtype, device=dev)

    # one zero serves every scalar (and, for one root, the depth): no
    # operator writes a scalar in place
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
        frontier_vals={},
        frontier_rows=torch.zeros(lead + (0, 0), dtype=torch.float32,
                                  device=dev),
        result_pos=(full((cap_r,), _num_real_rows(ctx))
                    if pipeline.rep == "pos" and not track else none()),
        result_vals={},
        result_depth=none() if track or deferred else full((cap_r,), -1),
        result_count=zero,
        depth=zero if lanes is None else torch.zeros(
            (), dtype=torch.int32, device=dev),
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
    others pay a popcount of ``visited``).  In a batch, one copy of (L,)
    or (2, L) counts for all lanes."""
    if not pipeline.tracks_switch:
        return HostCounts(depth, state.frontier_count.tolist())
    visited = (state.visited_count if state.vertex_depth.shape[-1]
               else state.visited.sum(-1, dtype=torch.int32))
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
    appended = 0
    for depth in range(limit):
        host = _host_counts(pipeline, state, depth)
        if host.frontier <= 0:
            break
        appended += host.frontier
        state = state._replace(host=host._replace(appended=appended))
        for op in pipeline.ops:
            state = op.step(ctx, state)
        state = state._replace(depth=state.depth + 1)
    return pipeline.finisher.finish(ctx, pipeline, state)


def execute(pipeline: Pipeline, ctx: Context, root: int, num_vertices: int
            ) -> BFSResult:
    """Single-root pipeline execution (the reference's jitted entry)."""
    return fixed_point(pipeline, ctx, root, num_vertices)


def fixed_point_batch(pipeline: Pipeline, ctx: Context, roots,
                      num_vertices: int) -> BFSResult:
    """Run a pipeline for many roots at once: the state carries a
    leading lane axis, the operators step every lane still in the loop
    together, and the level's scalars come to the host once per level for
    all of them.  A lane whose frontier has died (or that reached the
    depth bound) is retired from the loop state, as the reference's vmap
    freezes it; the loop ends when no lane is left, and one finisher runs
    over the retired states put back in lane order.  Lane ``i`` of the
    result is bit-identical to :func:`fixed_point` on ``roots[i]``."""
    roots = [int(r) for r in roots]
    state = _initial_state(pipeline, ctx, num_vertices, lanes=len(roots))
    state = pipeline.seed.init(ctx, state, roots)
    for op in pipeline.ops:
        state = op.init(ctx, state, roots)
    limit = pipeline.max_depth + (1 if pipeline.inclusive else 0)
    lanes = list(range(len(roots)))       # the lanes still in the loop
    retired = []                          # (lanes, their state)
    depths = [0] * len(roots)             # levels each lane executed
    appended = [0] * len(roots)           # rows each lane appended
    for depth in range(limit):
        if not lanes:
            break
        host = _host_counts(pipeline, state, depth)
        for lane, f in zip(lanes, host.frontier):
            appended[lane] += f
        state = state._replace(host=host._replace(
            appended=[appended[lane] for lane in lanes]))
        live = [i for i, f in enumerate(state.host.frontier) if f > 0]
        if len(live) < len(lanes):
            dead = [i for i, f in enumerate(state.host.frontier) if f <= 0]
            retired.append(([lanes[i] for i in dead],
                            _select_lanes(state, dead)))
            for i in dead:
                depths[lanes[i]] = depth
            lanes = [lanes[i] for i in live]
            if not lanes:
                break
            state = _select_lanes(state, live)
        for op in pipeline.ops:
            state = op.step(ctx, state)
        state = state._replace(depth=state.depth + 1)
    for lane in lanes:
        depths[lane] = limit
    if lanes:
        retired.append((lanes, state))
    depth = torch.tensor(depths, dtype=torch.int32,
                         device=state.depth.device)
    state = _merge_lanes(retired, depth) if retired else \
        state._replace(depth=depth)
    return pipeline.finisher.finish(ctx, pipeline, state)


def execute_batch(pipeline: Pipeline, ctx: Context, roots,
                  num_vertices: int) -> BFSResult:
    """Batched multi-root execution (the reference's vmapped entry): every
    field of the result has a leading ``len(roots)`` lane axis."""
    return fixed_point_batch(pipeline, ctx, roots, num_vertices)


# ---------------------------------------------------------------------------
# bit-parallel multi-query traversal (MS-BFS)
# ---------------------------------------------------------------------------

# The dense engines carry (V,) boolean planes; the multiquery engine widens
# the ELEMENT instead of adding a lane axis: one word per vertex packs up to
# 32 concurrent roots, and a single dense sweep advances every lane at once
# (Then et al., "The More the Merrier").  torch has few ops on uint32, and
# an int32 word would put lane 31 in the sign bit, so the word is int64
# with only bits 0-31 used.  No word leaves the driver: the result has the
# batch layout of run_query_batch.
_WORD_DTYPE = torch.int64
WORD_LANES = 32


class MultiQueryState(NamedTuple):
    """The word-sweep loop state.  No (lanes, V) plane lives in the loop:
    per-lane vertex depths are rebuilt AFTER the fixed point from the
    per-level new-bits snapshots (``level_words[d]`` holds the word of
    lanes that discovered each vertex at depth ``d``; bits are set at most
    once per (lane, vertex), so the first set level IS the BFS depth).
    The lane accounting lives on the host, read once a level."""

    frontier_word: torch.Tensor     # (V,) int64: lane bits in the frontier
    visited_word: torch.Tensor      # (V,) int64: lane bits ever discovered
    level_words: list               # per executed level and the seed, the
    #   (V,) int64 word of new bits
    lane_depth: list                # levels executed per lane (host ints)
    active: int                     # word of lanes still traversing (host)
    depth: int                      # levels executed, max over lanes (host)


def _lane_values(lanes: int, device) -> torch.Tensor:
    """(lanes,) int32: each lane's bit as an int32 value (lane 31 is the
    sign bit).  Disjoint bits sum with no overflow: the positive lanes
    sum below 2^31 and the sign bit adds -2^31 once."""
    return torch.tensor([(1 << lane) if lane < 31 else -(1 << 31)
                         for lane in range(lanes)], dtype=torch.int32,
                        device=device)


def _unpack(words: torch.Tensor, lanes: int) -> torch.Tensor:
    """Per-lane bit planes of ``words``: (..., lanes) int32 of 0/1.  The
    int32 view of a word keeps bits 0-31; ``& 1`` drops what an arithmetic
    shift of the sign bit brings in."""
    shifts = torch.arange(lanes, dtype=torch.int32, device=words.device)
    return (words.to(torch.int32)[..., None] >> shifts) & 1


def _pack(planes: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_unpack`: (..., lanes) 0/1 planes -> (...,)
    int64 words.  The bits are disjoint, so their sum is their OR."""
    vals = _lane_values(planes.shape[-1], planes.device)
    return (planes * vals).sum(-1) & ((1 << WORD_LANES) - 1)


def _segment_or(words: torch.Tensor, indptr: torch.Tensor, num_seg: int,
                lanes: int = WORD_LANES) -> torch.Tensor:
    """Per-segment bitwise OR of ``words`` (grouped by segment, boundaries
    in ``indptr``).  torch scatters have no OR mode, so the words are
    unpacked into per-lane bit planes, each plane takes its per-segment
    max (one ``scatter_reduce_``), and the planes are packed back.  OR is
    associative, commutative and idempotent, so this equals the
    reference's segmented scan bit for bit, in any order of the adds.
    Words past ``indptr[-1]`` belong to no segment and are dropped."""
    e = words.shape[0]
    if e == 0:
        return torch.zeros((num_seg,), dtype=words.dtype,
                           device=words.device)
    pos = torch.arange(e, dtype=indptr.dtype, device=words.device)
    seg = torch.searchsorted(indptr[1:].contiguous(), pos, right=True)
    planes = _unpack(words, lanes)
    out = torch.zeros((num_seg + 1, lanes), dtype=torch.int32,
                      device=words.device)
    out.scatter_reduce_(0, seg[:, None].expand(e, lanes), planes, "amax")
    return _pack(out[:num_seg])


def _word_gather(ctx: Context, frontier_word: torch.Tensor, nv: int,
                 lanes: int = WORD_LANES) -> torch.Tensor:
    """One packed-word level: for every vertex, the OR of its in-neighbors'
    frontier words (the MS-BFS analogue of :func:`_dense_pull`'s membership
    test, over every lane at once).  Needs dst-grouped edge orders:
    ``ctx.rcsr`` groups the join edges by ``join_dst`` in every direction
    view; the fused bidirectional view adds the backward orientation
    (grouped by ``join_src``) through ``ctx.csr``."""
    src = ctx.join_src.clamp(0, nv - 1)
    dst = ctx.join_dst.clamp(0, nv - 1)
    if ctx.bidir:
        fwd = _segment_or(frontier_word[src[ctx.rcsr.perm.long()]],
                          ctx.rcsr.indptr, nv, lanes)
        bwd = _segment_or(frontier_word[dst[ctx.csr.perm.long()]],
                          ctx.csr.indptr, nv, lanes)
        return fwd | bwd
    if ctx.rcsr is None:
        raise ValueError(
            "the multiquery word sweep needs dst-grouped edges (the "
            "reverse CSR); call Dataset.ensure_reverse() before dispatch")
    return _segment_or(frontier_word[src[ctx.rcsr.perm.long()]],
                       ctx.rcsr.indptr, nv, lanes)


def _or_reduce(words: torch.Tensor) -> int:
    """The OR of every word, on the host: halves folded onto each other on
    the device, then one read."""
    n = words.shape[0]
    if n == 0:
        return 0
    size = 1 << (n - 1).bit_length()
    if size != n:
        words = torch.cat([words, words.new_zeros(size - n)])
    while size > 1:
        size //= 2
        words = words[:size] | words[size:]
    return int(words[0])


@dataclasses.dataclass(frozen=True)
class MultiQuerySeed(Operator):
    """Scatter each root's lane bit into the packed frontier/visited words
    (lane bits are distinct, so a scatter-ADD of colliding roots IS the
    OR).  ``kind='dense'`` so the cost model prices levels with the dense
    engines' vertex-frontier accounting."""

    lanes: int = WORD_LANES
    kind: str = "dense"

    def describe(self):
        return f"MultiQuerySeed[{self.lanes} lane bits -> (V,) word]"


@dataclasses.dataclass(frozen=True)
class MultiQueryWordSweep(Operator):
    """One bit-parallel level: gather every in-neighbor's frontier word,
    segment-OR by destination, mask by ``~visited`` and the active-lane
    word.  Per-level work does not grow with the lanes the word holds,
    where the lane-axis batch pays its per-level planes once per lane."""

    lanes: int = WORD_LANES

    def describe(self):
        return (f"MultiQueryWordSweep[{self.lanes} lanes/word: "
                "segment-OR pull, per-lane freeze]")


@dataclasses.dataclass(frozen=True)
class MultiQueryEmit:
    """Per-lane deferred emission: rebuild each lane's (V,) vertex depths
    from the level snapshots, then derive/compact/materialize the emitted
    edge set exactly like :class:`DeferredEmit`: lane ``l`` of the result
    is row-for-row identical (rows, order, ``row_depths``) to the
    deferred-emission engines on ``roots[l]``."""

    cols: Tuple[str, ...]
    lanes: int = WORD_LANES

    def finish(self, ctx, pipeline, state):
        raise NotImplementedError(
            "multiquery pipelines run through execute_multiquery, not the "
            "scalar fixed_point driver")

    def describe(self):
        return (f"Materialize[{', '.join(self.cols)}]"
                f"(Compact(lane depths -> emitted)) x{self.lanes} lanes")


def _multiquery_finish(ctx: Context, pipeline: Pipeline,
                       state: MultiQueryState, lanes: int,
                       nv: int) -> BFSResult:
    """All-lanes deferred emission in ONE batched pass: each lane's (V,)
    vertex depths (the first level whose word holds the lane's bit, else
    -1) go through the tail of :class:`DeferredEmit`, which compacts each
    lane of the (L, EJ) emitted mask on its own and gathers every lane's
    values in one ``ColumnTable.take``.  This gives the reference's
    emitted set, ascending positions with the join-space sentinel in the
    padding, ``count``, ``row_depths`` and ``overflow`` (total > cap), as
    its docstring states; ``level_dirs`` and ``vertex_values`` are None."""
    dev = state.frontier_word.device
    vertex_depth = torch.full((lanes, nv), -1, dtype=torch.int32, device=dev)
    for d, word in enumerate(state.level_words):
        vertex_depth.masked_fill_(_unpack(word, lanes).T.bool(), d)
    lane_depth = torch.tensor(state.lane_depth, dtype=torch.int32,
                              device=dev)
    emitted, src_depth = _deferred_mask(ctx, vertex_depth, lane_depth)
    return _emit(ctx, pipeline.caps.result, pipeline.finisher.cols, emitted,
                 src_depth, lane_depth,
                 torch.zeros((lanes,), dtype=torch.bool, device=dev))


def multiquery_fixed_point(pipeline: Pipeline, ctx: Context, roots,
                           num_vertices: int, lane_limits) -> BFSResult:
    """The MS-BFS driver: one host loop advances up to 32 packed lanes per
    level, reading the host once a level (the OR of the level's new bits).

    Per-lane convergence freezing and depth caps live in the ``active``
    word: a lane leaves it when its frontier bits die or its depth cap
    binds, its bits stop propagating, and its executed-level counter
    freezes, so lane ``l`` of the result is row-identical to the scalar
    driver on ``roots[l]`` with ``max_depth=lane_limits[l]``.  Roots are
    clipped into [0, V - 1]; ``lane_limits`` are clamped to the query's
    ``max_depth``."""
    nv = num_vertices
    roots = [int(r) for r in torch.as_tensor(roots).reshape(-1).tolist()]
    lanes = len(roots)
    if lanes > WORD_LANES:
        raise ValueError(f"multiquery packs at most {WORD_LANES} roots per "
                         f"32-bit word, got {lanes}")
    limits = torch.as_tensor(lane_limits).reshape(-1).tolist()
    if len(limits) == 1:
        limits = limits * lanes
    if len(limits) != lanes:
        raise ValueError(f"{len(limits)} lane limits for {lanes} roots")
    dev = ctx.join_src.device
    bonus = 1 if pipeline.inclusive else 0
    limit = pipeline.max_depth + bonus
    lane_limit = [min(int(x), pipeline.max_depth) + bonus for x in limits]
    # distinct bits per lane: scatter-ADD of colliding roots == OR
    root_word = torch.zeros((nv,), dtype=_WORD_DTYPE, device=dev).index_add_(
        0, torch.tensor([min(max(r, 0), nv - 1) for r in roots],
                        dtype=torch.int64, device=dev),
        torch.tensor([1 << lane for lane in range(lanes)],
                     dtype=_WORD_DTYPE, device=dev))
    state = MultiQueryState(
        frontier_word=root_word, visited_word=root_word,
        level_words=[root_word], lane_depth=[0] * lanes,
        active=sum(1 << lane for lane in range(lanes)
                   if lane_limit[lane] > 0),
        depth=0)
    while state.active and state.depth < limit:
        active = state.active
        gathered = _word_gather(ctx, state.frontier_word, nv, lanes)
        new = gathered & ~state.visited_word & active
        # lanes in the active word executed this level
        lane_depth = [d + (active >> lane & 1)
                      for lane, d in enumerate(state.lane_depth)]
        # freeze: frontier died (no new bits anywhere) or depth cap bound
        alive = _or_reduce(new)
        within = sum(1 << lane for lane, d in enumerate(lane_depth)
                     if d < lane_limit[lane])
        state = MultiQueryState(
            frontier_word=new, visited_word=state.visited_word | new,
            level_words=state.level_words + [new], lane_depth=lane_depth,
            active=active & alive & within, depth=state.depth + 1)
    return _multiquery_finish(ctx, pipeline, state, lanes, nv)


def execute_multiquery(pipeline: Pipeline, ctx: Context, roots,
                       num_vertices: int, lane_limits=None) -> BFSResult:
    """Bit-parallel multi-root execution: ONE dense word sweep a level
    answers up to 32 roots.  Returns a BFSResult with a leading
    ``len(roots)`` lane axis, row-for-row equal per lane to the
    deferred-emission engines.  ``lane_limits`` (optional, one int per
    lane) caps each lane's executed depth; ``None`` means every lane runs
    to the query's ``max_depth``."""
    if lane_limits is None:
        lane_limits = [pipeline.max_depth] * len(
            torch.as_tensor(roots).reshape(-1))
    return multiquery_fixed_point(pipeline, ctx, roots, num_vertices,
                                  lane_limits)
