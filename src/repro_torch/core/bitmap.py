"""Beyond-paper engines: dense-frontier (bitmap) and direction-optimizing
BFS, as operator-pipeline compositions run by the same
:func:`~repro_torch.core.operators.fixed_point` driver as PRecursive:

* ``bitmap``  — Seed(dense) → DenseBitmapStep, finished by CompactEmitted
  (the emitted-edge mask is compacted to positions and late-materialized,
  so the dense plan keeps the paper's positional contract);
* ``hybrid``  — Seed(pos) → HybridStep: positional CSRIndexJoin while the
  frontier is small, dense push once it covers > ``switch_frac`` of the
  vertices;
* ``diropt``  — DirectionSwitch(DenseBitmapStep | PullStep) with deferred
  emission, row-for-row equal to ``bitmap``;
* ``diropt_hybrid`` — DirectionSwitch(HybridStep | HybridPullStep),
  row-for-row equal to ``hybrid``.

* ``bitmap`` under a value semiring — Seed(dense) → WeightedDenseStep,
  finished by CompactEmitted with the (V,) value plane.

``expand_fn`` plugs the ``frontier_expand`` kernel wrapper into the sparse
IndexJoin, ``pull_fn`` the ``frontier_pull`` kernel wrapper into the pull
steps and ``spmm_fn`` the ``spmm_segment`` kernel wrapper into the dense
(sum, ×) combine; none changes a result beyond float summation order.

* ``multiquery`` — MultiQuerySeed → MultiQueryWordSweep, finished by
  MultiQueryEmit: up to 32 roots as the bits of one word per vertex (MS-BFS),
  run by :func:`~repro_torch.core.operators.execute_multiquery`.
"""
from __future__ import annotations

from typing import Callable, Optional

from .csr import CSRIndex
from .operators import (WORD_LANES, BFSResult, CompactEmitted, Context,
                        DeferredEmit, DenseBitmapStep, DirectionSwitch,
                        EngineCaps, HybridPullStep, HybridStep,
                        MultiQueryEmit, MultiQuerySeed, MultiQueryWordSweep,
                        Pipeline, PullStep, Seed, WeightedDenseStep,
                        bitmap_level, check_direction, execute)
from .table import ColumnTable

__all__ = ["bitmap_bfs", "hybrid_bfs", "bitmap_level", "bitmap_plan",
           "hybrid_plan", "diropt_plan", "diropt_hybrid_plan",
           "weighted_bitmap_plan", "multiquery_plan"]


def bitmap_plan(caps: EngineCaps, max_depth: int,
                out_cols: tuple[str, ...],
                direction: str = "outbound") -> Pipeline:
    """Dense-frontier BFS (always-push): O(E) work per level, state is two
    bitmaps + one edge mask; ``inclusive`` matches the dense loop's
    emit-inside-the-body level accounting."""
    check_direction(direction)
    return Pipeline(
        name="BitmapBFS", rep="dense",
        seed=Seed(kind="dense"),
        ops=(DenseBitmapStep(),),
        finisher=CompactEmitted(tuple(out_cols)),
        caps=caps, max_depth=max_depth, inclusive=True, tracks_emitted=True)


def weighted_bitmap_plan(caps: EngineCaps, max_depth: int,
                         out_cols: tuple[str, ...], semiring: str,
                         direction: str = "outbound",
                         spmm_fn: Optional[Callable] = None) -> Pipeline:
    """Dense-frontier traversal under a value semiring: per level one ⊗
    over the full edge list and one ⊕-scatter into the (V,) value plane
    (:class:`WeightedDenseStep`; ``spmm_fn`` routes the (sum, ×) combine
    through the ``spmm_segment`` kernel).  Single-direction views only: the
    fused bidirectional join space has no dense weighted step."""
    check_direction(direction)
    if direction == "both":
        raise ValueError("the dense weighted step is single-direction; "
                         "use the positional weighted engine for 'both'")
    return Pipeline(
        name="BitmapWeighted", rep="dense",
        seed=Seed(kind="dense", semiring=semiring),
        ops=(WeightedDenseStep(semiring=semiring, spmm_fn=spmm_fn),),
        finisher=CompactEmitted(tuple(out_cols)),
        caps=caps, max_depth=max_depth, inclusive=True, tracks_emitted=True,
        semiring=semiring)


def hybrid_plan(caps: EngineCaps, max_depth: int,
                out_cols: tuple[str, ...], switch_frac: float = 0.05,
                direction: str = "outbound",
                expand_fn: Optional[Callable] = None) -> Pipeline:
    """Direction-optimizing BFS: the per-level operator flips between the
    paper's positional expansion and the dense push."""
    check_direction(direction)
    return Pipeline(
        name="HybridBFS", rep="pos",
        seed=Seed(mark_emitted=True),
        ops=(HybridStep(switch_frac=switch_frac, expand_fn=expand_fn),),
        finisher=CompactEmitted(tuple(out_cols)),
        caps=caps, max_depth=max_depth, tracks_emitted=True)


def diropt_plan(caps: EngineCaps, max_depth: int,
                out_cols: tuple[str, ...], direction: str = "outbound",
                alpha: float = 1.0, beta: float = 64.0,
                pull_fn: Optional[Callable] = None) -> Pipeline:
    """Direction-optimizing dense BFS: per level a :class:`DirectionSwitch`
    picks the push bitmap step or the Beamer bottom-up :class:`PullStep`;
    emission is DEFERRED (the loop carries only per-vertex depths and
    :class:`DeferredEmit` derives the emitted mask in one pass).
    Row-for-row equal to ``bitmap``.  ``alpha``/``beta`` are the switch
    thresholds."""
    check_direction(direction)
    return Pipeline(
        name="DirOptBFS", rep="dense",
        seed=Seed(kind="dense"),
        ops=(DirectionSwitch(push=DenseBitmapStep(deferred=True),
                             pull=PullStep(deferred=True, expand_fn=pull_fn),
                             alpha=alpha, beta=beta),),
        finisher=DeferredEmit(tuple(out_cols)),
        caps=caps, max_depth=max_depth, inclusive=True,
        tracks_vertex_depth=True, tracks_switch=True)


def diropt_hybrid_plan(caps: EngineCaps, max_depth: int,
                       out_cols: tuple[str, ...], switch_frac: float = 0.05,
                       direction: str = "outbound", alpha: float = 1.0,
                       beta: float = 64.0,
                       expand_fn: Optional[Callable] = None,
                       pull_fn: Optional[Callable] = None) -> Pipeline:
    """Direction-optimizing hybrid BFS: :class:`HybridStep` on the push
    side, its bottom-up twin :class:`HybridPullStep` on the pull side.
    Level-for-level state-identical to ``hybrid``."""
    check_direction(direction)
    return Pipeline(
        name="DirOptHybridBFS", rep="pos",
        seed=Seed(mark_emitted=True),
        ops=(DirectionSwitch(
            push=HybridStep(switch_frac=switch_frac, expand_fn=expand_fn),
            pull=HybridPullStep(expand_fn=pull_fn),
            alpha=alpha, beta=beta),),
        finisher=CompactEmitted(tuple(out_cols)),
        caps=caps, max_depth=max_depth, tracks_emitted=True,
        tracks_switch=True)


def multiquery_plan(caps: EngineCaps, max_depth: int,
                    out_cols: tuple[str, ...], direction: str = "outbound",
                    lanes: int = WORD_LANES) -> Pipeline:
    """Bit-parallel multi-query BFS (MS-BFS): the dense frontier/visited
    planes widen from boolean to a word whose bits are up to 32 concurrent
    roots; ONE segment-OR sweep per level advances every lane at once,
    with per-lane convergence freezing and per-lane depth caps.  Emission
    is deferred per lane and row-for-row equal to the deferred-emission
    engines; runs through
    :func:`~repro_torch.core.operators.execute_multiquery`, not the scalar
    driver."""
    check_direction(direction)
    lanes = int(lanes)
    if not 1 <= lanes <= WORD_LANES:
        raise ValueError(f"multiquery lanes must be in 1..{WORD_LANES}, "
                         f"got {lanes}")
    return Pipeline(
        name="MultiQueryBFS", rep="dense",
        seed=MultiQuerySeed(lanes=lanes),
        ops=(MultiQueryWordSweep(lanes=lanes),),
        finisher=MultiQueryEmit(tuple(out_cols), lanes=lanes),
        caps=caps, max_depth=max_depth, inclusive=True,
        tracks_vertex_depth=True)


def bitmap_bfs(table: ColumnTable, num_vertices: int, root,
               *, caps: EngineCaps, max_depth: int,
               out_cols: tuple[str, ...]) -> BFSResult:
    """Dense-frontier BFS over the raw edge columns (no index needed)."""
    ctx = Context(table=table, csr=None, join_src=table.column("from"),
                  join_dst=table.column("to"))
    return execute(bitmap_plan(caps, max_depth, out_cols), ctx, root,
                   num_vertices)


def hybrid_bfs(table: ColumnTable, csr: CSRIndex, root,
               *, caps: EngineCaps, max_depth: int,
               out_cols: tuple[str, ...], switch_frac: float = 0.05
               ) -> BFSResult:
    """Direction-optimizing BFS (positional below the switch threshold,
    dense push above it)."""
    ctx = Context(table=table, csr=csr, join_src=table.column("from"),
                  join_dst=table.column("to"))
    return execute(hybrid_plan(caps, max_depth, out_cols, switch_frac),
                   ctx, root, csr.num_vertices)
