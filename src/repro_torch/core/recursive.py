"""The paper's positional recursive engine as an operator-pipeline
composition: ReadCol → VisitedDedup → CSRIndexJoin → AppendUnionAll,
finished by ONE LateMaterialize (PRecursive, the paper's Fig. 4 plan),
and its weighted form under a value semiring.  The tuple and row-store
engines come with the slice that ports the paper's other engines.

Semantics note: the SQL in the paper is ``UNION ALL`` over a *tree*, where
BFS and UNION ALL coincide.  On general graphs the pipeline implements BFS
semantics (per-vertex dedup) when ``dedup=True``; with ``dedup=False`` the
VisitedDedup operator is dropped and it reproduces raw UNION ALL walks up to
``max_depth``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from .operators import (AppendUnionAll, CSRIndexJoin, EngineCaps,
                        LateMaterialize, Pipeline, ReadTargets, Seed,
                        VisitedDedup, WeightedExpand, check_direction)

__all__ = ["precursive_plan", "weighted_precursive_plan"]


def precursive_plan(caps: EngineCaps, max_depth: int,
                    out_cols: Tuple[str, ...], dedup: bool = True,
                    direction: str = "outbound",
                    expand_fn: Optional[Callable] = None) -> Pipeline:
    """The paper's positional engine: positions flow through the recursion;
    one column read per level; ONE materialize after the fixed point.
    ``expand_fn`` plugs a kernel into the CSRIndexJoin."""
    check_direction(direction)
    return Pipeline(
        name="PRecursive", seed=Seed(),
        ops=(ReadTargets(),
             *((VisitedDedup(),) if dedup else ()),
             CSRIndexJoin(expand_fn=expand_fn),
             AppendUnionAll()),
        finisher=LateMaterialize(tuple(out_cols)),
        caps=caps, max_depth=max_depth)


def weighted_precursive_plan(caps: EngineCaps, max_depth: int,
                             out_cols: Tuple[str, ...], semiring: str,
                             direction: str = "outbound",
                             expand_fn: Optional[Callable] = None
                             ) -> Pipeline:
    """The positional engine under a value semiring: the same
    position-carrying recursion and single late materialize, with the
    level body fused into ONE :class:`WeightedExpand` (⊗-propagate,
    per-vertex ⊕-combine, winner select, CSR expansion).  BFS's
    VisitedDedup is subsumed: improving semirings re-expand exactly the
    strictly improved vertices, walk semirings every receiving vertex.
    ``expand_fn`` plugs a kernel into the expansion."""
    check_direction(direction)
    return Pipeline(
        name="PRecursiveWeighted", seed=Seed(semiring=semiring),
        ops=(WeightedExpand(semiring=semiring, expand_fn=expand_fn),
             AppendUnionAll()),
        finisher=LateMaterialize(tuple(out_cols)),
        caps=caps, max_depth=max_depth, semiring=semiring)
