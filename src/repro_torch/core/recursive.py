"""The paper's recursive (BFS) engines as operator-pipeline compositions,
run by the single :func:`~repro_torch.core.operators.fixed_point` driver.
The engines differ ONLY in what flows through the recursion — exactly the
axis the paper studies:

=================  ==========================================================
``precursive``     ReadCol → VisitedDedup → CSRIndexJoin → AppendUnionAll,
                   finished by ONE LateMaterialize (PRecursive, the paper's
                   Fig. 4 plan); also under a value semiring.
``trecursive``     the same loop with an EarlyMaterialize before every
                   append: the recursion carries value tuples and pays (3+N)
                   column gathers per level (TRecursive, Fig. 3).
``rowstore``       PostgreSQL emulation: ScanHashJoin (full interleaved-row
                   SeqScan probing the frontier hash) + full-row gathers.
``rowstore_index`` the CSRIndexJoin avoids the scan but row gathers still
                   read full heap rows.
``*_rewrite``      Exp-3: the slim (id, to) pipeline finished by ONE
                   TopLevelJoin on ``id``.
=================  ==========================================================

Direction: the columnar pipelines traverse ``outbound`` (from→to),
``inbound`` (to→from via the reverse CSR) or ``both`` (the fused
bidirectional view; each edge can be emitted once per direction).  The
row-store emulation is outbound-only, like the PostgreSQL baseline it
models.  ``expand_fn`` plugs a kernel into every CSRIndexJoin (the
reference's tuple and row plans have no such slot; the expansion is
integer, so the result is the same).

Semantics note: the SQL in the paper is ``UNION ALL`` over a *tree*, where
BFS and UNION ALL coincide.  On general graphs the pipelines implement BFS
semantics (per-vertex dedup) when ``dedup=True``; with ``dedup=False`` the
VisitedDedup operator is dropped and they reproduce raw UNION ALL walks up
to ``max_depth``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .csr import CSRIndex
from .operators import (AppendUnionAll, BFSResult, Context, CSRIndexJoin,
                        EarlyMaterialize, EmitTuples, EngineCaps,
                        LateMaterialize, Pipeline, ProjectRows, ReadTargets,
                        ScanHashJoin, Seed, TopLevelJoin, VisitedDedup,
                        WeightedExpand, check_direction, execute)
from .table import ColumnTable, RowTable

__all__ = ["precursive_plan", "weighted_precursive_plan", "trecursive_plan",
           "rowstore_plan", "trecursive_rewrite_plan",
           "rowstore_rewrite_plan", "precursive_bfs", "trecursive_bfs",
           "rowstore_bfs",
           "trecursive_rewrite_bfs", "rowstore_rewrite_bfs"]

# per-direction (seed filter column label, tuple-rep next-vertex column)
_DIRECTION_COLS = {
    "outbound": ("from", "to"),
    "inbound": ("to", "from"),
    "both": ("from|to", "__next__"),
}


def precursive_plan(caps: EngineCaps, max_depth: int,
                    out_cols: Tuple[str, ...], dedup: bool = True,
                    direction: str = "outbound",
                    expand_fn: Optional[Callable] = None) -> Pipeline:
    """The paper's positional engine: positions flow through the recursion;
    one column read per level; ONE materialize after the fixed point.
    ``expand_fn`` plugs a kernel into the CSRIndexJoin."""
    check_direction(direction)
    seed_label, _ = _DIRECTION_COLS[direction]
    return Pipeline(
        name="PRecursive", seed=Seed(label=seed_label),
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
    seed_label, _ = _DIRECTION_COLS[direction]
    return Pipeline(
        name="PRecursiveWeighted",
        seed=Seed(label=seed_label, semiring=semiring),
        ops=(WeightedExpand(semiring=semiring, expand_fn=expand_fn),
             AppendUnionAll()),
        finisher=LateMaterialize(tuple(out_cols)),
        caps=caps, max_depth=max_depth, semiring=semiring)


def trecursive_plan(caps: EngineCaps, max_depth: int,
                    out_cols: Tuple[str, ...], dedup: bool = True,
                    direction: str = "outbound",
                    expand_fn: Optional[Callable] = None) -> Pipeline:
    """The tuple engine: an EarlyMaterialize inside the loop turns every
    level's join output into full value tuples (Fig. 3's plan shape)."""
    check_direction(direction)
    seed_label, next_col = _DIRECTION_COLS[direction]
    out_cols = tuple(out_cols)
    with_next = next_col == "__next__"
    carry = (out_cols if with_next
             else tuple(dict.fromkeys(out_cols + (next_col,))))
    return Pipeline(
        name="TRecursive", rep="vals",
        seed=Seed(label=seed_label),
        ops=(ReadTargets("vals", col=next_col),
             *((VisitedDedup(),) if dedup else ()),
             CSRIndexJoin(expand_fn=expand_fn),
             EarlyMaterialize(cols=carry, with_next=with_next),
             AppendUnionAll("vals", cols=out_cols)),
        finisher=EmitTuples(out_cols),
        caps=caps, max_depth=max_depth)


def rowstore_plan(caps: EngineCaps, max_depth: int,
                  out_cols: Tuple[str, ...], dedup: bool = True,
                  use_index: bool = False, direction: str = "outbound",
                  expand_fn: Optional[Callable] = None) -> Pipeline:
    """PostgreSQL emulation: the recursion carries full interleaved rows.
    Without an index the per-level join is a full SeqScan probing the
    frontier hash; with one, a CSRIndexJoin (``expand_fn`` plugs a kernel
    into it) — but row gathers still read the full heap width either
    way."""
    if direction != "outbound":
        raise ValueError("the row-store emulation is outbound-only "
                         "(like the PostgreSQL baseline it models)")
    return Pipeline(
        name="Recursive", rep="rows",
        seed=Seed(scan="rows", label="from"),
        ops=(ReadTargets("rows", col="to"),
             *((VisitedDedup(),) if dedup else ()),
             CSRIndexJoin(expand_fn=expand_fn) if use_index
             else ScanHashJoin(),
             EarlyMaterialize(rows=True),
             AppendUnionAll("rows")),
        finisher=ProjectRows(tuple(out_cols)),
        caps=caps, max_depth=max_depth)


def trecursive_rewrite_plan(caps: EngineCaps, max_depth: int,
                            out_cols: Tuple[str, ...], dedup: bool = True,
                            direction: str = "outbound",
                            expand_fn: Optional[Callable] = None
                            ) -> Pipeline:
    """Exp-3 rewriting of the tuple engine: the CTE carries only (id, to);
    payloads come back through ONE top-level hash join on ``id``."""
    slim = trecursive_plan(caps, max_depth, ("id",), dedup, direction,
                           expand_fn)
    return dataclasses.replace(
        slim, name="TRecursiveRewrite",
        finisher=TopLevelJoin(tuple(out_cols), inner=slim.finisher))


def rowstore_rewrite_plan(caps: EngineCaps, max_depth: int,
                          out_cols: Tuple[str, ...], dedup: bool = True,
                          use_index: bool = False,
                          direction: str = "outbound",
                          expand_fn: Optional[Callable] = None) -> Pipeline:
    """Exp-3 rewriting on the row store: the slim CTE still gathers full
    rows per level AND the top-level join gathers them again — the rewrite
    cannot rescue a heap table."""
    slim = rowstore_plan(caps, max_depth, ("id",), dedup, use_index,
                         direction, expand_fn)
    return dataclasses.replace(
        slim, name="RecursiveRewrite",
        finisher=TopLevelJoin(tuple(out_cols), inner=slim.finisher,
                              use_rows=True))


# ---------------------------------------------------------------------------
# legacy function API — thin wrappers over the pipelines
# ---------------------------------------------------------------------------

def _columnar_ctx(table: ColumnTable, csr: CSRIndex) -> Context:
    return Context(table=table, csr=csr, join_src=table.column("from"),
                   join_dst=table.column("to"))


def _row_ctx(rt: RowTable, csr: CSRIndex) -> Context:
    return Context(table=None, rows=rt, csr=csr,
                   join_src=rt.column("from").to(torch.int32),
                   join_dst=rt.column("to").to(torch.int32))


def precursive_bfs(table: ColumnTable, csr: CSRIndex, root,
                   *, caps: EngineCaps, max_depth: int,
                   out_cols: tuple[str, ...], dedup: bool = True,
                   expand_fn: Callable | None = None) -> BFSResult:
    """Positional BFS with late materialization (Fig. 4)."""
    plan = precursive_plan(caps, max_depth, out_cols, dedup,
                           expand_fn=expand_fn)
    return execute(plan, _columnar_ctx(table, csr), root, csr.num_vertices)


def trecursive_bfs(table: ColumnTable, csr: CSRIndex, root,
                   *, caps: EngineCaps, max_depth: int,
                   out_cols: tuple[str, ...], dedup: bool = True
                   ) -> BFSResult:
    """Tuple-based BFS: the recursion carries materialized tuples (Fig. 3)."""
    plan = trecursive_plan(caps, max_depth, out_cols, dedup)
    return execute(plan, _columnar_ctx(table, csr), root, csr.num_vertices)


def rowstore_bfs(rt: RowTable, csr: CSRIndex, root,
                 *, caps: EngineCaps, max_depth: int,
                 out_cols: tuple[str, ...], dedup: bool = True,
                 use_index: bool = False) -> BFSResult:
    """Row-store BFS (PostgreSQL / PostgreSQL+index emulation)."""
    plan = rowstore_plan(caps, max_depth, out_cols, dedup, use_index)
    return execute(plan, _row_ctx(rt, csr), root, csr.num_vertices)


def trecursive_rewrite_bfs(table: ColumnTable, csr: CSRIndex, root,
                           *, caps: EngineCaps, max_depth: int,
                           out_cols: tuple[str, ...], dedup: bool = True
                           ) -> BFSResult:
    """Exp-3 rewrite of the tuple engine (slim CTE + one top-level join)."""
    plan = trecursive_rewrite_plan(caps, max_depth, out_cols, dedup)
    return execute(plan, _columnar_ctx(table, csr), root, csr.num_vertices)


def rowstore_rewrite_bfs(rt: RowTable, csr: CSRIndex, root,
                         *, caps: EngineCaps, max_depth: int,
                         out_cols: tuple[str, ...], dedup: bool = True,
                         use_index: bool = False) -> BFSResult:
    """Exp-3 rewrite on the row store (still reads full heap rows twice)."""
    plan = rowstore_rewrite_plan(caps, max_depth, out_cols, dedup, use_index)
    return execute(plan, _row_ctx(rt, csr), root, csr.num_vertices)
