"""EXPLAIN: render a full planning pass — the logical query, the statistics
it was priced against, and EVERY candidate engine's operator tree annotated
with per-operator estimated rows and bytes (extending ``plan_repr``, which
renders composition only).

The per-operator numbers come from the same :meth:`Operator.estimate` calls
the optimizer ranked with, so EXPLAIN is an audit of the decision, not a
separate pretty-printer.

:func:`to_json` renders the same planning pass MACHINE-READABLY (one plain
dict, ``json.dumps``-able): the serving layer caches these per query shape
so repeated traffic skips parsing/stats/costing, and external tooling can
diff plans across versions.  ``schema_version`` gates consumers; the
schema is documented in docs/serving.md, and a document here equals the
JAX reference's for the same graph and query.

Schema version 2 extends v1 with everything a COLD PROCESS needs to
rehydrate a plan without re-planning (:mod:`repro_torch.planner.plan_store`):
the full graph statistics (per-root profiles, walk profile, histogram),
the factor-independent ``plain_bytes``/``kernel_bytes`` cost split per
candidate, and the :class:`~repro_torch.planner.cost.CostConstants` the pass was
priced with.

Schema version 3 adds the direction-optimizing switch decision: each
candidate's cost carries ``level_dirs`` (the predicted per-level
``push``/``pull`` choice of a :class:`~repro_torch.core.operators.
DirectionSwitch` pipeline; empty for push-only engines), and the cost
constants carry the refittable ``pull_alpha``/``pull_beta`` thresholds.

Schema version 4 adds the EXPLAIN ANALYZE section: every plan document
carries a top-level ``analyze`` key (``null`` until an execution fills
it) holding per-operator predicted vs. ACTUAL rows/bytes and per-level
predicted vs. TAKEN push/pull directions.  :func:`explain_analyze`
executes the chosen (or a forced) candidate and reconciles the cost
model against the executed :class:`~repro_torch.core.operators.BFSResult`:
the actual per-level edge counts are histogrammed from ``row_depths``
(so the actual rows ARE the result's rows, not a second estimate) and
substituted into the same :func:`~repro_torch.planner.cost.pipeline_cost`
walk the optimizer priced with — predicted and actual columns are the
one cost model evaluated at predicted vs. measured cardinalities.
Schema version 5 records the semiring value plane: the logical section
carries ``workload`` (the semiring name, ``reach`` for boolean BFS) and
``weight_col`` (the edge-weight column of a weighted traversal), and every
candidate records the ``semiring`` its pipeline runs under — so a plan
store keyed on query shape can never serve a boolean plan to a weighted
query or vice versa.  v1..v4 documents still load through
:func:`repro_torch.planner.plan_store.migrate_plan_doc` (they default to
``workload='reach'``).

Schema version 6 records the admission guard ladder: every plan document
carries a top-level ``admission`` key (``null`` until a guarded serving
session stamps it) holding the most recent request's per-root
:class:`~repro_torch.planner.guards.GuardResult` decisions and the
``guard_degrade_us``/``guard_reject_us`` budgets they were made under
(the ``cost_constants`` section also gained those two fields).  v1..v5
documents migrate with ``admission: null`` — pre-guard writers never
guarded anything.

On the card, :func:`explain_analyze` waits for the executed result
(``torch.cuda.synchronize``) before it reads the clock; the actual
statistics read the join columns to the host once each, and the row
width is priced from the row table's layout
(:meth:`~repro_torch.core.table.RowTable.layout_of`), so EXPLAIN never
builds the row table.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.engine import Dataset
from ..core.operators import BFSResult, EngineCaps
from ..core.table import RowTable

from .cost import column_bytes, pipeline_cost
from .optimize import PhysicalChoice, PlannerReport, RootBucket, plan
from .stats import _bfs_profile

__all__ = ["analyze_result", "explain", "explain_analyze", "explain_json",
           "render_analyze", "render_report", "to_json"]

PLAN_SCHEMA_VERSION = 6


def _fmt_bytes(b: float) -> str:
    if b < 1024:
        return f"{b:.0f}B"
    if b < 1024 ** 2:
        return f"{b / 1024:.1f}KB"
    return f"{b / 1024 ** 2:.1f}MB"


def _fmt_rows(r: float) -> str:
    return f"{r:.0f}"


def _candidate_block(rank: int, c: PhysicalChoice, chosen: bool) -> str:
    cost = c.cost
    head = (f"#{rank} {c.label:<24s} est {cost.est_us:8.0f}us  "
            f"{_fmt_bytes(cost.total_bytes):>9s}  "
            f"{cost.levels:3d} levels  ~{_fmt_rows(cost.result_rows)} rows")
    if chosen:
        head += "   <- CHOSEN"
    pipeline = c.pipeline
    ops = cost.per_op
    fin = ops[-1]
    lines = [head,
             f"   {fin.label:<66s} rows~{_fmt_rows(fin.rows):>7s} "
             f"bytes~{_fmt_bytes(fin.bytes):>9s}",
             f"     {pipeline.name}(maxrec={pipeline.max_depth})"]
    seed = ops[0]
    lines.append(f"       {seed.label + '            (non-recursive child)':<62s} "
                 f"rows~{_fmt_rows(seed.rows):>7s} bytes~{_fmt_bytes(seed.bytes):>9s}")
    for op in ops[1:-1]:
        lines.append(f"       {op.label:<62s} rows~{_fmt_rows(op.rows):>7s} "
                     f"bytes~{_fmt_bytes(op.bytes):>9s}")
    return "\n".join(lines)


def render_report(report: PlannerReport) -> str:
    lg = report.logical
    st = report.stats
    semantics = "UNION" if lg.dedup and not lg.union_all else (
        "UNION ALL == BFS (forest)" if lg.dedup else "UNION ALL (raw walk)")
    out_cols = list(lg.want_cols) + (["depth"] if lg.want_depth else [])
    lines = [
        "EXPLAIN recursive traversal",
        (f"logical: root={lg.root}  direction={lg.direction}  "
         f"max_depth={lg.max_depth}  payloads={lg.payload_cols}  "
         f"{semantics}"),
        f"output:  [{', '.join(out_cols)}]",
        (f"stats[{st.direction}]: V={st.num_vertices} EJ={st.num_edges} "
         f"density={st.density:.2f} avg_deg={st.avg_degree:.2f} "
         f"max_deg={st.max_degree} forest={'yes' if st.is_forest else 'no'}"),
        (f"  sampled frontier (edges/level over roots "
         f"{list(st.sample_roots)}): "
         + ", ".join(f"{s:.0f}" for s in st.level_edges[:12])
         + (", ..." if len(st.level_edges) > 12 else "")
         + f"  ({st.max_levels} levels, ~{st.reach_edges:.0f} rows "
           f"reached)"),
        "",
        "candidates (ranked by estimated cost):",
    ]
    for i, c in enumerate(report.ranked):
        lines.append("")
        lines.append(_candidate_block(i + 1, c, chosen=(i == 0)))
    if report.skipped:
        lines.append("")
        for engine, reason in report.skipped:
            lines.append(f"skipped {engine}: {reason}")
    return "\n".join(lines)


def _choice_json(c: PhysicalChoice, chosen: bool) -> dict:
    return {
        "label": c.label,
        "engine": c.engine,
        "use_kernel": c.use_kernel,
        # v5: the semiring the candidate's pipeline runs under
        "semiring": getattr(c.pipeline, "semiring", "reach"),
        "chosen": chosen,
        # the coalesced lane count a batch engine was priced for (1 for
        # the one-root-at-a-time engines)
        "lanes": getattr(c.query, "lanes", 1),
        "caps": {"frontier": c.query.caps.frontier,
                 "result": c.query.caps.result},
        "cost": {"est_us": c.cost.est_us,
                 "total_bytes": c.cost.total_bytes,
                 "levels": c.cost.levels,
                 "result_rows": c.cost.result_rows,
                 # v2: factor-independent split — a rehydrating process
                 # re-prices the plan from these under ITS constants
                 "plain_bytes": c.cost.plain_bytes,
                 "kernel_bytes": c.cost.kernel_bytes,
                 # v3: the predicted per-level push/pull switch decision
                 # (empty for push-only engines)
                 "level_dirs": list(c.cost.level_dirs)},
        "ops": [{"label": op.label, "rows": op.rows, "bytes": op.bytes}
                for op in c.cost.per_op],
    }


def to_json(report: PlannerReport,
            buckets: Optional[Sequence[RootBucket]] = None,
            analyze: Optional[dict] = None) -> dict:
    """The machine-readable plan: everything ``render_report`` prints, as
    one plain ``json.dumps``-able dict (the serving layer's plan-cache
    payload).  ``buckets`` optionally embeds a reach-bucketed batch layout
    alongside the ranked candidates; ``analyze`` optionally embeds an
    EXPLAIN ANALYZE section (v4; ``null`` until an execution fills it)."""
    lg = report.logical
    st = report.stats
    doc = {
        "schema_version": PLAN_SCHEMA_VERSION,
        "logical": {
            "root": lg.root,
            "max_depth": lg.max_depth,
            "payload_cols": lg.payload_cols,
            "dedup": lg.dedup,
            "direction": lg.direction,
            "want_cols": list(lg.want_cols),
            "want_depth": lg.want_depth,
            "union_all": lg.union_all,
            # v5: the semiring value plane axes
            "workload": getattr(lg, "workload", "reach"),
            "weight_col": getattr(lg, "weight_col", None),
        },
        "stats": {
            "direction": st.direction,
            "num_vertices": st.num_vertices,
            "num_edges": st.num_edges,
            "density": st.density,
            "avg_degree": st.avg_degree,
            "max_degree": st.max_degree,
            "is_forest": st.is_forest,
            "sample_roots": list(st.sample_roots),
            "level_edges": list(st.level_edges),
            "max_levels": st.max_levels,
            "reach_edges": st.reach_edges,
            # v2: the remaining GraphStats fields, so a plan store can
            # rehydrate the statistics without touching the graph
            "degree_histogram": list(st.degree_histogram),
            "level_vertices": list(st.level_vertices),
            "max_level_edges": st.max_level_edges,
            "root_profiles": [[r, list(p)] for r, p in st.root_profiles],
            "level_walk_edges": list(st.level_walk_edges),
        },
        "cost_constants": report.constants.to_json(),
        "chosen": report.best.label,
        "candidates": [_choice_json(c, chosen=(i == 0))
                       for i, c in enumerate(report.ranked)],
        "skipped": [{"engine": e, "reason": r} for e, r in report.skipped],
        # v4: the EXPLAIN ANALYZE section — null until an execution
        # reconciles predicted vs. actual (see explain_analyze)
        "analyze": analyze,
        # v6: admission guard decisions — null until a guarded serving
        # session stamps the most recent request's ladder outcome here
        "admission": None,
    }
    if buckets is not None:
        doc["buckets"] = [{
            "lanes": list(b.indices),
            "roots": list(b.roots),
            "caps": {"frontier": b.caps.frontier, "result": b.caps.result},
            "predicted_reach": b.predicted_reach,
            "predicted_depth": b.predicted_depth,
        } for b in buckets]
    return doc


def explain_json(query, ds: Dataset, *, root: Optional[int] = None,
                 caps: Optional[EngineCaps] = None,
                 include_kernel: bool = False,
                 default_max_depth: Optional[int] = None) -> dict:
    """Plan ``query`` against ``ds`` and return the machine-readable plan."""
    report = plan(query, ds, root=root, caps=caps,
                  include_kernel=include_kernel,
                  default_max_depth=default_max_depth)
    return to_json(report)


def explain(query, ds: Dataset, *, root: Optional[int] = None,
            caps: Optional[EngineCaps] = None,
            include_kernel: bool = False,
            default_max_depth: Optional[int] = None) -> str:
    """Plan ``query`` against ``ds`` and render the full report."""
    report = plan(query, ds, root=root, caps=caps,
                  include_kernel=include_kernel,
                  default_max_depth=default_max_depth)
    return render_report(report)


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE (schema v4): predicted vs. actual, from an executed result
# ---------------------------------------------------------------------------

_DIR_CODES = {0: "push", 1: "pull"}


def _taken_dirs(result: BFSResult) -> list:
    """Per-level TAKEN push/pull directions decoded from the executed
    ``level_dirs`` (empty for push-only engines)."""
    dirs = getattr(result, "level_dirs", None)
    if dirs is None:
        return []
    return [_DIR_CODES[c] for c in dirs.reshape(-1).tolist()
            if c in _DIR_CODES]


def _actual_level_edges(result: BFSResult) -> list[int]:
    """Actual edges emitted per BFS level, histogrammed STRAIGHT from the
    result's ``row_depths`` — by construction the per-level actuals sum to
    ``result.count``, so "actual rows" in the ANALYZE report means exactly
    the rows this execution returned."""
    if result.row_depths is None:
        raise ValueError("result carries no row_depths; cannot ANALYZE")
    rd = result.row_depths[: int(result.count)].cpu().numpy()
    rd = rd[rd >= 0]
    if rd.size == 0:
        return []
    return [int(x) for x in np.bincount(rd.astype(np.int64))]


def _actual_stats(choice: PhysicalChoice, report: PlannerReport,
                  ds: Dataset, result: BFSResult, root: int):
    """The MEASURED counterpart of the planner's sampled ``GraphStats``:
    per-level edge rows come from the executed result (``row_depths``
    histogram); per-level new-vertex counts come from one host-side BFS
    from the actual root (the in-loop cardinality a result cannot carry).
    Substituting these into the same ``pipeline_cost`` walk re-prices every
    operator at the cardinalities the execution really saw."""
    edges = _actual_level_edges(result)
    ctx = ds.context(choice.query.direction)
    # one copy to the host per join column, wherever the dataset lives
    src = ctx.join_src.cpu().numpy().astype(np.int64)
    dst = ctx.join_dst.cpu().numpy().astype(np.int64)
    if ctx.bidir:
        src, dst = (np.concatenate([src, dst]), np.concatenate([dst, src]))
    _, verts = _bfs_profile(src, dst, int(root), int(ds.num_vertices),
                            max(len(edges), 1))
    verts = verts[: len(edges)] + [0] * max(len(edges) - len(verts), 0)
    return dataclasses.replace(
        report.stats,
        sample_roots=(int(root),),
        level_edges=tuple(float(x) for x in edges),
        level_vertices=tuple(float(x) for x in verts),
        max_level_edges=int(max(edges, default=0)),
        reach_edges=float(sum(edges)),
        max_levels=len(edges),
        root_profiles=((int(root), tuple(int(x) for x in edges)),),
        level_walk_edges=tuple(float(x) for x in edges))


def analyze_result(choice: PhysicalChoice, report: PlannerReport,
                   ds: Dataset, result: BFSResult, *, root: int,
                   elapsed_us: Optional[float] = None) -> dict:
    """Reconcile one executed :class:`BFSResult` against the plan that
    produced it: the ``analyze`` section of a schema-v4 plan document.

    Predicted numbers are the candidate's :class:`~repro_torch.planner.cost.
    PlanCost` (what the optimizer ranked); actual numbers re-run the SAME
    cost walk over statistics measured from this execution, so per-operator
    "actual rows" are derived from the result's own ``row_depths``/
    ``count`` — when the sampled profile was exact (e.g. the root was a
    sample root of a single-profile graph), predicted == actual to the
    row."""
    actual_stats = _actual_stats(choice, report, ds, result, root)
    col_bytes = column_bytes(ds.table)
    # the row table's width from its layout, as plan() prices it: the
    # same number, and nothing is built
    row_bytes = len(RowTable.layout_of(ds.table)) * 4
    actual = pipeline_cost(choice.pipeline, actual_stats,
                           row_bytes=row_bytes, col_bytes=col_bytes,
                           constants=report.constants)
    pred = choice.cost
    edges_act = list(actual_stats.level_edges)
    taken = _taken_dirs(result)
    n_levels = max(pred.levels, actual.levels, len(taken))
    levels = []
    for lvl in range(n_levels):
        levels.append({
            "level": lvl,
            "dir_predicted": (pred.level_dirs[lvl]
                              if lvl < len(pred.level_dirs) else None),
            "dir_taken": taken[lvl] if lvl < len(taken) else None,
            "edges_predicted": report.stats.edges_at(lvl),
            "edges_actual": (int(edges_act[lvl])
                             if lvl < len(edges_act) else 0),
        })
    return {
        "engine": choice.label,
        "root": int(root),
        "elapsed_us": (None if elapsed_us is None else float(elapsed_us)),
        "result_count": int(result.count),
        "overflow": bool(result.overflow.any()),
        "predicted": {"rows": pred.result_rows, "bytes": pred.total_bytes,
                      "levels": pred.levels, "est_us": pred.est_us,
                      "level_dirs": list(pred.level_dirs)},
        "actual": {"rows": actual.result_rows, "bytes": actual.total_bytes,
                   "levels": actual.levels,
                   "est_us": actual.est_us,     # the model at actual cards
                   "level_dirs": taken},
        "ops": [{"label": p.label,
                 "rows_predicted": p.rows, "bytes_predicted": p.bytes,
                 "rows_actual": a.rows, "bytes_actual": a.bytes}
                for p, a in zip(pred.per_op, actual.per_op)],
        "levels": levels,
    }


def _find_candidate(report: PlannerReport, engine: str) -> PhysicalChoice:
    for c in report.ranked:
        if c.label == engine or c.engine == engine:
            return c
    for eng, reason in report.skipped:
        if eng == engine:
            raise ValueError(f"engine {engine!r} was skipped for this "
                             f"query: {reason}")
    known = sorted({c.label for c in report.ranked})
    raise ValueError(f"unknown engine {engine!r}; ranked: {known}")


def explain_analyze(query, ds: Dataset, *, root: Optional[int] = None,
                    engine: Optional[str] = None,
                    caps: Optional[EngineCaps] = None,
                    include_kernel: bool = False,
                    default_max_depth: Optional[int] = None,
                    check_overflow: bool = True) -> dict:
    """EXPLAIN ANALYZE: plan ``query``, EXECUTE the chosen candidate (or
    the forced ``engine``) on the query's root, and return the schema-v4
    plan document with its ``analyze`` section filled — per-operator
    predicted vs. actual rows/bytes, predicted vs. actual levels, and the
    per-level predicted vs. taken push/pull directions of a
    direction-optimizing pipeline.  ``render_analyze`` formats it."""
    report = plan(query, ds, root=root, caps=caps,
                  include_kernel=include_kernel,
                  default_max_depth=default_max_depth)
    choice = report.best if engine is None else _find_candidate(report,
                                                                engine)
    run_root = root if root is not None else report.logical.root
    if run_root is None:
        raise ValueError("explain_analyze executes the plan: the query "
                         "needs a literal root (or pass root=...)")
    t0 = time.perf_counter()
    result = choice.run(ds, int(run_root), check_overflow=check_overflow)
    if result.count.is_cuda:     # the timing needs completion
        torch.cuda.synchronize(result.count.device)
    elapsed_us = (time.perf_counter() - t0) * 1e6
    analysis = analyze_result(choice, report, ds, result,
                              root=int(run_root), elapsed_us=elapsed_us)
    return to_json(report, analyze=analysis)


def render_analyze(doc: dict) -> str:
    """Human-readable EXPLAIN ANALYZE from a schema-v4 plan document with
    a filled ``analyze`` section."""
    a = doc.get("analyze")
    if a is None:
        raise ValueError("plan document has no analyze section "
                         "(run explain_analyze first)")
    p, ac = a["predicted"], a["actual"]
    lines = [
        f"EXPLAIN ANALYZE  engine={a['engine']}  root={a['root']}",
        (f"total: predicted {_fmt_rows(p['rows'])} rows / "
         f"{_fmt_bytes(p['bytes'])} / {p['levels']} levels "
         f"(est {p['est_us']:.0f}us)  ->  actual "
         f"{_fmt_rows(ac['rows'])} rows / {_fmt_bytes(ac['bytes'])} / "
         f"{ac['levels']} levels"
         + (f" (measured {a['elapsed_us']:.0f}us)"
            if a.get("elapsed_us") is not None else "")),
    ]
    for op in a["ops"]:
        lines.append(
            f"  {op['label']:<58s} rows {_fmt_rows(op['rows_predicted']):>7s}"
            f" -> {_fmt_rows(op['rows_actual']):>7s}   bytes "
            f"{_fmt_bytes(op['bytes_predicted']):>9s} -> "
            f"{_fmt_bytes(op['bytes_actual']):>9s}")
    if any(lv["dir_predicted"] or lv["dir_taken"] for lv in a["levels"]):
        lines.append("  per-level direction (predicted -> taken):")
        for lv in a["levels"]:
            lines.append(
                f"    level {lv['level']:<3d} "
                f"{lv['dir_predicted'] or '-':<5s} -> "
                f"{lv['dir_taken'] or '-':<5s}  edges "
                f"{_fmt_rows(lv['edges_predicted']):>7s} -> "
                f"{lv['edges_actual']}")
    return "\n".join(lines)
