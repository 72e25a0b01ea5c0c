"""Cost-based engine selection: enumerate every physical realization of a
:class:`~repro_torch.planner.ast.LogicalQuery`, price each against the
dataset's statistics, and return a ranked list of :class:`PhysicalChoice`.

The candidate space is the axis the paper measures, plus the beyond-paper
engines:

* positional vs tuple vs row recursion (``precursive`` / ``trecursive`` /
  ``rowstore[_index]``) — early vs late materialization;
* the Exp-3 rewrite on and off (``*_rewrite`` engines: slim carry + one
  top-level join);
* sparse CSR expansion vs the dense ``DenseBitmapStep`` vs ``HybridStep``
  (``bitmap`` / ``hybrid``) and the direction-optimizing engines;
* the ``frontier_expand`` kernel plugged into ``CSRIndexJoin`` as an
  alternative physical expansion (``precursive+kernel``, opt-in), priced
  with the kernel factor measured on the dataset's device.

Every candidate compiles through the same ``build_plan`` the forced-engine
path uses, so the planner's pick is bit-identical to ``run_query`` with the
chosen engine name.  The planner prices the KERNEL-FREE pipeline
(``build_plan(q)``, as the reference does), so a plan's cost is the same
number on the CPU and on the card; on a CUDA dataset ``run_query`` plugs
the kernels in when it executes the pick.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.engine import (ENGINE_NAMES, WEIGHTED_ENGINE_NAMES, WORD_LANES,
                           Dataset, RecursiveQuery, build_plan,
                           dispatch_buckets, result_lane, run_query,
                           run_query_batch, run_query_buckets,
                           run_query_multi)
from ..core.operators import (BFSResult, DirectionSwitch, EngineCaps,
                              Pipeline, execute, execute_batch)
from ..core.recursive import precursive_plan
from ..core.table import RowTable
from .ast import LogicalQuery, RecursiveCTE, normalize, parse
from .calibrate import kernel_expand_fn, resolve_constants
from .cost import (CostConstants, DEFAULT_CONSTANTS, PlanCost, column_bytes,
                   pipeline_cost)
from .stats import GraphStats, root_estimates

__all__ = ["PhysicalChoice", "PlannerReport", "RootBucket", "plan",
           "choose", "plan_and_run", "bucket_roots", "default_caps",
           "kernel_expand_fn", "KERNEL_LABEL"]

KERNEL_LABEL = "precursive+kernel"


@dataclasses.dataclass(frozen=True)
class PhysicalChoice:
    """One ranked physical plan: an engine name (plus the optional kernel
    expansion), the concrete RecursiveQuery it compiles from, the Pipeline
    it was costed with, and its cost estimate."""

    engine: str
    query: RecursiveQuery
    logical: LogicalQuery
    pipeline: Pipeline
    cost: PlanCost
    use_kernel: bool = False

    @property
    def label(self) -> str:
        return KERNEL_LABEL if self.use_kernel else self.engine

    def dress(self, r: BFSResult, *, check_overflow: bool,
              caps: EngineCaps) -> BFSResult:
        """Post-execution dressing shared by every execution path: overflow
        check, projection to the requested columns, the ``depth`` column."""
        if check_overflow and bool(r.overflow.any()):
            raise RuntimeError(
                f"capacity overflow executing {self.label} with "
                f"caps={caps}: the result is truncated — pass "
                "larger caps to plan()/plan_and_run(), or "
                "check_overflow=False to accept the partial result")
        values = {k: v for k, v in r.values.items()
                  if k in self.logical.want_cols}
        missing = set(self.logical.want_cols) - set(values)
        if missing:
            raise KeyError(f"engine {self.label!r} did not materialize "
                           f"requested column(s) {sorted(missing)} "
                           f"(produced {sorted(r.values)})")
        if self.logical.want_depth:
            values["depth"] = r.row_depths
        if self.logical.workload != "reach" and r.vertex_values is not None:
            values["value"] = self._row_values(r)
        return r._replace(values=values)

    def _row_values(self, r: BFSResult) -> Optional[torch.Tensor]:
        """The per-row ``value`` output column: each emitted row reports its
        TARGET vertex's converged accumulator, gathered from the value
        plane after the fixed point on the result's device.  The fused
        bidirectional view has no single target column, so ``both``
        exposes the value plane only through ``vertex_values``."""
        tgt_col = {"outbound": "to", "inbound": "from"}.get(
            self.logical.direction)
        if tgt_col is None or tgt_col not in r.values:
            return None
        nv = r.vertex_values.shape[-1]
        tgt = r.values[tgt_col].long().clamp(0, nv - 1)
        if r.vertex_values.dim() == 2:          # batched lanes
            return torch.gather(r.vertex_values, 1, tgt)
        return r.vertex_values[tgt]

    def _resolve_roots(self, roots) -> torch.Tensor:
        """Default to the query's literal root and coerce to int32 — the
        SAME coercion on every path (kernel or not, scalar or batch), so a
        Python list / int64 vector cannot diverge between paths."""
        roots = self.logical.root if roots is None else roots
        if roots is None:
            raise ValueError("no root: the query has no literal seed and "
                             "none was passed to run()")
        if isinstance(roots, torch.Tensor):
            return roots.to("cpu", torch.int32)
        return torch.as_tensor(np.asarray(roots, dtype=np.int32))

    def run(self, ds: Dataset, roots: Union[int, Sequence[int], None] = None,
            *, check_overflow: bool = True) -> BFSResult:
        """Execute the chosen plan (single root or a batch of roots) and
        dress the result per the logical query: attach the ``depth`` output
        column and project the requested value columns.

        A capacity overflow (stats-derived block sizes can undershoot for
        unsampled roots or raw UNION ALL walks) raises rather than silently
        truncating; pass bigger ``caps`` to plan(), or
        ``check_overflow=False`` to accept the flagged partial result."""
        roots = self._resolve_roots(roots)
        batched = roots.dim() > 0
        if self.use_kernel:
            ctx = ds.context(self.query.direction)
            r = (execute_batch(self.pipeline, ctx, roots.tolist(),
                               ds.num_vertices)
                 if batched
                 else execute(self.pipeline, ctx, int(roots),
                              ds.num_vertices))
        elif self.engine == "multiquery":
            # the bit-parallel engine always dispatches a lane vector; a
            # scalar root rides in lane 0 of a one-lane word
            r = run_query_multi(self.query, ds, roots.reshape(-1))
            if not batched:
                r = result_lane(r, 0)
        else:
            r = (run_query_batch(self.query, ds, roots) if batched
                 else run_query(self.query, ds, int(roots)))
        return self.dress(r, check_overflow=check_overflow,
                          caps=self.query.caps)

    def _kernel_pipeline(self, caps: EngineCaps) -> Pipeline:
        """The kernel-expansion pipeline at the given caps (the planned
        pipeline when the caps match, a rebuild otherwise)."""
        if caps == self.query.caps:
            return self.pipeline
        return precursive_plan(caps, self.query.max_depth,
                               self.query.out_cols, self.query.dedup,
                               self.query.direction,
                               expand_fn=kernel_expand_fn())

    def run_bucketed(self, ds: Dataset, roots: Sequence[int], *,
                     max_buckets: int = 4, check_overflow: bool = True,
                     buckets: Optional[Tuple["RootBucket", ...]] = None,
                     fallback_caps: Optional[EngineCaps] = None
                     ) -> list[BFSResult]:
        """The reach-bucketed serving path: partition ``roots`` by predicted
        reach (:func:`bucket_roots`), run one batched dispatch per bucket
        with that bucket's caps, and return PER-ROOT dressed results in the
        original order (each bit-identical to ``run()`` on that root).  A
        precomputed bucket layout can be passed in.

        A bucket that overflows its caps is retried once with
        ``fallback_caps`` (default: this plan's own caps)."""
        roots = self._resolve_roots(roots)
        if roots.dim() == 0:
            raise ValueError("run_bucketed needs a VECTOR of roots; "
                             "use run() for a single root")
        if buckets is None:
            buckets = bucket_roots(
                ds, roots.numpy(), direction=self.query.direction,
                max_depth=self.query.max_depth, dedup=self.query.dedup,
                caps=self.query.caps, max_buckets=max_buckets)
        if fallback_caps is None:
            fallback_caps = self.query.caps
        if self.use_kernel:
            # launch/retry/scatter live in the ONE shared bucket executor;
            # only the dispatch callback (kernel-expansion pipeline at the
            # bucket's caps) is this plan's own
            ctx = ds.context(self.query.direction)

            def _dispatch(i, b, caps):
                return execute_batch(self._kernel_pipeline(caps), ctx,
                                     list(b.roots), ds.num_vertices)

            results = dispatch_buckets(buckets, _dispatch,
                                       fallback_caps=fallback_caps)
        elif self.engine == "multiquery":
            # one bit-parallel word sweep per bucket: the bucket's lanes
            # pack into one frontier word, dispatched at the bucket's caps
            def _dispatch(i, b, caps):
                qb = dataclasses.replace(self.query, caps=caps,
                                         lanes=len(b.roots))
                return run_query_multi(qb, ds, list(b.roots))

            results = dispatch_buckets(buckets, _dispatch,
                                       fallback_caps=fallback_caps)
        else:
            q = dataclasses.replace(self.query, caps=fallback_caps)
            results = run_query_buckets(q, ds, buckets)
        return [self.dress(r, check_overflow=check_overflow,
                           caps=self.query.caps) for r in results]


@dataclasses.dataclass(frozen=True)
class PlannerReport:
    """Everything one planning pass produced."""

    logical: LogicalQuery
    stats: GraphStats
    ranked: Tuple[PhysicalChoice, ...]          # best first
    skipped: Tuple[Tuple[str, str], ...]        # (engine, reason)
    constants: CostConstants = DEFAULT_CONSTANTS   # priced with THESE

    @property
    def best(self) -> PhysicalChoice:
        return self.ranked[0]


# a raw UNION ALL walk's path count can explode combinatorially; cap the
# result buffer a planner will allocate (overflow still raises if the walk
# truly exceeds this)
_MAX_WALK_RESULT = 1 << 22


def default_caps(stats: GraphStats, logical: LogicalQuery) -> EngineCaps:
    """Volcano block sizing from statistics.

    Dedup (BFS) semantics bound the result exactly: every join-space edge is
    emitted at most once, so ``EJ + 8`` covers any root.  Raw UNION ALL
    walks count PATHS, not edges — on a cyclic or reconverging graph a
    depth-bounded walk can legally emit far more than E rows — so both
    blocks are sized from the sampled WALK profile
    (:meth:`GraphStats.total_walk_rows`), with margin, and are deliberately
    NOT clamped to a multiple of E."""
    ej = stats.num_edges
    if logical.dedup:
        frontier = int(min(ej + 8, max(1024, 4 * stats.max_level_edges)))
        result = ej + 8
    else:
        md = logical.max_depth
        frontier = int(max(1024, 4 * stats.max_level_edges,
                           2 * stats.max_walk_level_rows(md)))
        frontier = min(frontier, _MAX_WALK_RESULT)
        result = int(min(max(4 * stats.total_walk_rows(md), 4096),
                         _MAX_WALK_RESULT))
    return EngineCaps(frontier=frontier, result=result)


@dataclasses.dataclass(frozen=True)
class RootBucket:
    """One reach bucket of a batched root vector: the lanes it owns in the
    original vector, the roots themselves, and the (quantized, clamped)
    per-bucket caps one batched dispatch will run with.

    ``roots`` is PADDED to a power-of-two lane count by repeating the last
    root (a stable dispatch signature as batch compositions vary); only the
    first ``len(indices)`` lanes are real, and executors drop the
    padding."""

    indices: Tuple[int, ...]        # lanes in the original roots vector
    roots: Tuple[int, ...]          # len(roots) >= len(indices) (padding)
    caps: EngineCaps
    predicted_reach: float          # max predicted reach over the bucket
    predicted_depth: int            # max predicted depth over the bucket

    @property
    def signature(self) -> Tuple[int, int, int]:
        """(padded lane count, frontier cap, result cap): what a serving
        layer keys dispatch reuse on."""
        return (len(self.roots), self.caps.frontier, self.caps.result)


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), 0)


# margin over the predicted reach when sizing bucket buffers: estimates for
# unsampled roots are degree-conditioned, not measured, and undershooting
# costs a whole retry dispatch
_BUCKET_MARGIN = 4
# a root joins the current bucket while its reach is within this factor of
# the bucket's smallest; beyond it a new bucket opens (geometric split)
_BUCKET_SPREAD = 8.0


def bucket_roots(ds: Dataset, roots, *, direction: str, max_depth: int,
                 dedup: bool = True, caps: EngineCaps,
                 max_buckets: int = 4) -> Tuple[RootBucket, ...]:
    """Partition a root vector into <= ``max_buckets`` reach buckets.

    Roots are sorted by root-conditional predicted reach
    (:func:`repro_torch.planner.stats.root_estimates` — exact for sampled
    roots, degree-conditioned otherwise) and split geometrically: a new
    bucket opens when a root's reach exceeds ``_BUCKET_SPREAD`` times the
    smallest reach in the current bucket.  Each bucket gets its own
    ``EngineCaps`` sized to its worst member with margin, quantized to
    powers of two and NEVER exceeding the global ``caps`` — a leaf-rooted
    lane stops paying a hub root's padding.

    Raw UNION ALL (``dedup=False``) reach is path-count-shaped and not
    root-conditioned by the sampled profiles, so those queries keep one
    bucket with the global caps."""
    roots = np.asarray(roots, dtype=np.int64).reshape(-1)
    lanes = list(range(roots.shape[0]))
    if roots.shape[0] == 0:
        return ()
    if not dedup or roots.shape[0] == 1 or max_buckets <= 1:
        return (RootBucket(indices=tuple(lanes),
                           roots=tuple(int(r) for r in roots), caps=caps,
                           predicted_reach=-1.0,      # unpredicted fallback
                           predicted_depth=max_depth),)

    ests = root_estimates(ds, direction, roots, max_depth)
    order = sorted(lanes, key=lambda i: (ests[i].reach_rows, i))

    groups: list[list[int]] = []
    for i in order:
        if groups:
            lo = ests[groups[-1][0]].reach_rows
            if (ests[i].reach_rows <= max(lo, 1.0) * _BUCKET_SPREAD
                    or len(groups) >= max_buckets):
                groups[-1].append(i)
                continue
        groups.append([i])

    out = []
    for g in groups:
        reach = max(ests[i].reach_rows for i in g)
        level = max(ests[i].max_level_rows for i in g)
        depth = max(ests[i].depth for i in g)
        exact = all(ests[i].exact for i in g)
        margin = 2 if exact else _BUCKET_MARGIN
        frontier = min(_pow2_ceil(int(margin * level) + 8), caps.frontier)
        result = min(_pow2_ceil(int(margin * reach) + 8), caps.result)
        # pad the lane count to a power of two (repeat the last root)
        g_roots = [int(roots[i]) for i in g]
        g_roots += [g_roots[-1]] * (_pow2_ceil(len(g_roots)) - len(g_roots))
        out.append(RootBucket(
            indices=tuple(g), roots=tuple(g_roots),
            caps=EngineCaps(frontier=frontier, result=result),
            predicted_reach=float(reach), predicted_depth=int(depth)))
    return tuple(out)


def _illegal_reason(engine: str, logical: LogicalQuery) -> Optional[str]:
    if logical.workload != "reach":
        if engine not in WEIGHTED_ENGINE_NAMES:
            return ("no value plane: weighted workloads run on the "
                    f"semiring engines {WEIGHTED_ENGINE_NAMES}")
        if engine == "bitmap" and logical.direction == "both":
            return ("the dense weighted step is single-direction; the "
                    "fused bidirectional view expands positionally")
        # the boolean-dedup legality axes below do not apply: weighted
        # pipelines have no VisitedDedup (the ⊕-combine subsumes it)
        return None
    if logical.direction != "outbound" and engine.startswith("rowstore"):
        return ("outbound-only: the row-store emulation models the "
                "PostgreSQL baseline")
    if not logical.dedup and engine in ("bitmap", "hybrid", "diropt",
                                        "diropt_hybrid"):
        return ("needs BFS dedup: raw UNION ALL on a non-forest graph "
                "differs from the dense visited-bitmap semantics")
    return None


def _stamp_switch_thresholds(pipeline: Pipeline,
                             constants: CostConstants) -> Pipeline:
    """Stamp the cost constants' refittable switch thresholds
    (``pull_alpha``/``pull_beta``) onto every DirectionSwitch of a diropt
    pipeline — the planner prices AND executes the thresholds it owns.
    (Thresholds steer performance only; the row set is branch-invariant,
    so ``run_query`` with the default thresholds stays row-identical.)"""
    changed = False
    ops = []
    for op in pipeline.ops:
        if isinstance(op, DirectionSwitch) and (
                op.alpha != constants.pull_alpha
                or op.beta != constants.pull_beta):
            op = dataclasses.replace(op, alpha=constants.pull_alpha,
                                     beta=constants.pull_beta)
            changed = True
        ops.append(op)
    if not changed:
        return pipeline
    return dataclasses.replace(pipeline, ops=tuple(ops))


def _multiquery_reason(logical: LogicalQuery, lanes: int) -> Optional[str]:
    """Why the bit-parallel multiquery engine is not a candidate (None when
    it is).  It is a BATCH engine: without a coalesced lane count there is
    nothing to amortize the word sweep over."""
    if lanes <= 1:
        return ("bit-parallel MS-BFS amortizes one word sweep over a "
                "coalesced batch; single-root planning has no lanes "
                "(pass lanes=N)")
    if lanes > WORD_LANES:
        return (f"packs at most {WORD_LANES} lanes per frontier word; "
                "split the batch across dispatches")
    if logical.workload != "reach":
        return ("no value plane: the packed word carries one reach bit "
                "per lane")
    if not logical.dedup:
        return ("needs BFS dedup: raw UNION ALL on a non-forest graph "
                "differs from the dense visited-bitmap semantics")
    return None


def _rank_key(c: PhysicalChoice):
    """Ranking is per ROOT: a batch engine's whole-dispatch estimate is
    amortized over its coalesced lanes before comparing against the
    one-root-at-a-time engines."""
    lanes = max(c.query.lanes, 1)
    return (c.cost.est_us / lanes, c.label)


def plan(query: Union[str, RecursiveCTE, LogicalQuery], ds: Dataset, *,
         root: Optional[int] = None, caps: Optional[EngineCaps] = None,
         include_kernel: bool = False,
         default_max_depth: Optional[int] = None,
         constants: Optional[CostConstants] = None,
         lanes: int = 1) -> PlannerReport:
    """One full planning pass: parse/normalize as needed, price every legal
    candidate, rank.

    ``constants`` are the cost-model time constants to price with — the
    hand-calibrated prior by default, a :class:`~repro_torch.planner.
    calibrate.Calibrator`'s refit values when a feedback loop supplies
    them.  An unresolved ``kernel_factor`` is measured on first use, on
    the dataset's device.

    ``include_kernel`` adds the ``precursive+kernel`` candidate, kept for
    the reference's API: on a CUDA dataset plain ``precursive`` already
    runs the same expansion kernel, only priced without the factor.

    ``lanes`` is the coalesced batch size this plan will serve.  With
    ``lanes > 1`` the bit-parallel ``multiquery`` engine joins the
    candidate set, priced per coalesced batch; ranking compares PER-ROOT
    amortized cost."""
    if isinstance(query, str):
        query = parse(query)
    if isinstance(query, RecursiveCTE):
        logical = normalize(query, ds, root=root,
                            default_max_depth=default_max_depth)
    else:
        logical = query
        if root is not None:
            logical = dataclasses.replace(logical, root=root)
    stats = ds.stats(logical.direction)
    if caps is None:
        caps = default_caps(stats, logical)

    workload = logical.workload
    weight_col = logical.weight_col
    candidates, skipped = [], []
    if include_kernel and logical.direction == "both":
        skipped.append((KERNEL_LABEL,
                        "the Pallas expand kernel walks one direction CSR; "
                        "the fused bidirectional view expands through "
                        "expand_frontier_both"))
        include_kernel = False
    if include_kernel and workload != "reach":
        skipped.append((KERNEL_LABEL,
                        "the expand kernel is boolean-only; the weighted "
                        "dense combine has its own spmm_segment routing"))
        include_kernel = False
    consts = resolve_constants(constants, need_kernel=include_kernel,
                               device=ds.device)

    col_bytes = column_bytes(ds.table)
    row_bytes = len(RowTable.layout_of(ds.table)) * 4
    for engine in ENGINE_NAMES:
        reason = _illegal_reason(engine, logical)
        if reason is not None:
            skipped.append((engine, reason))
            continue
        q = RecursiveQuery(engine=engine, max_depth=logical.max_depth,
                           payload_cols=logical.payload_cols, caps=caps,
                           dedup=logical.dedup,
                           direction=logical.direction,
                           workload=workload, weight_col=weight_col)
        pipeline = _stamp_switch_thresholds(build_plan(q), consts)
        cost = pipeline_cost(pipeline, stats, row_bytes=row_bytes,
                             col_bytes=col_bytes, constants=consts)
        candidates.append(PhysicalChoice(engine=engine, query=q,
                                         logical=logical, pipeline=pipeline,
                                         cost=cost))
    mq_reason = _multiquery_reason(logical, lanes)
    if mq_reason is not None:
        # a skip entry only means a REQUESTED coalesced batch was
        # inadmissible; single-root planning never asked for it
        if lanes > 1:
            skipped.append(("multiquery", mq_reason))
    else:
        q = RecursiveQuery(engine="multiquery", max_depth=logical.max_depth,
                           payload_cols=logical.payload_cols, caps=caps,
                           dedup=logical.dedup, direction=logical.direction,
                           workload=workload, weight_col=weight_col,
                           lanes=int(lanes))
        pipeline = build_plan(q)
        cost = pipeline_cost(pipeline, stats, row_bytes=row_bytes,
                             col_bytes=col_bytes, constants=consts)
        candidates.append(PhysicalChoice(engine="multiquery", query=q,
                                         logical=logical, pipeline=pipeline,
                                         cost=cost))
    if include_kernel and _illegal_reason("precursive", logical) is None:
        q = RecursiveQuery(engine="precursive", max_depth=logical.max_depth,
                           payload_cols=logical.payload_cols, caps=caps,
                           dedup=logical.dedup, direction=logical.direction)
        pipeline = precursive_plan(caps, logical.max_depth, q.out_cols,
                                   logical.dedup, logical.direction,
                                   expand_fn=kernel_expand_fn())
        cost = pipeline_cost(pipeline, stats, row_bytes=row_bytes,
                             col_bytes=col_bytes, constants=consts)
        candidates.append(PhysicalChoice(engine="precursive", query=q,
                                         logical=logical, pipeline=pipeline,
                                         cost=cost, use_kernel=True))
    if not candidates:
        raise ValueError("no legal physical plan for this query "
                         f"(skipped: {skipped!r})")
    candidates.sort(key=_rank_key)
    return PlannerReport(logical=logical, stats=stats,
                         ranked=tuple(candidates), skipped=tuple(skipped),
                         constants=consts)


def choose(query, ds: Dataset, **kwargs) -> PhysicalChoice:
    """The planner's pick: best-ranked physical plan for the query."""
    return plan(query, ds, **kwargs).best


def plan_and_run(query, ds: Dataset,
                 roots: Union[int, Sequence[int], None] = None, *,
                 caps: Optional[EngineCaps] = None,
                 include_kernel: bool = False,
                 default_max_depth: Optional[int] = None,
                 constants: Optional[CostConstants] = None) -> BFSResult:
    """Parse -> normalize -> cost -> pick -> execute, no engine name needed.

    ``roots`` may be one root (scalar) or a sequence (served as ONE batched
    dispatch).  Omit it to use the literal root in the query text."""
    root = None
    if roots is not None and np.ndim(roots) == 0:
        root = int(roots)
    best = choose(query, ds, root=root, caps=caps,
                  include_kernel=include_kernel,
                  default_max_depth=default_max_depth, constants=constants)
    return best.run(ds, roots)
