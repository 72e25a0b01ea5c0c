"""Query layer: the paper's recursive query dispatched onto its pipeline.

A ``RecursiveQuery`` describes the SQL of §5.1: which payload columns
exist, which engine executes it and the traversal ``direction``.  A
``Dataset`` holds the column table and the CSR join index on one device,
and the row-store emulation's row table once a row-store engine asks for
it.  :func:`plan_repr` renders an engine's Volcano tree from its actual
operator composition (the paper's Fig. 3 and 4 plans).
A query's ``workload`` is ``reach`` (boolean BFS) or a value semiring of
:mod:`repro_torch.core.semiring`, which runs on ``precursive`` and
``bitmap`` with the edge weights of ``weight_col``.  :func:`run_query`
answers one root through the single fixed-point driver, and
:func:`run_query_batch` many roots of any query at once (a leading
lane axis on every result field, :func:`result_lane` slices one out); on
a CUDA dataset both plug the hand-written kernels in: ``frontier_expand``
into every IndexJoin, ``frontier_pull`` into every pull step and
``spmm_segment`` into the dense (sum, ×) combine, as the reference's
planner does for its kernel candidates; ``late_gather`` runs in every
gather of the tables.  :func:`run_query_multi` answers up to 32 roots of a
reach query in one bit-parallel MS-BFS (the ``multiquery`` engine, which
stays out of ``ENGINE_NAMES`` as in the reference), and
:func:`dispatch_buckets` is the bucket executor: buckets of roots, each
dispatched at its own caps, an overflowing bucket retried or its
overflowing lanes evicted to solo re-dispatches at fallback caps
(:func:`run_query_buckets` runs it over ``run_query_batch``).

With a tracer installed (:func:`repro_torch.obs.trace.set_tracer`) the
entry points record a ``dispatch`` span and per-level events, as the
reference's do; with none, nothing extra runs.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises where CUDA is unavailable.
"""
from __future__ import annotations

import dataclasses
import time
import types
import warnings
from typing import Callable, Dict, Literal, Optional, Sequence

import numpy as np
import torch

from ..kernels.frontier_expand.ops import frontier_expand_fused
from ..kernels.frontier_pull.layout import PullLayout, build_pull_layout
from ..kernels.frontier_pull.ops import frontier_pull_fused
from ..kernels.spmm_segment.ops import spmm_segment_sorted
from ..obs import faultinject as _fault
from ..obs import trace as _trace
from .bitmap import (bitmap_plan, diropt_hybrid_plan, diropt_plan,
                     hybrid_plan, multiquery_plan, weighted_bitmap_plan)
from .csr import CSRIndex, build_csr, merged_indptr
from .operators import (DIRECTIONS, WORD_LANES, BFSResult, Context,
                        EngineCaps, Pipeline, execute, execute_batch,
                        execute_multiquery)
from .recursive import (precursive_plan, rowstore_plan,
                        rowstore_rewrite_plan, trecursive_plan,
                        trecursive_rewrite_plan, weighted_precursive_plan)
from .semiring import WORKLOADS
from .table import ColumnTable, RowTable, payload_names

__all__ = ["RecursiveQuery", "Dataset", "EngineCaps", "BFSResult",
           "ENGINE_NAMES", "DIROPT_ENGINE_NAMES", "PUSH_COUNTERPART",
           "WEIGHTED_ENGINE_NAMES", "VALUE_ENGINE_NAMES",
           "ROWSTORE_ENGINE_NAMES", "MULTIQUERY_ENGINE", "WORD_LANES",
           "build_plan", "positions_available", "plan_repr",
           "query_context", "run_query", "run_query_batch",
           "run_query_multi", "result_lane", "resolve_device",
           "BucketTiming", "RetryPolicy", "DispatchReport", "SKIPPED",
           "overflow_retry_count", "lane_eviction_count",
           "dispatch_buckets", "run_query_buckets", "plan_and_run",
           "explain", "explain_analyze"]

Direction = Literal["outbound", "inbound", "both"]

# the reference's ENGINE_NAMES, in its order (MS-BFS stays out, as there)
ENGINE_NAMES: tuple[str, ...] = (
    "precursive", "trecursive", "rowstore", "rowstore_index", "bitmap",
    "hybrid", "trecursive_rewrite", "rowstore_rewrite",
    "rowstore_index_rewrite", "diropt", "diropt_hybrid")

# the bit-parallel MS-BFS engine is a BATCH engine: one dispatch answers up
# to 32 roots (run_query_multi).  It stays OUT of ENGINE_NAMES, as in the
# reference: the single-root enumerations iterate that tuple.
MULTIQUERY_ENGINE = "multiquery"

# the paper's tuple-based and row-store engines, whose recursion carries
# values rather than positions, and among them the row-store emulations,
# which read the dataset's row table
VALUE_ENGINE_NAMES: tuple[str, ...] = (
    "trecursive", "rowstore", "rowstore_index", "trecursive_rewrite",
    "rowstore_rewrite", "rowstore_index_rewrite")
ROWSTORE_ENGINE_NAMES: tuple[str, ...] = tuple(
    e for e in VALUE_ENGINE_NAMES if e.startswith("rowstore"))

# the direction-optimizing engines (per-level push/pull switch) and their
# push-only counterparts, which they equal row for row
DIROPT_ENGINE_NAMES: tuple[str, ...] = ("diropt", "diropt_hybrid")
PUSH_COUNTERPART = {"diropt": "bitmap", "diropt_hybrid": "hybrid"}

# the engines that carry the semiring value plane (as in the reference)
WEIGHTED_ENGINE_NAMES: tuple[str, ...] = ("precursive", "bitmap")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raises where CUDA is unavailable rather than
    falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class RecursiveQuery:
    """One recursive CTE query instance (a paper experiment cell)."""

    engine: str
    max_depth: int
    payload_cols: int                 # the paper's N
    caps: EngineCaps
    dedup: bool = True                # BFS semantics (UNION ALL if False)
    direction: Direction = "outbound"
    workload: str = "reach"           # semiring name ('reach' = boolean BFS)
    weight_col: Optional[str] = None  # edge-weight column (weighted only)
    lanes: int = 1                    # coalesced roots per dispatch (> 1
    #   only for the bit-parallel `multiquery` engine, which packs up to
    #   WORD_LANES roots into one word-sweep dispatch)

    @property
    def out_cols(self) -> tuple[str, ...]:
        return ("id", "from", "to", "name",
                *payload_names(self.payload_cols))


# plan builders: engine name -> (query, expand_fn, pull_fn) -> Pipeline
_PLAN_BUILDERS = {
    "precursive": lambda q, expand_fn, pull_fn: precursive_plan(
        q.caps, q.max_depth, q.out_cols, q.dedup, q.direction,
        expand_fn=expand_fn),
    "trecursive": lambda q, expand_fn, pull_fn: trecursive_plan(
        q.caps, q.max_depth, q.out_cols, q.dedup, q.direction,
        expand_fn=expand_fn),
    "rowstore": lambda q, expand_fn, pull_fn: rowstore_plan(
        q.caps, q.max_depth, q.out_cols, q.dedup, use_index=False,
        direction=q.direction),
    "rowstore_index": lambda q, expand_fn, pull_fn: rowstore_plan(
        q.caps, q.max_depth, q.out_cols, q.dedup, use_index=True,
        direction=q.direction, expand_fn=expand_fn),
    "trecursive_rewrite": lambda q, expand_fn, pull_fn:
        trecursive_rewrite_plan(q.caps, q.max_depth, q.out_cols, q.dedup,
                                q.direction, expand_fn=expand_fn),
    "rowstore_rewrite": lambda q, expand_fn, pull_fn: rowstore_rewrite_plan(
        q.caps, q.max_depth, q.out_cols, q.dedup, use_index=False,
        direction=q.direction),
    "rowstore_index_rewrite": lambda q, expand_fn, pull_fn:
        rowstore_rewrite_plan(q.caps, q.max_depth, q.out_cols, q.dedup,
                              use_index=True, direction=q.direction,
                              expand_fn=expand_fn),
    "bitmap": lambda q, expand_fn, pull_fn: bitmap_plan(
        q.caps, q.max_depth, q.out_cols, q.direction),
    "hybrid": lambda q, expand_fn, pull_fn: hybrid_plan(
        q.caps, q.max_depth, q.out_cols, direction=q.direction,
        expand_fn=expand_fn),
    "diropt": lambda q, expand_fn, pull_fn: diropt_plan(
        q.caps, q.max_depth, q.out_cols, q.direction, pull_fn=pull_fn),
    "diropt_hybrid": lambda q, expand_fn, pull_fn: diropt_hybrid_plan(
        q.caps, q.max_depth, q.out_cols, direction=q.direction,
        expand_fn=expand_fn, pull_fn=pull_fn),
    # the word sweep is plain PyTorch (plain jnp in the reference): no
    # kernel plugs into it
    "multiquery": lambda q, expand_fn, pull_fn: multiquery_plan(
        q.caps, q.max_depth, q.out_cols, q.direction,
        lanes=max(q.lanes, 1)),
}


def build_plan(q: RecursiveQuery, expand_fn=None, pull_fn=None,
               spmm_fn=None) -> Pipeline:
    """The engine's pipeline; ``expand_fn`` plugs a kernel into its
    IndexJoins, ``pull_fn`` into its pull steps and ``spmm_fn`` into the
    dense weighted (sum, ×) combine.  The row-store engines raise
    ValueError for any direction but ``outbound``."""
    if q.workload != "reach":
        if q.workload not in WORKLOADS:
            raise ValueError(f"unknown workload {q.workload!r}; "
                             f"known: {WORKLOADS}")
        if q.engine == "precursive":
            return weighted_precursive_plan(
                q.caps, q.max_depth, q.out_cols, q.workload, q.direction,
                expand_fn=expand_fn)
        if q.engine == "bitmap":
            return weighted_bitmap_plan(q.caps, q.max_depth, q.out_cols,
                                        q.workload, q.direction,
                                        spmm_fn=spmm_fn)
        raise ValueError(
            f"engine {q.engine!r} has no value plane; weighted workloads "
            f"run on {WEIGHTED_ENGINE_NAMES}")
    if q.engine not in _PLAN_BUILDERS:
        raise ValueError(f"unknown engine {q.engine!r}; known: "
                         f"{ENGINE_NAMES}")
    return _PLAN_BUILDERS[q.engine](q, expand_fn, pull_fn)


def positions_available(engine: str) -> bool:
    """The positions contract, derived from the engine's actual pipeline:
    True iff ``BFSResult.positions`` holds real edge positions."""
    q = RecursiveQuery(engine=engine, max_depth=1, payload_cols=0,
                       caps=EngineCaps(1, 1))
    return build_plan(q).carries_positions


def plan_repr(engine: str, max_depth: int, payload_cols: int,
              root: int = 0) -> str:
    """The Volcano tree of the engine's plan, rendered from its actual
    operator composition (``Pipeline.render``), not from a template."""
    q = RecursiveQuery(engine=engine, max_depth=max_depth,
                       payload_cols=payload_cols,
                       caps=EngineCaps(frontier=0, result=0))
    return build_plan(q).render(root=root)


@dataclasses.dataclass(frozen=True)
class Dataset:
    """A prepared graph on one device: the column table + the join index.

    Direction views are built on first use and cached on the instance.  The
    reverse CSR (over ``to``) serves ``inbound``, the pull steps of an
    outbound query, and the fused ``both`` view, which adds only one merged
    (V+1) indptr on top of it.  The ``frontier_pull`` kernel's reverse
    layout is built on first use per orientation (``pull_layouts``), and
    the row table on first use by a row-store engine (``ensure_rows``)."""

    table: ColumnTable
    csr: CSRIndex
    num_vertices: int
    rows: RowTable | None = dataclasses.field(
        default=None, compare=False, repr=False)   # built on first use
    rcsr: CSRIndex | None = None           # reverse CSR (over `to`)
    both_indptr: torch.Tensor | None = None  # (V+1,) merged out+in indptr
    weights: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)  # weight columns
    #   cast to float32, built on first use
    pull_layouts: Dict[str, PullLayout] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)  # per orientation
    #   ("outbound" / "inbound"), built on first use
    stats_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False)  # direction ->
    #   the planner's GraphStats, computed on first use

    @classmethod
    def prepare(cls, table: ColumnTable, num_vertices: int, device=None
                ) -> "Dataset":
        table = table.to(resolve_device(device))
        return cls(table=table,
                   csr=build_csr(table.column("from"), num_vertices),
                   num_vertices=num_vertices)

    @property
    def device(self) -> torch.device:
        return self.table.device

    def ensure_rows(self) -> None:
        """Build + cache the row-store emulation's interleaved float32 row
        table (4 W bytes a row: 188 at 8 payload columns, about 197 MB at
        2^20 edges)."""
        if self.rows is None:
            object.__setattr__(self, "rows",
                               RowTable.from_column_table(self.table))

    def ensure_reverse(self) -> None:
        """Build + cache the reverse CSR (8 MiB at 2^20 edges).  Without it
        an outbound pull runs the plain version in natural edge order."""
        if self.rcsr is None:
            object.__setattr__(self, "rcsr", build_csr(
                self.table.column("to"), self.num_vertices))

    def ensure_direction(self, direction: str) -> None:
        if direction not in DIRECTIONS:
            raise ValueError(f"unknown direction {direction!r}")
        if direction in ("inbound", "both"):
            self.ensure_reverse()
        if direction == "both" and self.both_indptr is None:
            object.__setattr__(self, "both_indptr",
                               merged_indptr(self.csr, self.rcsr))

    def ensure_pull_layout(self, direction: str) -> None:
        """Build + cache the ``frontier_pull`` kernel's reverse layout of
        one orientation (about 4 (E + V) bytes, 8 MiB at 2^20 edges): over
        the reverse CSR for ``outbound``, over the CSR for ``inbound``.  The
        fused ``both`` view takes no kernel and has none."""
        self.ensure_direction(direction)
        if direction == "both" or direction in self.pull_layouts:
            return
        self.ensure_reverse()
        frm, to = self.table.column("from"), self.table.column("to")
        if direction == "inbound":
            layout = build_pull_layout(self.csr, to, frm, self.num_vertices)
        else:
            layout = build_pull_layout(self.rcsr, frm, to, self.num_vertices)
        self.pull_layouts[direction] = layout

    def edge_weights(self, weight_col: str) -> torch.Tensor:
        """The (E,) float32 ⊗-weight column in real position order,
        converted once per column and cached on the instance."""
        if weight_col not in self.weights:
            if weight_col not in self.table.columns:
                raise ValueError(f"unknown weight column {weight_col!r}; "
                                 f"table has {self.table.names}")
            col = self.table.column(weight_col)
            if col.dim() != 1:
                raise ValueError(
                    f"weight column {weight_col!r} must be 1-D, "
                    f"got shape {tuple(col.shape)}")
            self.weights[weight_col] = col.to(torch.float32)
        return self.weights[weight_col]

    def edge_view_bytes(self, direction: str = "outbound") -> int:
        """Bytes of the index arrays one direction's join view ADDS beyond
        the always-built outbound CSR (the fused-CSR memory audit): the
        reverse CSR for ``inbound``, plus one merged (V+1) indptr for
        ``both``; the outbound CSR itself for ``outbound``."""
        self.ensure_direction(direction)
        if direction == "outbound":
            return 4 * (self.csr.perm.numel() + self.csr.indptr.numel())
        rev = 4 * (self.rcsr.perm.numel() + self.rcsr.indptr.numel())
        if direction == "inbound":
            return rev
        return rev + 4 * self.both_indptr.numel()

    def stats(self, direction: str = "outbound"):
        """The planner's statistics of one direction view
        (:class:`~repro_torch.planner.stats.GraphStats`), computed on the
        host on first use and cached on the instance, inside the tracer's
        ``stats`` span."""
        if direction not in self.stats_cache:
            from ..planner.stats import compute_stats
            with _trace.trace_span("stats", direction=direction):
                self.stats_cache[direction] = compute_stats(self, direction)
        return self.stats_cache[direction]

    def context(self, direction: str = "outbound",
                weight_col: Optional[str] = None) -> Context:
        """The direction-resolved join view the operators run against;
        ``weight_col`` attaches the edge-weight column (weighted
        workloads), and the orientation's pull layout and the row table
        ride along once built."""
        self.ensure_direction(direction)
        frm, to = self.table.column("from"), self.table.column("to")
        w = self.edge_weights(weight_col) if weight_col is not None else None
        layout = self.pull_layouts.get(direction)
        if direction == "inbound":
            return Context(table=self.table, csr=self.rcsr, join_src=to,
                           join_dst=frm, rcsr=self.csr, edge_weights=w,
                           pull_layout=layout, rows=self.rows)
        if direction == "both":
            return Context(table=self.table, csr=self.csr, join_src=frm,
                           join_dst=to, rcsr=self.rcsr,
                           both_indptr=self.both_indptr, bidir=True,
                           edge_weights=w, rows=self.rows)
        return Context(table=self.table, csr=self.csr, join_src=frm,
                       join_dst=to, rcsr=self.rcsr, edge_weights=w,
                       pull_layout=layout, rows=self.rows)


def query_context(q: RecursiveQuery, ds: Dataset) -> Context:
    """The join view a query runs against: direction-resolved, with the
    edge-weight column attached for weighted workloads and, for the
    row-store engines, the row table (built on first use)."""
    if q.engine in ROWSTORE_ENGINE_NAMES:
        ds.ensure_rows()
    wc = q.weight_col if q.workload != "reach" else None
    return ds.context(q.direction, weight_col=wc)


def _device_plan(q: RecursiveQuery, ds: Dataset) -> Pipeline:
    """The query's pipeline for the dataset's device: the plain one on the
    CPU; on the card the one with the kernels plugged in, after the
    direction's pull layout is built (once per dataset) for the pulling
    engines."""
    if ds.device.type != "cuda":
        return build_plan(q)
    if q.engine in DIROPT_ENGINE_NAMES:
        ds.ensure_pull_layout(q.direction)
    return build_plan(q, expand_fn=frontier_expand_fused,
                      pull_fn=frontier_pull_fused,
                      spmm_fn=spmm_segment_sorted)


def _wait(r: BFSResult) -> None:
    """Wait for a result's work on the card (the reference's
    ``block_until_ready``); a CPU result is ready already."""
    if r.count.is_cuda:
        torch.cuda.synchronize(r.count.device)


def _traced(t, engine: str, direction: str, lanes: int, run) -> BFSResult:
    """``run()`` inside a ``dispatch`` span of tracer ``t``, waited for,
    then its per-level events."""
    with t.span("dispatch", engine=engine, direction=direction,
                lanes=lanes):
        r = run()
        _wait(r)
    _trace.emit_level_events(t, r, engine=engine)
    return r


def run_query(q: RecursiveQuery, ds: Dataset, root: int) -> BFSResult:
    """Execute one query through the fixed-point driver.  On a CUDA dataset
    the hand-written kernels run in place of their plain versions:
    ``frontier_expand`` in every IndexJoin, ``frontier_pull`` in
    every pull step, for which the reverse CSR and the direction's pull
    layout are built first (once per dataset), and ``spmm_segment`` in the
    dense (sum, ×) combine.  The result is bit-identical to the plain run,
    except that a (sum, ×) or (mul, ×) vertex value that combines several
    arrivals may differ in its last bits (summation order).

    With a tracer installed (:func:`repro_torch.obs.trace.set_tracer`) the
    dispatch is wrapped in a span, waited for, and per-level events are
    derived from the result (tracing is an enabled-only cost)."""
    plan = _device_plan(q, ds)

    def run():
        return execute(plan, query_context(q, ds), root, ds.num_vertices)
    t = _trace.current_tracer()
    if t is None:
        return run()
    return _traced(t, q.engine, q.direction, 1, run)


def run_query_batch(q: RecursiveQuery, ds: Dataset, roots) -> BFSResult:
    """Execute one query for many roots at once, on any engine and
    workload that :func:`run_query` takes (and with the same
    ``ValueError``s): every field of the returned ``BFSResult`` gains a
    leading ``len(roots)`` lane axis, and lane i is bit-identical to
    ``run_query(q, ds, roots[i])``.  One fixed-point loop serves every
    lane, with one host read per level for all of them; on a CUDA dataset
    the same kernels as in :func:`run_query` run, one call per level for
    every lane that takes them (``spmm_segment`` with each lane's frontier
    bits as its source mask).  Traced like :func:`run_query`."""
    plan = _device_plan(q, ds)
    roots = torch.as_tensor(roots).reshape(-1).tolist()

    def run():
        return execute_batch(plan, query_context(q, ds), roots,
                             ds.num_vertices)
    t = _trace.current_tracer()
    if t is None:
        return run()
    return _traced(t, q.engine, q.direction, len(roots), run)


def run_query_multi(q: RecursiveQuery, ds: Dataset, roots,
                    lane_limits=None) -> BFSResult:
    """Execute one query for up to :data:`WORD_LANES` roots in a single
    BIT-PARALLEL dispatch: every root is a bit lane of one packed dense
    frontier word, and one MS-BFS sweep per level advances all of them
    (the query runs on the ``multiquery`` engine whatever ``q.engine``
    names).  The returned ``BFSResult`` carries a leading ``len(roots)``
    lane axis; lane i is row-for-row identical to ``run_query`` on
    ``roots[i]`` through a deferred-emission engine (``diropt``), its
    ``depth`` and ``overflow`` included.  ``lane_limits`` (optional,
    per-lane depth caps) must never be below a lane's natural convergence
    depth; callers pass estimates only when they are exact.  The word
    sweep is plain PyTorch on the dataset's device; on the card the one
    ``ColumnTable.take`` of every lane's rows runs ``late_gather``.
    Traced like :func:`run_query`."""
    roots = torch.as_tensor(roots).reshape(-1).tolist()
    if len(roots) > WORD_LANES:
        raise ValueError(f"multiquery packs at most {WORD_LANES} roots "
                         f"per dispatch, got {len(roots)}")
    mq = q if q.engine == MULTIQUERY_ENGINE and q.lanes == len(roots) else \
        dataclasses.replace(q, engine=MULTIQUERY_ENGINE, lanes=len(roots))
    plan = build_plan(mq)
    ds.ensure_reverse()          # the word sweep gathers dst-grouped edges
    ds.ensure_direction(mq.direction)

    def run():
        return execute_multiquery(plan, query_context(mq, ds), roots,
                                  ds.num_vertices, lane_limits)
    t = _trace.current_tracer()
    if t is None:
        return run()
    return _traced(t, MULTIQUERY_ENGINE, mq.direction, len(roots), run)


def result_lane(r: BFSResult, lane: int) -> BFSResult:
    """Slice one lane out of a batched BFSResult."""
    return BFSResult(*(
        None if f is None else
        {k: v[lane] for k, v in f.items()} if isinstance(f, dict) else
        f[lane] for f in r))


def _to_host(r: BFSResult) -> BFSResult:
    """Every field of a result as CPU tensors, in one pass (which also
    waits for the card)."""
    return BFSResult(*(
        None if f is None else
        {k: v.cpu() for k, v in f.items()} if isinstance(f, dict) else
        f.cpu() for f in r))


# ---------------------------------------------------------------------------
# the bucket executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketTiming:
    """One bucket's measured dispatch, reported by
    :func:`dispatch_buckets` to its observer (the planner's calibration
    feedback loop consumes these).

    ``elapsed_us`` is this bucket's own wall-clock time: from the start of
    its dispatch to its results being materialized, covering its retries,
    evictions, ``finish`` and host copy.  The port dispatches each bucket
    only after the previous one is done (its drivers read the host once a
    level, so a dispatch runs to its end before it returns), so no
    bucket's interval holds another's work.  The reference launches every
    bucket first and measures from max(launch, previous completion)."""

    index: int                 # position in the buckets sequence
    lanes: int                 # real lanes (len(bucket.indices))
    padded_lanes: int          # dispatched lanes (len(bucket.roots))
    caps: EngineCaps           # the caps the MEASURED dispatch ran with
    retried: bool              # True when the fallback-caps retry ran
    elapsed_us: float
    predicted_caps: Optional[EngineCaps] = None
    #   the caps bucketing PREDICTED for this bucket: when ``retried`` is
    #   True these are the caps that overflowed (the measured dispatch ran
    #   at ``caps`` == the fallback), making the silent 2x-dispatch cliff
    #   visible to observers instead of only to the retry branch
    evicted_lanes: int = 0
    #   lanes evicted to SOLO fallback-caps re-dispatches because only they
    #   overflowed the bucket caps; the rest of the bucket kept its caps
    #   (with coalesced lanes, one pathological root must not force the
    #   whole 32-lane word onto fallback caps)


# process-wide visibility for the overflow-retry path: every retry is a
# hidden 2x-dispatch perf cliff (the bucket ran once at its predicted caps,
# overflowed, and ran again at the fallback caps), so it is counted here,
# surfaced on the BucketTiming, traced, and warned about once per process.
# The port keeps its own counters: they count the port's dispatches only.
_overflow_state = {"retries": 0, "warned": False, "lane_evictions": 0}


def overflow_retry_count() -> int:
    """Process-wide count of fallback-caps overflow retries."""
    return _overflow_state["retries"]


def lane_eviction_count() -> int:
    """Process-wide count of lanes evicted to solo fallback re-dispatches
    (per-lane overflow handling: the rest of the bucket kept its caps)."""
    return _overflow_state["lane_evictions"]


def _note_overflow_retry(index: int, predicted: EngineCaps,
                         fallback: EngineCaps, tracer) -> None:
    _overflow_state["retries"] += 1
    if tracer is not None:
        tracer.event("overflow_retry", bucket=index,
                     predicted_caps=[predicted.frontier, predicted.result],
                     fallback_caps=[fallback.frontier, fallback.result])
    if not _overflow_state["warned"]:
        _overflow_state["warned"] = True
        warnings.warn(
            f"bucket {index} overflowed its predicted caps "
            f"(frontier={predicted.frontier}, result={predicted.result}) "
            f"and was re-dispatched at the fallback caps "
            f"(frontier={fallback.frontier}, result={fallback.result}) — "
            "a transparent retry that doubles that bucket's dispatch "
            "cost; consider larger caps or fewer buckets "
            "(warned once per process; overflow_retry_count() counts "
            "them)", RuntimeWarning, stacklevel=3)


def _note_lane_eviction(index: int, lanes: Sequence[int],
                        predicted: EngineCaps, fallback: EngineCaps,
                        tracer) -> None:
    _overflow_state["lane_evictions"] += len(lanes)
    if tracer is not None:
        tracer.event("overflow_lane_eviction", bucket=index,
                     lanes=list(lanes),
                     predicted_caps=[predicted.frontier, predicted.result],
                     fallback_caps=[fallback.frontier, fallback.result])


def _evict_bucket(b, lane: int, caps: EngineCaps):
    """A single-lane bucket for one evicted root, dispatched solo at the
    fallback caps (the original bucket keeps its caps for every other
    lane)."""
    indices = (b.indices[lane],)
    roots = (b.roots[lane],)
    if dataclasses.is_dataclass(b):
        try:
            return dataclasses.replace(b, indices=indices, roots=roots,
                                       caps=caps)
        except TypeError:
            pass
    return types.SimpleNamespace(indices=indices, roots=roots, caps=caps)


class _SkippedLane:
    """Sentinel filling a lane whose bucket was skipped by the deadline
    budget: callers that passed ``deadline_us`` replace it with a
    classified degraded answer; callers that didn't never see it."""

    def __repr__(self) -> str:           # pragma: no cover - debug aid
        return "<skipped lane>"


SKIPPED = _SkippedLane()


@dataclasses.dataclass
class RetryPolicy:
    """THE retry policy: full-bucket overflow retries and per-lane
    evictions spend from this one bounded budget.

    ``max_attempts`` counts dispatches per bucket (initial + retries);
    ``growth`` grows caps geometrically toward the fallback on each retry
    (``None`` jumps straight to fallback caps); ``budget`` bounds TOTAL
    retries across the policy's lifetime (a serving session shares one
    policy across requests).  When the budget is exhausted the executor
    stops re-dispatching and reports the bucket in
    :attr:`DispatchReport.denied_buckets`: the caller then degrades that
    answer (truncated rows, flagged) instead of raising mid-request."""

    max_attempts: int = 2
    growth: Optional[float] = None
    budget: Optional[int] = None
    spent: int = 0

    def spend(self) -> bool:
        """Consume one retry if the budget allows it."""
        if self.budget is not None and self.spent >= self.budget:
            return False
        self.spent += 1
        return True

    def next_caps(self, attempt: int, current: EngineCaps,
                  fallback: EngineCaps) -> EngineCaps:
        """Caps for retry number ``attempt`` (1-based): geometric growth
        toward the fallback, or straight to it when ``growth`` is None or
        this is the last allowed attempt."""
        if self.growth is None or attempt + 1 >= self.max_attempts:
            return fallback
        return EngineCaps(
            frontier=min(int(current.frontier * self.growth),
                         fallback.frontier),
            result=min(int(current.result * self.growth), fallback.result))


@dataclasses.dataclass
class DispatchReport:
    """What :func:`dispatch_buckets` did beyond returning rows: which
    buckets were skipped (deadline), straggled, or were denied a retry:
    the explicit flags that replace silent blocking/truncation."""

    skipped_buckets: list = dataclasses.field(default_factory=list)
    skipped_lanes: list = dataclasses.field(default_factory=list)
    #   ORIGINAL root-vector indices whose bucket was never launched
    straggler_buckets: list = dataclasses.field(default_factory=list)
    denied_buckets: list = dataclasses.field(default_factory=list)
    #   overflowed buckets the retry budget refused to re-dispatch: their
    #   rows are TRUNCATED at bucket caps (callers must not overflow-check)
    denied_lanes: list = dataclasses.field(default_factory=list)
    retries: int = 0
    evictions: int = 0

    @property
    def truncated(self) -> bool:
        """True iff any lane's answer is incomplete (skipped or denied)."""
        return bool(self.skipped_buckets or self.denied_buckets)


def _real_overflow(r: BFSResult, n_real: int) -> np.ndarray:
    """The overflow flags of a bucket's real lanes on the host (a scalar
    flag broadcast over them)."""
    ov = r.overflow.reshape(-1).cpu().numpy()
    return ov[:n_real] if ov.size >= n_real else \
        np.broadcast_to(ov, (n_real,))


def dispatch_buckets(buckets: Sequence, dispatch: Callable, *,
                     fallback_caps: EngineCaps,
                     finish: Optional[Callable] = None,
                     observer: Optional[Callable] = None,
                     to_host: bool = False,
                     retry: Optional[RetryPolicy] = None,
                     deadline_us: Optional[float] = None,
                     straggler=None,
                     report: Optional[DispatchReport] = None) -> list:
    """THE bucket-dispatch executor: every reach-bucketed execution path
    (:func:`run_query_buckets`, and the planner and serving layers of
    later slices) delegates here, so the launch -> overflow-retry ->
    scatter-by-indices shape exists exactly once.

    ``dispatch(index, bucket, caps)`` runs one batched dispatch for a
    bucket at the given caps and returns a batched ``BFSResult`` (leading
    lane axis).  A bucket needs only ``indices`` (its lanes in the
    original root vector), ``roots`` and ``caps``.  The executor:

    * dispatches the buckets one at a time, each just before its own
      overflow check, so that each bucket's timing is its own (the
      reference launches every bucket before it reads any, because its
      launches are asynchronous; the port's drivers read the host once a
      level, so a launch loop would run every bucket to its end and charge
      the whole request to the first bucket).  Under a ``deadline_us``
      budget a bucket is SKIPPED (its lanes filled with the
      :data:`SKIPPED` sentinel, recorded on the ``report``) when the
      budget is already exhausted or the straggler monitor's predicted
      wall time (``straggler.expected``) no longer fits the remainder;
      skip-vs-launch is decided BEFORE paying the dispatch cost.  The
      first bucket always launches: a request makes progress, the budget
      only stops FURTHER work;
    * retries on overflow through the :class:`RetryPolicy` (bucket caps
      are predictions; bucketing must never turn a valid query into a
      truncated result).  When overflow is PER LANE and only some real
      lanes overflowed, just those lanes are EVICTED to solo fallback
      re-dispatches and the rest of the bucket keeps its result at bucket
      caps.  Only a full-bucket (or scalar) overflow re-dispatches the
      whole bucket.  A policy whose budget is exhausted DENIES the retry:
      the bucket is recorded in ``report.denied_buckets`` and its
      truncated-at-caps rows stand;
    * applies the optional ``finish(index, bucket, result)`` hook to the
      batched result (the report is filled for bucket ``i`` before
      ``finish(i, ...)`` runs, so the hook can consult it);
    * scatters lanes back to the ORIGINAL root order via each bucket's
      ``indices`` (``to_host=True`` moves each bucket's result to CPU
      tensors first, one pass per bucket; lanes become views);
    * measures per-bucket wall-clock ONCE, consistently, and reports it to
      ``observer(timing)`` as a :class:`BucketTiming`.  When a
      ``straggler`` monitor is passed (anything with ``.expected`` and
      ``.record(elapsed_us)``), every measured bucket feeds it and buckets
      it flags are recorded in ``report.straggler_buckets``.

    The fault points ``bucket_overflow`` and ``straggler_sleep``
    (:mod:`repro_torch.obs.faultinject`) are consulted where the reference
    consults them."""
    buckets = tuple(buckets)
    total = sum(len(b.indices) for b in buckets)
    out: list = [None] * total
    policy = retry if retry is not None else RetryPolicy()
    rep = report if report is not None else DispatchReport()
    # the executor owns bucket-granular tracing: suppress the global
    # tracer around nested dispatches so per-root instrumentation inside
    # run_query_batch stays out of the timed intervals, and emit
    # per-bucket spans/events from the one measurement point instead
    tracer = _trace.current_tracer()
    prev_tracer = _trace.set_tracer(None) if tracer is not None else None
    try:
        t_start = time.perf_counter()
        timings = []
        for i, b in enumerate(buckets):
            if deadline_us is not None:
                elapsed_us = (time.perf_counter() - t_start) * 1e6
                predicted_us = (straggler.expected
                                if straggler is not None else 0.0)
                if timings and elapsed_us + predicted_us >= deadline_us:
                    rep.skipped_buckets.append(i)
                    if tracer is not None:
                        tracer.event("deadline_skip", bucket=i,
                                     lanes=len(b.indices),
                                     elapsed_us=elapsed_us,
                                     predicted_us=predicted_us,
                                     deadline_us=deadline_us)
                    for idx in b.indices:
                        rep.skipped_lanes.append(idx)
                        out[idx] = SKIPPED
                    continue
            t0 = time.perf_counter()
            r = dispatch(i, b, b.caps)
            if _fault._ACTIVE:
                d = _fault.consume("straggler_sleep")
                if d:
                    time.sleep(float(d))
            retried = False
            evicted: dict = {}
            if b.caps != fallback_caps:
                n_real = len(b.indices)
                real_ov = _real_overflow(r, n_real)
                if _fault._ACTIVE and _fault.consume("bucket_overflow"):
                    real_ov = np.ones(n_real, dtype=bool)
                if real_ov.any():
                    if n_real == 1 or real_ov.all():
                        caps_now = b.caps
                        attempt = 1
                        while attempt < policy.max_attempts:
                            if not policy.spend():
                                break
                            caps_now = policy.next_caps(
                                attempt, caps_now, fallback_caps)
                            r = dispatch(i, b, caps_now)
                            retried = True
                            rep.retries += 1
                            _note_overflow_retry(i, b.caps, caps_now,
                                                 tracer)
                            real_ov = _real_overflow(r, n_real)
                            attempt += 1
                            if not real_ov.any() \
                                    or caps_now == fallback_caps:
                                break
                        if real_ov.any() and not retried:
                            rep.denied_buckets.append(i)
                            rep.denied_lanes.extend(b.indices)
                    else:
                        # per-lane eviction: solo fallback re-dispatch for
                        # just the overflowing lanes
                        hit = np.nonzero(real_ov)[0].tolist()
                        done = []
                        for lane in hit:
                            if not policy.spend():
                                rep.denied_lanes.append(b.indices[lane])
                                continue
                            sb = _evict_bucket(b, lane, fallback_caps)
                            evicted[lane] = (sb, dispatch(i, sb,
                                                          fallback_caps))
                            done.append(lane)
                            rep.evictions += 1
                        if done:
                            _note_lane_eviction(i, done, b.caps,
                                                fallback_caps, tracer)
                            # the evicted lanes' answers come from their
                            # solo re-dispatches: clear their flags in the
                            # bucket result, so that ``finish`` sees the
                            # overflow of the lanes it delivers only (the
                            # reference hands it the stale flags, and a
                            # finish that checks overflow raises there)
                            ov = r.overflow.clone()
                            ov[done] = False
                            r = r._replace(overflow=ov)
                        if len(done) < len(hit):
                            rep.denied_buckets.append(i)
            if finish is not None:
                r = finish(i, b, r)
                evicted = {lane: (sb, finish(i, sb, rr))
                           for lane, (sb, rr) in evicted.items()}
            if to_host:
                # one device->host pass per bucket (also waits for it)
                if tracer is not None:
                    with tracer.span("transfer", bucket=i,
                                     lanes=len(b.indices)):
                        r = _to_host(r)
                else:
                    r = _to_host(r)
                evicted = {lane: (sb, _to_host(rr))
                           for lane, (sb, rr) in evicted.items()}
            elif observer is not None or tracer is not None:
                _wait(r)  # timing needs a real completion
                for _, rr in evicted.values():
                    _wait(rr)
            t_done = time.perf_counter()
            for lane, idx in enumerate(b.indices):
                if lane in evicted:
                    out[idx] = result_lane(evicted[lane][1], 0)
                else:
                    out[idx] = result_lane(r, lane)
            timing = BucketTiming(
                index=i, lanes=len(b.indices), padded_lanes=len(b.roots),
                caps=(fallback_caps if retried else b.caps),
                retried=retried,
                elapsed_us=(t_done - t0) * 1e6,
                predicted_caps=b.caps, evicted_lanes=len(evicted))
            if straggler is not None and straggler.record(timing.elapsed_us):
                rep.straggler_buckets.append(i)
                if tracer is not None:
                    tracer.event("straggler", bucket=i,
                                 elapsed_us=timing.elapsed_us,
                                 expected_us=straggler.expected)
            if observer is not None:
                observer(timing)
            timings.append((timing, r))
    finally:
        if tracer is not None:
            _trace.set_tracer(prev_tracer)
    if tracer is not None:
        # spans + level events AFTER the measurement loop, so enabled
        # tracing never sits inside a timed interval the calibrator trusts
        for timing, r in timings:
            with tracer.span("dispatch", bucket=timing.index,
                             lanes=timing.lanes,
                             padded_lanes=timing.padded_lanes,
                             retried=timing.retried,
                             elapsed_us=timing.elapsed_us):
                _trace.emit_level_events(tracer, r, bucket=timing.index)
    if any(x is None for x in out):
        raise ValueError("buckets do not cover lanes 0..%d exactly"
                         % (total - 1))
    return out  # deadline-skipped lanes hold the SKIPPED sentinel


def run_query_buckets(q: RecursiveQuery, ds: Dataset, buckets
                      ) -> list[BFSResult]:
    """Reach-bucketed execution: one batched dispatch PER BUCKET, each with
    that bucket's (smaller) ``EngineCaps``, instead of one worst-case
    lockstep dispatch over the whole root vector.

    ``buckets`` is a sequence of bucket objects carrying ``roots``,
    ``indices`` (lanes in the original root vector) and ``caps`` (the
    reference's planner makes them; the port's planner comes with a later
    slice).  Results come back PER ROOT, in the original order; each entry
    is bit-identical to ``run_query(q, ds, root)`` on its root.  Launch
    ordering, the overflow retry at ``q.caps`` and the scatter live in
    :func:`dispatch_buckets`.  Each bucket runs through
    :func:`run_query_batch`, so every engine and workload that
    :func:`run_query` takes is served, weighted queries and the paper's
    tuple-based and row-store engines included."""
    def _dispatch(i, b, caps):
        qb = dataclasses.replace(q, caps=caps) if caps != q.caps else q
        return run_query_batch(qb, ds, b.roots)

    return dispatch_buckets(buckets, _dispatch, fallback_caps=q.caps)


def plan_and_run(sql_or_ast, ds: Dataset, roots=None, **kwargs) -> BFSResult:
    """Answer a recursive query WITHOUT an engine name: parse the minimal
    ``WITH RECURSIVE`` dialect (or take a planner AST / LogicalQuery),
    price every legal engine against ``ds.stats()``, and execute the
    cheapest through the same path ``run_query`` uses.  ``roots`` is one
    root or a sequence (one batched dispatch).  See
    :func:`repro_torch.planner.plan_and_run` for the keyword options."""
    from ..planner import plan_and_run as _impl
    return _impl(sql_or_ast, ds, roots, **kwargs)


def explain(sql_or_ast, ds: Dataset, **kwargs) -> str:
    """EXPLAIN the query: the ranked candidate engines with per-operator
    estimated rows/bytes (see :mod:`repro_torch.planner.explain`)."""
    from ..planner import explain as _impl
    return _impl(sql_or_ast, ds, **kwargs)


def explain_analyze(sql_or_ast, ds: Dataset, **kwargs) -> dict:
    """EXPLAIN ANALYZE: plan, EXECUTE on the dataset's device, and
    reconcile predicted vs. actual per-operator rows/bytes and per-level
    push/pull directions (see
    :func:`repro_torch.planner.explain.explain_analyze`)."""
    from ..planner import explain_analyze as _impl
    return _impl(sql_or_ast, ds, **kwargs)
