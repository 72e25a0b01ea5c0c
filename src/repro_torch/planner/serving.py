"""The traversal serving layer: a plan cache over the reach-bucketed batch
execution path, with a calibration feedback loop and an optional persistent
plan store.

A serving process answers the same handful of query SHAPES over and over
with different root batches (many users, one graph).  Re-running the full
planning pass — parse, statistics, per-candidate costing — on every request
wastes the latency budget on work whose inputs did not change, so this
module memoizes it at three grains:

* **logical cache** — normalized SQL text → :class:`LogicalQuery` (parsing
  and normalization amortized);
* **choice cache** — query shape (root stripped) → the planner's ranked
  pick (statistics + costing amortized);
* **plan cache** — (query shape, direction, bucket signature) →
  :class:`PlanEntry` holding the machine-readable JSON plan
  (:func:`repro_torch.planner.explain.to_json`) for that exact serving
  configuration.  The bucket signature is the tuple of per-bucket
  ``(lanes, frontier cap, result cap)`` — what a dispatch's buffers are
  sized by, so a plan-cache hit reuses the same dispatch shapes.

Execution is reach-bucketed with a PER-BUCKET physical choice: the root
vector is partitioned by root-conditional predicted reach
(:func:`repro_torch.planner.optimize.bucket_roots`), then every bucket is
re-costed WITH ITS OWN CAPS and gets its own engine — the capacity-aware
cost model means a leaf bucket's tiny blocks favor the positional engine
even when the hub bucket (or the whole-batch plan) favors the dense
bitmap.  Each bucket runs as one batched dispatch through THE shared
bucket executor (:func:`repro_torch.core.engine.dispatch_buckets` — launch,
overflow-retry and scatter live there, once); a bucket that overflows its
predicted caps is retried once with the global caps.  On a CUDA dataset
every dispatch runs on the card with the hand-written kernels the engine
takes (``late_gather`` in every bucket's materialization,
``frontier_expand``, ``frontier_pull`` and ``spmm_segment`` where its
levels call them), and each bucket's result is copied to the host once.

Two feedback mechanisms close the loop:

* **calibration** — the executor times every warm bucket dispatch once,
  consistently; the session feeds ``(plan signature, levels, byte split,
  measured us)`` to its :class:`~repro_torch.planner.calibrate.Calibrator`,
  which periodically refits the :class:`~repro_torch.planner.cost.
  CostConstants` used by every subsequent planning pass
  (``calibrate_every``).  A bucket's measured interval ends when its
  result has been copied off the card, so on the card the fit is of
  device work plus the copy;
* **the plan store** — ``session.save_plan_store(path)`` serializes every
  cache grain plus the calibration state through the schema-version-2 plan
  JSON (:mod:`repro_torch.planner.plan_store`); ``ServingSession(ds,
  plan_store=path)`` rehydrates them, so a warm process answers its first
  request with ZERO parse/stats/cost calls (see ``session.counters``).

**Request coalescing** (``enqueue``/``flush``): single-root requests that
arrive together are grouped by (graph, query shape, direction) and each
group is answered by ONE batched dispatch — inside the bucketed path every
multi-lane bucket is planned with its lane count, which admits the
bit-parallel ``multiquery`` engine (up to 32 roots as bits of one packed
uint32 frontier word, one MS-BFS sweep per level for all of them).  The
per-root results scatter back to the callers' :class:`PendingResult`
tickets in enqueue order.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import (SKIPPED, WORD_LANES, Dataset, DispatchReport,
                           RetryPolicy, dispatch_buckets, run_query_batch,
                           run_query_multi)
from ..core.operators import BFSResult, EngineCaps, execute_batch
from ..distributed.fault_tolerance import StragglerMonitor
from ..obs import faultinject as _fault
from ..obs import trace as _trace
from ..obs.metrics import MetricsRegistry

from .ast import LogicalQuery, normalize, parse
from .calibrate import Calibrator, plan_signature, stats_digest
from .explain import analyze_result, to_json
from .guards import (AdmissionError, GuardResult, InvalidRequestError,
                     admit_roots)
from .optimize import (PhysicalChoice, PlannerReport, RootBucket,
                       bucket_roots, plan)
from .stats import compute_stats, root_estimates

__all__ = ["PendingResult", "PlanEntry", "RequestReport", "ServingSession",
           "shape_key"]


ShapeKey = Tuple
PlanKey = Tuple


def shape_key(logical: LogicalQuery) -> ShapeKey:
    """The normalized query shape: every logical axis EXCEPT the root —
    requests that differ only in their root batch share one planning pass."""
    return (logical.max_depth, logical.payload_cols, logical.dedup,
            logical.direction, logical.want_cols, logical.want_depth,
            logical.union_all, getattr(logical, "workload", "reach"),
            getattr(logical, "weight_col", None))


class PendingResult:
    """The ticket for ONE enqueued root: :meth:`ServingSession.enqueue`
    returns it immediately, :meth:`ServingSession.flush` fills it.  Reading
    :meth:`result` before the flush raises — the whole point of enqueueing
    is that nothing executes until the batch is coalesced."""

    __slots__ = ("_value", "_done")

    def __init__(self):
        self._done = False
        self._value = None

    @property
    def done(self) -> bool:
        return self._done

    def result(self) -> BFSResult:
        if not self._done:
            raise RuntimeError("request not yet dispatched: call "
                               "ServingSession.flush() first")
        return self._value

    def _fill(self, value: BFSResult) -> None:
        self._value = value
        self._done = True


@dataclasses.dataclass
class PlanEntry:
    """One plan-cache entry: the shape-level chosen plan, the bucket layout
    it serves, the PER-BUCKET physical choices (each bucket re-costed with
    its own caps), and the machine-readable JSON plan."""

    choice: PhysicalChoice                       # shape-level pick
    report: PlannerReport
    roots: Tuple[int, ...]                       # request-order root vector
    buckets: Tuple[RootBucket, ...]
    bucket_choices: Tuple[PhysicalChoice, ...]   # one per bucket
    bucket_signature: Tuple[Tuple[int, int, int], ...]
    plan_json: dict
    hits: int = 0
    served: int = 0          # executions IN THIS PROCESS (gates calibration:
    #   a rehydrated entry is plan-warm, but its first serve in a process
    #   still pays the kernels' first load, the caching allocator's first
    #   blocks and library handles, and that must not enter the fit)
    last_latency_us: float = 0.0


@dataclasses.dataclass
class RequestReport:
    """What the front door did to ONE request beyond returning rows —
    the explicit classification of every degraded answer (readable as
    ``session.last_report`` right after ``submit``).  A lane is either
    served in full, or appears in exactly one of these lists."""

    admission: Optional[List[GuardResult]] = None   # per-root decisions
    degraded_roots: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)       # (root, clamped depth): prefix answers
    skipped_roots: List[int] = dataclasses.field(default_factory=list)
    #   roots whose bucket the deadline budget never launched (empty answer)
    denied_roots: List[int] = dataclasses.field(default_factory=list)
    #   roots whose overflow retry / degraded re-dispatch the RetryPolicy
    #   refused (truncated or empty answer)
    skipped_buckets: int = 0
    straggler_buckets: int = 0
    retries: int = 0
    evictions: int = 0

    @property
    def truncated(self) -> bool:
        """True iff ANY lane's answer is not the full traversal."""
        return bool(self.degraded_roots or self.skipped_roots
                    or self.denied_roots)


class ServingSession:
    """One graph, many requests: plan once per query shape, serve every
    batch through the reach-bucketed path.

    >>> session = ServingSession(ds)
    >>> results = session.submit(sql, roots=[3, 17, 4096])

    ``results`` is one dressed :class:`BFSResult` per root, in request
    order.  Each is ROW-SET identical to ``plan_and_run(sql, ds, root)``
    on that root (same rows, counts and depths); row ORDER may differ,
    because every bucket is re-costed with its own caps and may pick a
    different engine than the single-root plan, and engines order result
    rows differently.  ``session.stats`` reports request/hit counters and
    the last request's latency; ``session.counters`` reports how many
    parse / statistics / costing passes the session has actually paid
    (a plan-store-rehydrated session replaying known traffic pays none).
    """

    def __init__(self, ds: Dataset, *, max_buckets: int = 4,
                 caps: Optional[EngineCaps] = None,
                 include_kernel: bool = False,
                 calibrator: Optional[Calibrator] = None,
                 calibrate_every: int = 32,
                 plan_store: Optional[str] = None,
                 tracer: Optional[_trace.Tracer] = None,
                 guards: bool = True,
                 retry_policy: Optional[RetryPolicy] = None):
        self.ds = ds
        self.max_buckets = max_buckets
        self.caps = caps
        self.include_kernel = include_kernel
        self.calibrator = calibrator if calibrator is not None \
            else Calibrator()
        self.calibrate_every = int(calibrate_every)
        self.plan_store_path = plan_store
        self.tracer = tracer     # installed process-wide for each submit()
        # the admission guard ladder (planner/guards.py): every submitted
        # root's pre-dispatch reach estimate is priced against the
        # CostConstants budgets; guards=False serves everything as planned
        # (the admission_overhead_ratio perf gate compares the two)
        self.guards = bool(guards)
        # ONE bounded retry budget for the whole session: overflow retries,
        # lane evictions and guard-degraded re-dispatches all spend from it
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy()
        # per-bucket wall-time EMA: fed by every measured dispatch, read by
        # the executor's deadline budgeting to decide skip-vs-launch
        self._straggler = StragglerMonitor()
        self.last_report: Optional[RequestReport] = None
        self._logical: Dict[str, LogicalQuery] = {}
        self._choice: Dict[ShapeKey, PlannerReport] = {}
        self._bucket_plans: Dict[Tuple, PhysicalChoice] = {}
        self._plans: Dict[PlanKey, PlanEntry] = {}
        self._requests: Dict[Tuple, PlanKey] = {}   # (shape, roots) -> key
        self.requests = 0
        self.plan_hits = 0
        self.plan_misses = 0
        self.last_latency_us = 0.0
        # how much planning work this session has actually paid — a
        # rehydrated session replaying known traffic keeps all three at 0
        self.counters = {"parse_calls": 0, "stats_calls": 0,
                         "cost_calls": 0}
        self._last_refit_count = 0
        self._metrics = MetricsRegistry()
        self._m_requests = self._metrics.counter(
            "repro_requests_total", "serving requests submitted")
        self._m_roots = self._metrics.counter(
            "repro_roots_served_total", "roots answered across requests")
        self._m_latency = self._metrics.histogram(
            "repro_request_latency_us",
            "end-to-end submit() latency (microseconds)")
        self._m_bucket = self._metrics.histogram(
            "repro_bucket_dispatch_us",
            "per-bucket dispatch latency (microseconds)")
        self._m_hits = self._metrics.counter(
            "repro_plan_cache_hits_total", "plan-cache hits")
        self._m_misses = self._metrics.counter(
            "repro_plan_cache_misses_total", "plan-cache misses")
        self._m_retries = self._metrics.counter(
            "repro_overflow_retries_total",
            "bucket dispatches re-run at fallback caps after overflow")
        self._m_lane_evictions = self._metrics.counter(
            "repro_overflow_lane_evictions_total",
            "lanes evicted to solo fallback-caps re-dispatches (the rest "
            "of their bucket kept its right-sized caps)")
        self._m_coalesced = self._metrics.counter(
            "repro_coalesced_dispatches_total",
            "flush() request groups answered by one coalesced dispatch")
        self._m_coalesced_roots = self._metrics.counter(
            "repro_coalesced_roots_total",
            "enqueued roots answered through coalesced dispatches")
        self._m_admit_traverse = self._metrics.counter(
            "repro_admission_traverse_total",
            "roots admitted to run as planned by the guard ladder")
        self._m_admit_degrade = self._metrics.counter(
            "repro_admission_degrade_total",
            "roots depth-clamped to a bounded prefix by the guard ladder")
        self._m_admit_reject = self._metrics.counter(
            "repro_admission_reject_total",
            "roots rejected at the front door (AdmissionError)")
        self._m_deadline_skipped = self._metrics.counter(
            "repro_deadline_skipped_buckets_total",
            "buckets skipped by a deadline budget or exceeding their "
            "straggler deadline")
        self._m_retry_denied = self._metrics.counter(
            "repro_retry_denied_total",
            "re-dispatches refused by the exhausted RetryPolicy budget "
            "(the answer degraded instead of retrying)")
        self._pending: Dict[ShapeKey, list] = {}
        self._warned_overflow = False
        self._warned_deadline = False
        if plan_store is not None and os.path.exists(plan_store):
            # front-door hardening: a truncated, corrupted, future-schema
            # or wrong-graph store must not take serving down — warn, drop
            # whatever the partial rehydrate touched, and cold-start (the
            # next save_plan_store() rewrites the file atomically).  Direct
            # rehydrate_session()/migrate_plan_doc() calls still raise.
            from .plan_store import rehydrate_into
            try:
                rehydrate_into(self, plan_store)
            except Exception as e:
                self._logical.clear()
                self._choice.clear()
                self._bucket_plans.clear()
                self._plans.clear()
                self._requests.clear()
                if calibrator is None:
                    self.calibrator = Calibrator()
                warnings.warn(
                    f"plan store {plan_store!r} could not be rehydrated "
                    f"({type(e).__name__}: {e}); cold-starting the "
                    "session — the next save_plan_store() rewrites it "
                    "atomically", RuntimeWarning, stacklevel=2)

    # -- the three cache grains -------------------------------------------
    def _normalize_sql(self, sql: str) -> str:
        return " ".join(sql.split())

    def _logical_for(self, sql: str) -> LogicalQuery:
        key = self._normalize_sql(sql)
        if key not in self._logical:
            before = compute_stats.calls
            self.counters["parse_calls"] += 1
            self._logical[key] = normalize(parse(sql), self.ds)
            self.counters["stats_calls"] += compute_stats.calls - before
        return self._logical[key]

    def _report_for(self, logical: LogicalQuery) -> PlannerReport:
        key = shape_key(logical)
        if key not in self._choice:
            self.counters["cost_calls"] += 1
            self._choice[key] = plan(logical, self.ds, caps=self.caps,
                                     include_kernel=self.include_kernel,
                                     constants=self.calibrator.constants)
        return self._choice[key]

    def _bucket_choice(self, logical: LogicalQuery,
                       bucket: RootBucket) -> PhysicalChoice:
        """Re-cost the candidate engines WITH THE BUCKET'S CAPS AND LANE
        COUNT and pick per bucket: the capacity-aware cost model makes
        small blocks favor positional pipelines even when the whole-batch
        plan favors a dense O(E) engine — this is where a leaf bucket stops
        paying bitmap scans.  The padded lane count goes to the planner as
        ``lanes``, which admits the bit-parallel ``multiquery`` engine
        (ranked per-root amortized) for multi-lane buckets.  Memoized per
        (shape, caps, lanes) — the lane count changes both the candidate
        set and the amortized ranking."""
        key = (shape_key(logical), bucket.caps, len(bucket.roots))
        if key not in self._bucket_plans:
            self.counters["cost_calls"] += 1
            self._bucket_plans[key] = plan(
                logical, self.ds, caps=bucket.caps,
                include_kernel=self.include_kernel,
                constants=self.calibrator.constants,
                lanes=len(bucket.roots)).best
        return self._bucket_plans[key]

    def _plan_doc(self, report: PlannerReport, buckets, choices) -> dict:
        doc = to_json(report, buckets=buckets)
        for b, c in zip(doc["buckets"], choices):
            b["engine"] = c.label
        return doc

    _REQUEST_MEMO_MAX = 4096      # bound the exact-request fast path

    def _entry_for(self, logical: LogicalQuery, roots) -> PlanEntry:
        before = compute_stats.calls
        try:
            return self._entry_for_inner(logical, roots)
        finally:
            self.counters["stats_calls"] += compute_stats.calls - before

    def _entry_for_inner(self, logical: LogicalQuery, roots) -> PlanEntry:
        roots = tuple(int(r) for r in np.asarray(roots).reshape(-1))
        # exact-repeat fast path: a byte-identical request skips the
        # bucket derivation entirely (bucketing is deterministic per
        # (shape, roots) on one dataset)
        memo_key = (shape_key(logical), roots)
        key = self._requests.get(memo_key)
        if key is not None:
            entry = self._plans.get(key)
            if entry is not None and entry.roots == roots:
                entry.hits += 1
                self.plan_hits += 1
                return entry
        report = self._report_for(logical)
        choice = report.best
        buckets = bucket_roots(
            self.ds, roots, direction=choice.query.direction,
            max_depth=choice.query.max_depth, dedup=choice.query.dedup,
            caps=choice.query.caps, max_buckets=self.max_buckets)
        signature = tuple(b.signature for b in buckets)
        key = (shape_key(logical), signature)
        entry = self._plans.get(key)
        if entry is None:
            choices = tuple(self._bucket_choice(logical, b)
                            for b in buckets)
            entry = PlanEntry(
                choice=choice, report=report, roots=roots, buckets=buckets,
                bucket_choices=choices, bucket_signature=signature,
                plan_json=self._plan_doc(report, buckets, choices))
            self._plans[key] = entry
            self.plan_misses += 1
        else:
            # same shape + signature: reuse the cached layout only for the
            # SAME request-order roots; otherwise rebind to the fresh
            # bucket layout (signature equality guarantees the same-shaped
            # dispatches still match, but the lane->root mapping does not)
            if roots != entry.roots:
                entry = dataclasses.replace(
                    entry, roots=roots, buckets=buckets,
                    plan_json=self._plan_doc(report, buckets,
                                             entry.bucket_choices),
                    hits=entry.hits)
                self._plans[key] = entry
            entry.hits += 1
            self.plan_hits += 1
        if len(self._requests) >= self._REQUEST_MEMO_MAX:
            self._requests.clear()
        self._requests[memo_key] = key
        return entry

    # -- the serving entry point ------------------------------------------
    def _observer(self, entry: PlanEntry, calibrate: bool):
        """The executor's per-bucket timing tap.  ALWAYS feeds the metrics
        registry (dispatch-latency histogram, overflow-retry counter, the
        once-per-session retry warning); feeds the CALIBRATOR only when
        ``calibrate`` (warm dispatches) and the bucket was not retried —
        a retried dispatch ran at caps the bucket plan was not priced for,
        and a cold dispatch's timing includes first-use costs.  The plan's
        byte estimates price ONE lane; the measured dispatch runs the
        bucket's padded lanes, so the predictors are scaled by the lane
        count (and the lane count joins the signature — a 1-lane and an
        8-lane dispatch are different programs doing different work)."""
        digest = stats_digest(entry.report.stats)
        shape = shape_key(entry.report.logical)
        workload = getattr(entry.report.logical, "workload", "reach")

        def _observe(t):
            self._m_bucket.observe(t.elapsed_us)
            if t.evicted_lanes:
                self._m_lane_evictions.inc(t.evicted_lanes)
            if t.retried:
                self._m_retries.inc()
                if not self._warned_overflow:
                    self._warned_overflow = True
                    pc = t.predicted_caps
                    warnings.warn(
                        f"serving bucket {t.index} overflowed its "
                        f"predicted caps"
                        + (f" (frontier={pc.frontier}, result={pc.result})"
                           if pc is not None else "")
                        + " and was re-dispatched at the global caps — a "
                        "transparent retry that doubles that bucket's "
                        "dispatch cost (warned once per session; "
                        "repro_overflow_retries_total counts every one)",
                        RuntimeWarning, stacklevel=2)
                return
            if not calibrate:
                return
            c = entry.bucket_choices[t.index]
            lanes = max(t.padded_lanes, 1)
            # the bit-parallel engine's plan already prices the WHOLE
            # coalesced batch (its emit term carries the lane factor), so
            # its predictors are fed unscaled; a lane-batched engine's
            # plan prices ONE lane and is scaled by the dispatched count
            scale = 1 if c.engine == "multiquery" else lanes
            measured = t.elapsed_us
            if _fault._ACTIVE:
                # chaos seam: a poisoned measurement stands in for a host
                # clock glitch / preempted timer — the calibrator's own
                # guards (finite-check + validated refit) must absorb it
                v = _fault.consume("calibrator_poison")
                if v is not None and v is not True:
                    measured = float(v)
            self.calibrator.observe(
                plan_signature(c.label, c.query.direction, t.caps, digest,
                               lanes=lanes, shape=shape,
                               mix=c.cost.level_dirs, workload=workload),
                levels=c.cost.levels,
                plain_bytes=scale * c.cost.plain_bytes,
                kernel_bytes=scale * c.cost.kernel_bytes,
                measured_us=measured)

        return _observe

    def _lane_limits(self, q, bucket: RootBucket):
        """Per-lane depth caps for one coalesced multiquery bucket: a lane
        whose root has an EXACT (sampled) reach profile is frozen at its
        known convergence depth instead of riding along for the full
        ``max_depth`` sweeps.  Degree-conditioned estimates can undershoot
        and a short cap silently truncates the lane's rows, so unsampled
        roots keep the uncapped depth.  Returns None when no lane can be
        capped (the dispatch is then identical to the uncapped one)."""
        ests = root_estimates(self.ds, q.direction, bucket.roots,
                              q.max_depth)
        caps = np.asarray(
            [min(e.depth, q.max_depth) if e.exact else q.max_depth
             for e in ests], np.int32)
        return caps if bool(np.any(caps < q.max_depth)) else None

    def _execute(self, entry: PlanEntry, check_overflow: bool,
                 observe: bool = False,
                 deadline_us: Optional[float] = None
                 ) -> Tuple[list, DispatchReport]:
        """One batched dispatch per bucket, each with ITS chosen engine and
        caps, through THE shared bucket executor
        (:func:`repro_torch.core.engine.dispatch_buckets`).  Only the dispatch
        callback (each bucket's own engine/pipeline) and the dressing hook
        are serving-specific; launch ordering, the retry-policy overflow
        handling, deadline skipping, the host transfer/scatter and the
        per-bucket timing live in the executor, shared with every other
        bucketed path.  Returns ``(per-lane results, DispatchReport)`` —
        deadline-skipped lanes hold the :data:`~repro_torch.core.engine.
        SKIPPED` sentinel; retry-denied buckets are dressed WITHOUT the
        overflow check (their truncated rows stand, classified on the
        report).  Every branch runs on the dataset's device."""
        global_caps = entry.choice.query.caps
        choices = entry.bucket_choices
        rep = DispatchReport()

        def _dispatch(i, b, caps):
            c = choices[i]
            if c.use_kernel:
                ctx = self.ds.context(c.query.direction)
                return execute_batch(c._kernel_pipeline(caps), ctx,
                                     list(b.roots), self.ds.num_vertices)
            if c.engine == "multiquery":
                # one bit-parallel dispatch for the whole bucket: its lanes
                # pack into one frontier word, each lane depth-capped by
                # its root's (exact-only) predicted convergence depth
                q = dataclasses.replace(c.query, caps=caps,
                                        lanes=len(b.roots))
                return run_query_multi(q, self.ds, list(b.roots),
                                       self._lane_limits(c.query, b))
            q = (c.query if caps == c.query.caps
                 else dataclasses.replace(c.query, caps=caps))
            return run_query_batch(q, self.ds, list(b.roots))

        def _finish(i, b, r):
            # the executor fills the report for bucket i before finish(i):
            # a retry-denied bucket's rows are truncated BY DESIGN — dress
            # them without the overflow check (degraded, not an error)
            co = check_overflow and i not in rep.denied_buckets
            return choices[i].dress(r, check_overflow=co,
                                    caps=choices[i].query.caps)

        out = dispatch_buckets(
            entry.buckets, _dispatch, fallback_caps=global_caps,
            finish=_finish, observer=self._observer(entry, observe),
            to_host=True, retry=self.retry_policy,
            deadline_us=deadline_us, straggler=self._straggler, report=rep)
        return out, rep

    # -- the failure-hardened front door ------------------------------------
    def _validate_request(self, logical: LogicalQuery, roots,
                          op: str = "submit") -> list[int]:
        """Typed front-door validation, BEFORE tracing or dispatch: bad roots
        and non-positive depths raise :class:`InvalidRequestError` here
        instead of surfacing as opaque shape errors deep in a dispatch."""
        if logical.max_depth <= 0:
            raise InvalidRequestError(
                f"{op}: max_depth must be >= 1 (got {logical.max_depth})")
        arr = np.asarray(roots).reshape(-1)
        if arr.size == 0:
            return []
        if arr.dtype.kind not in "iu":
            raise InvalidRequestError(
                f"{op}: roots must be integers (got dtype {arr.dtype})")
        v = self.ds.num_vertices
        bad = arr[(arr < 0) | (arr >= v)]
        if bad.size:
            raise InvalidRequestError(
                f"{op}: root(s) {bad[:8].tolist()} out of range for a "
                f"graph with {v} vertices (valid: 0..{v - 1})")
        return [int(r) for r in arr]

    def _admit_request(self, logical: LogicalQuery, roots: Sequence[int]
                       ) -> Optional[List[GuardResult]]:
        """Run every root through the guard ladder; count + trace each
        decision; raise :class:`AdmissionError` on the first reject (after
        every decision is counted — the metrics see the whole batch)."""
        if not self.guards or not roots:
            return None
        decisions = admit_roots(self.ds, logical.direction, roots,
                                logical.max_depth,
                                self.calibrator.constants)
        reject = None
        for g in decisions:
            if g.decision == "traverse":
                self._m_admit_traverse.inc()
            elif g.decision == "degrade":
                self._m_admit_degrade.inc()
            else:
                self._m_admit_reject.inc()
                reject = reject if reject is not None else g
            if g.decision != "traverse":
                _trace.trace_event("admission", root=g.root,
                                   decision=g.decision,
                                   est_us=g.est_us,
                                   threshold_us=g.threshold_us,
                                   clamp_depth=g.clamp_depth)
        if reject is not None:
            raise AdmissionError(reject)
        return decisions

    @staticmethod
    def _admission_groups(logical: LogicalQuery,
                          decisions: Optional[List[GuardResult]],
                          n_roots: int):
        """Partition the request's lanes by admission outcome: one group
        for the as-planned roots, plus one per distinct degrade clamp
        depth (each with its OWN depth-clamped logical — a degraded answer
        is the same traversal cut at a shallower bound, so its rows are a
        prefix of the full answer)."""
        if decisions is None or all(g.decision == "traverse"
                                    for g in decisions):
            return [(logical, list(range(n_roots)), None)]
        groups = []
        full = [i for i, g in enumerate(decisions)
                if g.decision == "traverse"]
        if full:
            groups.append((logical, full, None))
        by_clamp: Dict[int, list] = {}
        for i, g in enumerate(decisions):
            if g.decision == "degrade":
                by_clamp.setdefault(int(g.clamp_depth), []).append(i)
        for clamp in sorted(by_clamp):
            groups.append((dataclasses.replace(logical, max_depth=clamp),
                           by_clamp[clamp], clamp))
        return groups

    @staticmethod
    def _degraded_result(template=None) -> BFSResult:
        """A classified EMPTY answer for a lane the budget refused to
        serve: zero rows, zero depth, no overflow.  Shaped like a sibling
        lane's dressed result when one exists (same columns and dtypes),
        otherwise a minimal zero-row result.  Like the served lanes, it
        lives on the host."""
        def cut(a):
            return a[:0] if a.dim() else torch.zeros((), dtype=a.dtype)
        if template is not None:
            return BFSResult(*(
                None if f is None else
                {k: cut(v) for k, v in f.items()} if isinstance(f, dict)
                else cut(f) for f in template))
        z = torch.zeros((), dtype=torch.int32)
        return BFSResult(values={},
                         positions=torch.zeros(0, dtype=torch.int32),
                         count=z, depth=z.clone(),
                         overflow=torch.zeros((), dtype=torch.bool),
                         row_depths=torch.zeros(0, dtype=torch.int32))

    def _note_dispatch_report(self, rep: DispatchReport,
                              report: RequestReport, roots: Sequence[int],
                              lanes: Sequence[int]) -> None:
        """Fold one group dispatch's :class:`DispatchReport` into the
        request-level report + metrics, with the once-per-session warning
        that makes deadline degradation observable (satellite of the
        silent-block hazard: a skipped or straggling bucket must never be
        inferable only from the latency histogram)."""
        report.retries += rep.retries
        report.evictions += rep.evictions
        report.skipped_buckets += len(rep.skipped_buckets)
        report.straggler_buckets += len(rep.straggler_buckets)
        for idx in rep.denied_lanes:
            report.denied_roots.append(int(roots[lanes[idx]]))
        if rep.denied_lanes:
            self._m_retry_denied.inc(len(rep.denied_lanes))
        n_skip = len(rep.skipped_buckets)
        if n_skip:
            self._m_deadline_skipped.inc(n_skip)
        if (n_skip or rep.straggler_buckets) and not self._warned_deadline:
            # the silent-block fix: a deadline that drops work or a bucket
            # that straggles past its predicted wall time must be LOUD the
            # first time, not just a counter nobody reads
            self._warned_deadline = True
            what = []
            if n_skip:
                what.append(f"{n_skip} bucket(s) skipped by the deadline "
                            "budget (the affected answers are explicitly "
                            "truncated)")
            if rep.straggler_buckets:
                what.append(f"{len(rep.straggler_buckets)} bucket(s) "
                            "straggled past their predicted wall time")
            warnings.warn(
                "; ".join(what) + " — see session.last_report "
                "(repro_deadline_skipped_buckets_total counts every "
                "skip; warned once per session)",
                RuntimeWarning, stacklevel=3)

    def submit(self, sql: str, roots: Sequence[int],
               *, check_overflow: bool = True,
               deadline_us: Optional[float] = None) -> list[BFSResult]:
        """Answer one batched traversal request: per-root results in
        request order (one bucketed dispatch per reach class, each bucket
        running ITS OWN chosen engine with right-sized caps).

        The front door validates first (typed errors before any dispatch),
        then runs every root through the admission guard ladder: rejected
        roots raise :class:`AdmissionError`; degraded roots are served a
        depth-clamped PREFIX of their traversal (classified on
        ``session.last_report``).  ``deadline_us`` bounds the request's
        dispatch wall time: buckets that no longer fit the remaining
        budget are skipped and their lanes answered with explicit empty
        results — ``last_report.truncated`` says so, nothing blocks
        silently.

        Warm requests (an entry already served in this process) are
        timed per bucket and fed to the calibrator; every
        ``calibrate_every`` observations the cost constants are refit, and
        subsequent planning passes price with the refit values.  With a
        session ``tracer`` (or a process-global one) the request is traced:
        ``request`` > ``parse``/``plan``/``compile`` spans here,
        ``stats``/``dispatch``/``transfer`` spans and per-level events
        downstream."""
        logical = self._logical_for(sql)
        roots = self._validate_request(logical, roots)
        prev_tracer = (_trace.set_tracer(self.tracer)
                       if self.tracer is not None else None)
        try:
            return self._submit_traced(sql, logical, roots, check_overflow,
                                       deadline_us)
        finally:
            if self.tracer is not None:
                _trace.set_tracer(prev_tracer)

    def _submit_traced(self, sql: str, logical: LogicalQuery,
                       roots: list[int], check_overflow: bool,
                       deadline_us: Optional[float]) -> list[BFSResult]:
        self.requests += 1
        self._m_requests.inc()
        hits0, misses0 = self.plan_hits, self.plan_misses
        report = RequestReport()
        self.last_report = report
        out: list = [None] * len(roots)
        last_entry = None
        with _trace.trace_span("request", requests=self.requests) as rattrs:
            with _trace.trace_span("parse"):
                logical = self._logical_for(sql)
            decisions = self._admit_request(logical, roots)
            report.admission = decisions
            groups = self._admission_groups(logical, decisions, len(roots))
            t0 = time.perf_counter()
            warm_all = True
            progress = False        # at least one group actually dispatched
            for glogical, lanes, clamp in groups:
                sub_roots = [roots[i] for i in lanes]
                with _trace.trace_span("plan"):
                    entry = self._entry_for(glogical, sub_roots)
                last_entry = entry
                if decisions is not None:
                    entry.plan_json["admission"] = {
                        "decisions": [g.to_json() for g in decisions],
                        "degrade_us":
                            self.calibrator.constants.guard_degrade_us,
                        "reject_us":
                            self.calibrator.constants.guard_reject_us}
                remaining = None
                if deadline_us is not None:
                    spent = (time.perf_counter() - t0) * 1e6
                    remaining = max(deadline_us - spent, 0.0)
                    if remaining <= 0.0 and progress:
                        # the budget died before this group launched
                        # anything: answer its lanes with classified
                        # empties (the FIRST group always runs — a
                        # request makes progress, the budget only stops
                        # further work)
                        for i in lanes:
                            out[i] = self._degraded_result()
                            report.skipped_roots.append(roots[i])
                        report.skipped_buckets += len(entry.buckets)
                        self._m_deadline_skipped.inc(len(entry.buckets))
                        continue
                if clamp is not None:
                    # a guard-degraded re-dispatch spends the SAME bounded
                    # retry budget as overflow retries; an exhausted budget
                    # degrades further, to the empty classified answer
                    if not self.retry_policy.spend():
                        self._m_retry_denied.inc(len(lanes))
                        for i in lanes:
                            out[i] = self._degraded_result()
                            report.denied_roots.append(roots[i])
                        continue
                    report.degraded_roots.extend(
                        (roots[i], clamp) for i in lanes)
                progress = True
                warm = entry.served > 0  # first-use costs paid here
                warm_all = warm_all and warm
                if warm:
                    sub_out, rep = self._execute(
                        entry, check_overflow, observe=True,
                        deadline_us=remaining)
                else:
                    # first serve of this entry in this process: the span
                    # (named as in the reference) makes the first-use costs
                    # visible — the kernels' first load, the caching
                    # allocator's first blocks, library handles
                    with _trace.trace_span("compile",
                                           engine=entry.choice.label):
                        sub_out, rep = self._execute(
                            entry, check_overflow, observe=False,
                            deadline_us=remaining)
                self._note_dispatch_report(rep, report, roots, lanes)
                template = next((r for r in sub_out
                                 if r is not SKIPPED), None)
                for pos, i in enumerate(lanes):
                    r = sub_out[pos]
                    if r is SKIPPED:
                        report.skipped_roots.append(roots[i])
                        r = self._degraded_result(template)
                    out[i] = r
                entry.served += 1
            rattrs["warm"] = warm_all
            self.last_latency_us = (time.perf_counter() - t0) * 1e6
            rattrs["latency_us"] = self.last_latency_us
            if report.truncated:
                rattrs["truncated"] = True
        self._m_latency.observe(self.last_latency_us)
        self._m_roots.inc(len(out))
        self._m_hits.inc(self.plan_hits - hits0)
        self._m_misses.inc(self.plan_misses - misses0)
        if last_entry is not None:
            last_entry.last_latency_us = self.last_latency_us
        if (self.calibrate_every > 0
                and self.calibrator.count - self._last_refit_count
                >= self.calibrate_every):
            self.calibrator.refit()
            self._last_refit_count = self.calibrator.count
        return out

    # -- request coalescing -------------------------------------------------
    def enqueue(self, sql: str, root: int) -> PendingResult:
        """Queue ONE single-root request for coalesced dispatch and return
        its ticket immediately (nothing executes).  Requests on the same
        (graph, query shape, direction) — the session is one graph; the
        shape key carries the direction — are grouped, and the next
        :meth:`flush` answers each group with ONE batched dispatch instead
        of one dispatch per request; the per-root results scatter back to
        the tickets in enqueue order.  Because the grouped batch flows
        through the reach-bucketed path with per-bucket lane counts, its
        multi-lane buckets plan (and almost always pick) the bit-parallel
        ``multiquery`` engine: up to :data:`~repro_torch.core.engine.
        WORD_LANES`
        queued roots ride the bits of one frontier word.

        The front door applies here too: invalid roots raise
        :class:`InvalidRequestError` NOW (not at flush), a batch already
        holding :data:`~repro_torch.core.engine.WORD_LANES` pending roots for
        this shape refuses the next one (a coalesced word has 32 lanes —
        callers flush and re-enqueue), and a root the guard ladder would
        REJECT raises :class:`AdmissionError` immediately (degrade
        decisions are applied at flush, by ``submit``)."""
        logical = self._logical_for(sql)
        [root] = self._validate_request(logical, [root], op="enqueue")
        key = shape_key(logical)
        if len(self._pending.get(key, ())) >= WORD_LANES:
            raise InvalidRequestError(
                f"enqueue: this query shape already has {WORD_LANES} "
                "pending roots (one coalesced word) — call flush() "
                "before enqueueing more")
        if self.guards:
            decision = admit_roots(self.ds, logical.direction, [root],
                                   logical.max_depth,
                                   self.calibrator.constants)[0]
            if decision.decision == "reject":
                self._m_admit_reject.inc()
                _trace.trace_event("admission", root=decision.root,
                                   decision="reject",
                                   est_us=decision.est_us,
                                   threshold_us=decision.threshold_us)
                raise AdmissionError(decision)
        ticket = PendingResult()
        self._pending.setdefault(key, []).append(
            (sql, int(root), ticket))
        return ticket

    def flush(self, *, check_overflow: bool = True) -> int:
        """Dispatch every pending shape group as one coalesced batched
        request and fill the tickets; returns the number of dispatches
        (groups).  A group's requests may come from textually different SQL
        (only the shape matters — any member's text plans identically), and
        duplicate roots are fine: each ticket gets its own lane's result."""
        pending, self._pending = self._pending, {}
        dispatches = 0
        for _, items in sorted(pending.items(), key=lambda kv: repr(kv[0])):
            sql = items[0][0]
            roots = [r for _, r, _ in items]
            out = self.submit(sql, roots, check_overflow=check_overflow)
            for (_, _, ticket), r in zip(items, out):
                ticket._fill(r)
            dispatches += 1
            self._m_coalesced.inc()
            self._m_coalesced_roots.inc(len(items))
        return dispatches

    def plan_for(self, sql: str, roots: Sequence[int]) -> PlanEntry:
        """The cached plan entry this session would serve ``roots`` with
        (plans/caches on first use; does not execute)."""
        return self._entry_for(self._logical_for(sql), roots)

    def plan_json(self, sql: str, roots: Sequence[int]) -> dict:
        """The machine-readable plan this session would serve ``roots``
        with (cached; does not execute)."""
        return self.plan_for(sql, roots).plan_json

    # -- the feedback loops -----------------------------------------------
    def recalibrate(self) -> None:
        """Force a refit and RE-RANK: the choice / bucket-choice / plan
        caches are dropped so the next request prices every candidate with
        the refit constants (the logical cache and the request memo keep
        their parse work)."""
        self.calibrator.refit()
        self._last_refit_count = self.calibrator.count
        self._choice.clear()
        self._bucket_plans.clear()
        self._plans.clear()
        self._requests.clear()

    def save_plan_store(self, path: Optional[str] = None) -> str:
        """Persist every cache grain + calibration state to ``path`` (or
        the ``plan_store`` path the session was constructed with)."""
        from .plan_store import save_session
        path = path if path is not None else self.plan_store_path
        if path is None:
            raise ValueError("no plan-store path: pass one here or to "
                             "ServingSession(plan_store=...)")
        return save_session(self, path)

    @property
    def stats(self) -> dict:
        """One-shot session counters — every historical key plus the
        histogram-backed latency quantiles and cache hit-rate ratios
        (``last_latency_us`` stays, as an alias for the newest request's
        latency; ``latency_us_p50/p95/p99`` summarize the whole session)."""
        lat = self._m_latency.snapshot()
        lookups = self.plan_hits + self.plan_misses
        return {
            "requests": self.requests,
            "plan_hits": self.plan_hits,
            "plan_misses": self.plan_misses,
            "plan_hit_rate": (self.plan_hits / lookups) if lookups else 0.0,
            "cached_shapes": len(self._choice),
            "cached_plans": len(self._plans),
            "last_latency_us": self.last_latency_us,
            "latency_us_p50": lat["p50"],
            "latency_us_p95": lat["p95"],
            "latency_us_p99": lat["p99"],
            "overflow_retries": int(self._m_retries.value),
            "overflow_lane_evictions": int(self._m_lane_evictions.value),
            "admission_traverse": int(self._m_admit_traverse.value),
            "admission_degrade": int(self._m_admit_degrade.value),
            "admission_reject": int(self._m_admit_reject.value),
            "deadline_skipped_buckets": int(
                self._m_deadline_skipped.value),
            "retry_denied": int(self._m_retry_denied.value),
            "retry_budget_spent": self.retry_policy.spent,
            "coalesced_dispatches": int(self._m_coalesced.value),
            "coalesced_roots": int(self._m_coalesced_roots.value),
            "pending_requests": sum(len(v)
                                    for v in self._pending.values()),
            "parse_calls": self.counters["parse_calls"],
            "stats_calls": self.counters["stats_calls"],
            "cost_calls": self.counters["cost_calls"],
            "calibration_observations": self.calibrator.count,
            "calibration_refits": self.calibrator.refits,
            "calibration_refits_rejected": self.calibrator.rejected_refits,
        }

    # -- observability ------------------------------------------------------
    def metrics(self) -> dict:
        """Snapshot of the serving metrics registry: counters, gauges and
        latency-histogram summaries (p50/p95/p99), keyed by metric name.
        Calibrator refit outcomes are mirrored in as gauges so one snapshot
        covers the whole feedback loop."""
        self._sync_gauges()
        return self._metrics.to_dict()

    def metrics_text(self) -> str:
        """The registry rendered in Prometheus text exposition format
        (``# HELP``/``# TYPE`` + samples; histograms as cumulative
        ``_bucket{le=...}`` series) — scrape-ready for ``launch/serve.py
        --metrics``."""
        self._sync_gauges()
        return self._metrics.render_text()

    def _sync_gauges(self) -> None:
        g = self._metrics.gauge
        g("repro_plan_cache_entries",
          "Distinct cached bucket plans").set(len(self._plans))
        g("repro_calibration_observations_total",
          "Calibrator observations accepted").set(self.calibrator.count)
        g("repro_calibration_refits_total",
          "Calibrator refits accepted").set(self.calibrator.refits)
        g("repro_calibration_refits_rejected_total",
          "Calibrator refits rejected by the holdout check").set(
              self.calibrator.rejected_refits)

    def explain_analyze(self, sql: str, roots: Sequence[int]) -> dict:
        """EXPLAIN ANALYZE through the serving path: submit the batch, then
        reconcile each root's ACTUAL rows / levels / push-pull directions
        against ITS bucket's plan (each bucket ran its own engine at its
        own caps).  Returns the schema-4 plan document with ``analyze`` set
        to the per-root reconciliations, grouped by bucket."""
        from .explain import analyze_result
        results = self.submit(sql, roots)
        entry = self._entry_for(self._logical_for(sql), roots)
        by_bucket = []
        for i, b in enumerate(entry.buckets):
            c = entry.bucket_choices[i]
            real = b.roots[:len(b.indices)]
            per_root = [
                analyze_result(c, entry.report, self.ds, results[idx],
                               root=int(r))
                for r, idx in zip(real, b.indices)]
            by_bucket.append({"bucket": i, "engine": c.label,
                              "caps": [c.query.caps.frontier,
                                       c.query.caps.result],
                              "roots": [int(r) for r in real],
                              "analyze": per_root})
        doc = dict(entry.plan_json)
        doc["analyze"] = {"mode": "serving", "buckets": by_bucket}
        return doc
