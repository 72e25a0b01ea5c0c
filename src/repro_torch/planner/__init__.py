"""Recursive-query planner: logical ``WITH RECURSIVE`` frontend, graph
statistics, and cost-based engine selection over the operator algebra.

The layers (one module each):

* :mod:`repro_torch.planner.ast`      — the logical query: a tiny AST + a
  parser for a minimal SQL dialect (§5.1 Listings 1.1–1.3 all parse);
* :mod:`repro_torch.planner.stats`    — per-``Dataset`` degree histograms
  and sampled frontier-growth profiles, computed on the host and cached on
  the Dataset;
* :mod:`repro_torch.planner.cost`     — prices a candidate pipeline by
  walking its ACTUAL operator composition and summing per-operator
  estimates;
* :mod:`repro_torch.planner.optimize` — enumerates every legal engine (plus
  the ``frontier_expand`` kernel expansion), ranks, and executes the winner
  through ``run_query`` / ``run_query_batch`` / ``run_query_multi`` /
  ``run_query_buckets``, on the card with the hand-written kernels;
* :mod:`repro_torch.planner.guards`   — the admission guard ladder pricing
  every root's predicted cost before dispatch (traverse / degrade /
  reject);
* :mod:`repro_torch.planner.explain`  — EXPLAIN with per-operator
  estimated rows and bytes for every candidate, the machine-readable plan
  (:func:`to_json`, ``schema_version`` 6), and EXPLAIN ANALYZE
  (:func:`explain_analyze`: execute, then reconcile predicted vs. actual
  per-operator rows/bytes and per-level push/pull directions);
* :mod:`repro_torch.planner.serving`  — the plan-cached, reach-bucketed
  serving session (one graph, many root batches), on the card with the
  hand-written kernels;
* :mod:`repro_torch.planner.calibrate` — the feedback loop: measured
  latencies refit the :class:`CostConstants`, and the kernel factors are
  MEASURED on the dataset's device;
* :mod:`repro_torch.planner.plan_store` — persist the plan + calibration
  caches across processes (the reference's JSON format: a store crosses
  between the two packages in both directions).

Entry points: :func:`plan_and_run` (also re-exported as
``repro_torch.core.engine.plan_and_run``), :func:`plan`, :func:`choose`,
:func:`explain`, :class:`ServingSession`.
"""
from .ast import (LogicalQuery, ParseError, RecursiveCTE,      # noqa: F401
                  normalize, paper_listing, parse, weighted_listing)
from .calibrate import (Calibrator, Observation,               # noqa: F401
                        measured_kernel_factor, plan_signature,
                        stats_digest)
from .cost import (CostConstants, DEFAULT_CONSTANTS,           # noqa: F401
                   OpEstimate, PlanCost, estimate_us, pipeline_cost)
from .explain import (analyze_result, explain,                 # noqa: F401
                      explain_analyze, explain_json,
                      render_analyze, render_report, to_json)
from .optimize import (KERNEL_LABEL, PhysicalChoice,           # noqa: F401
                       PlannerReport, RootBucket, bucket_roots,
                       choose, default_caps, kernel_expand_fn, plan,
                       plan_and_run)
from .guards import (AdmissionError, GuardResult,              # noqa: F401
                     InvalidRequestError, admit_roots, guard_cost_us)
from .serving import (PlanEntry, RequestReport,                # noqa: F401
                      ServingSession, shape_key)
from .plan_store import (graph_digest, load_store,             # noqa: F401
                         migrate_plan_doc, rehydrate_session,
                         save_session)
from .stats import (GraphStats, RootEstimate, compute_stats,   # noqa: F401
                    root_estimates)
