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
* :mod:`repro_torch.planner.calibrate` — the feedback loop: measured
  latencies refit the :class:`CostConstants`, and the kernel factors are
  MEASURED on the dataset's device.

Entry points: :func:`plan_and_run` (also re-exported as
``repro_torch.core.engine.plan_and_run``), :func:`plan`, :func:`choose`.
"""
from .ast import (LogicalQuery, ParseError, RecursiveCTE,      # noqa: F401
                  normalize, paper_listing, parse, weighted_listing)
from .calibrate import (Calibrator, Observation,               # noqa: F401
                        measured_kernel_factor, plan_signature,
                        stats_digest)
from .cost import (CostConstants, DEFAULT_CONSTANTS,           # noqa: F401
                   OpEstimate, PlanCost, estimate_us, pipeline_cost)
from .optimize import (KERNEL_LABEL, PhysicalChoice,           # noqa: F401
                       PlannerReport, RootBucket, bucket_roots,
                       choose, default_caps, kernel_expand_fn, plan,
                       plan_and_run)
from .guards import (AdmissionError, GuardResult,              # noqa: F401
                     InvalidRequestError, admit_roots, guard_cost_us)
from .stats import (GraphStats, RootEstimate, compute_stats,   # noqa: F401
                    root_estimates)
