"""Admission guard ladder: classify every root BEFORE any dispatch.

The positional pipelines commit to caps and a plan before the traversal's
true reach is known — which is exactly what makes a naive serving front
door fragile: one adversarial root on a hub can blow past every cap while
well-behaved requests queue behind it.  The guard ladder closes that hole
with the planner's OWN estimates: each root's pre-dispatch reach prediction
(:func:`repro_torch.planner.stats.root_estimates` — exact for sampled roots,
degree-conditioned otherwise) is priced through the cost model's
:func:`~repro_torch.planner.cost.estimate_us` under the session's CURRENT
constants, and the predicted wall time is compared against two budgets
owned by :class:`~repro_torch.planner.cost.CostConstants`:

* ``predicted <= guard_degrade_us``  -> **traverse**: run as planned.
* ``predicted <= guard_reject_us``   -> **degrade**: depth-clamp the root
  to the deepest prefix whose predicted cost fits the degrade budget (a
  degraded answer is a depth-TRUNCATION of the full traversal — a prefix,
  never a different row set).
* otherwise                          -> **reject**: a typed
  :class:`AdmissionError` carrying the estimate that triggered it.

Because the price is computed under the calibrator-refit constants, a
machine measured slower admits fewer rows under the same budgets — the
ladder re-thresholds itself from measured dispatches without anyone
editing a row count.  Decisions are a pure function of
(estimate, constants, max_depth): deterministic for a fixed
(graph digest, constants) pair, and monotone — tightening either budget
can only move a root DOWN the ladder (traverse -> degrade -> reject),
never up.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

from .cost import CostConstants, estimate_us
from .stats import RootEstimate, root_estimates

__all__ = ["AdmissionError", "InvalidRequestError", "GuardResult",
           "guard_cost_us", "decide", "admit_roots", "GUARD_ROW_BYTES"]

# per-row byte proxy for the guard price: one 4-byte edge position plus the
# 4-byte depth column a positional result row materializes.  A coarse but
# DETERMINISTIC width — the guard ranks roots against a wall-time budget,
# not against each other, so the bandwidth constant absorbs the slack.
GUARD_ROW_BYTES = 8.0


class InvalidRequestError(ValueError):
    """A malformed front-door request (bad root, non-positive depth,
    oversized enqueue batch) — raised at ``submit``/``enqueue`` time,
    before any dispatch, instead of surfacing as an opaque shape error
    deep inside one."""


class GuardResult(NamedTuple):
    """One root's admission decision (see module docstring)."""

    decision: str               # 'traverse' | 'degrade' | 'reject'
    root: int
    estimate: RootEstimate      # the pre-dispatch prediction that decided
    est_us: float               # predicted full-depth wall time
    threshold_us: float         # the budget the decision was made against
    clamp_depth: Optional[int] = None   # degrade: admitted depth bound

    def to_json(self) -> dict:
        e = self.estimate
        return {"decision": self.decision, "root": int(self.root),
                "est_us": float(self.est_us),
                "threshold_us": float(self.threshold_us),
                "clamp_depth": self.clamp_depth,
                "estimate": {"reach_rows": float(e.reach_rows),
                             "max_level_rows": float(e.max_level_rows),
                             "depth": int(e.depth), "exact": bool(e.exact)}}


class AdmissionError(RuntimeError):
    """A root's predicted cost exceeded ``guard_reject_us`` — refused at
    the front door, before any dispatch.  Carries the triggering
    :class:`GuardResult` (and through it the :class:`RootEstimate`)."""

    def __init__(self, result: GuardResult):
        self.result = result
        e = result.estimate
        super().__init__(
            f"root {result.root} rejected by admission guard: predicted "
            f"{result.est_us:.0f}us (reach~{e.reach_rows:.0f} rows, "
            f"depth {e.depth}) exceeds guard_reject_us="
            f"{result.threshold_us:.0f}")


def guard_cost_us(est: RootEstimate, constants: CostConstants, *,
                  depth: Optional[int] = None,
                  row_bytes: float = GUARD_ROW_BYTES) -> float:
    """Price one root's predicted traversal at an (optionally clamped)
    depth.  Rows are scaled linearly with the admitted depth fraction — a
    monotone proxy that keeps the clamp search deterministic."""
    levels = max(int(est.depth), 1)
    d = levels if depth is None else max(min(int(depth), levels), 0)
    rows = est.reach_rows * (d / levels)
    return estimate_us(constants, plain_bytes=rows * row_bytes,
                       kernel_bytes=0.0, levels=d)


def decide(est: RootEstimate, constants: CostConstants, *, max_depth: int,
           row_bytes: float = GUARD_ROW_BYTES) -> GuardResult:
    """Run ONE root's estimate through the ladder.  Pure and monotone:
    lowering either budget can only escalate the decision."""
    degrade_us = float(constants.guard_degrade_us)
    reject_us = max(float(constants.guard_reject_us), degrade_us)
    full_us = guard_cost_us(est, constants, depth=min(est.depth, max_depth)
                            if est.depth else None, row_bytes=row_bytes)
    if full_us > reject_us:
        return GuardResult("reject", est.root, est, full_us, reject_us)
    if full_us <= degrade_us:
        return GuardResult("traverse", est.root, est, full_us, degrade_us)
    # degrade: the deepest prefix whose predicted cost fits the budget
    # (cost is monotone in depth, so scan down; floor at depth 1 — the
    # degraded answer stays a bounded prefix, never an empty refusal)
    clamp = 1
    for d in range(min(est.depth, max_depth), 0, -1):
        if guard_cost_us(est, constants, depth=d,
                         row_bytes=row_bytes) <= degrade_us:
            clamp = d
            break
    return GuardResult("degrade", est.root, est, full_us, degrade_us,
                       clamp_depth=clamp)


def admit_roots(ds, direction: str, roots: Sequence[int], max_depth: int,
                constants: CostConstants, *,
                row_bytes: float = GUARD_ROW_BYTES) -> list[GuardResult]:
    """Ladder a whole batch of roots (one O(1) degree lookup + a few float
    ops per root — cheap enough to run on EVERY request; the
    ``admission_overhead_ratio`` perf gate holds it to that)."""
    ests = root_estimates(ds, direction, roots, max_depth)
    return [decide(e, constants, max_depth=max_depth, row_bytes=row_bytes)
            for e in ests]
