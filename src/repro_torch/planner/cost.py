"""Cost model: price a candidate
:class:`~repro_torch.core.operators.Pipeline` against sampled graph
statistics.

The model walks the ACTUAL operator composition — the same objects the
fixed-point driver executes — and asks each operator for its per-level
estimate (:meth:`~repro_torch.core.operators.Operator.estimate`).  Per
level the planner supplies three measured cardinalities from the
frontier-growth samples (frontier rows in, dedup survivors, edge rows out)
plus the dataset's real column widths; the operator answers with rows and
bytes.  Costs therefore track the paper's analysis directly: tuple
pipelines pay (3+N) gathers per level, row pipelines pay full heap widths,
positional pipelines pay one column per level and one late gather, dense
pipelines pay O(E) per level regardless of frontier size.  One twist:
every block operator touches its whole fixed-capacity buffer, so per-level
byte estimates scale with the Volcano block CAPACITY, not the live row
count (this is what makes the dense bitmap engine win small graphs with
generous blocks, while positional wins once ``E`` dwarfs the block size).

Bytes are converted to an estimated wall time through a small set of
:class:`CostConstants` — an effective memory bandwidth, a fixed per-level
driver overhead, a per-query base, and the relative cost of a plugged
kernel — so that a 2-level query on a dense O(E) pipeline is not mistaken
for free.  The constants only break ties; the ranking currency is bytes.
:data:`DEFAULT_CONSTANTS` is the reference's hand-calibrated prior, kept
as it is so that a plan's price is the same number on every device;
:mod:`repro_torch.planner.calibrate` REFITS the constants online from
measured latencies, and the refit values flow back into
:func:`pipeline_cost` through the ``constants`` argument (this is why
:class:`PlanCost` keeps the factor-independent ``plain_bytes`` /
``kernel_bytes`` split: re-pricing a plan under new constants is
arithmetic, not a re-walk of the operator tree).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

from ..core.operators import CostEnv, Pipeline

from .stats import GraphStats

__all__ = ["CostConstants", "DEFAULT_CONSTANTS", "OpEstimate", "PlanCost",
           "pipeline_cost", "estimate_us", "column_bytes"]

# effective bandwidth (bytes/us) + fixed per-level and per-query overheads.
# Deliberately round numbers: they convert bytes into a human-readable
# microsecond scale and arbitrate between "more levels" and "more bytes";
# the byte counts themselves carry the ranking.  These are the PRIOR values
# (one CPU profile); the calibrator refits them from measured latencies.
BYTES_PER_US = 10_000.0
LEVEL_US = 25.0
BASE_US = 50.0


# direction-switch thresholds (Beamer's alpha/beta restated for the cost
# model's work terms): pull iff alpha * m_f > m_u and beta * n_f >= V
PULL_ALPHA = 1.0
PULL_BETA = 64.0


# admission guard-ladder thresholds (microsecond budgets): a root whose
# PRE-DISPATCH cost estimate (reach rows priced through estimate_us under
# the session's CURRENT constants) exceeds guard_degrade_us is depth-clamped
# to a bounded prefix; exceeding guard_reject_us raises a typed
# AdmissionError before any dispatch.  The budgets are wall-time, so a
# calibrator refit of bytes_per_us/level_us/base_us automatically
# re-thresholds admission in ROWS — a machine measured slower admits less.
GUARD_DEGRADE_US = 1e6    # one second of predicted traversal -> degrade
GUARD_REJECT_US = 1e7     # ten seconds predicted -> reject outright


class CostConstants(NamedTuple):
    """The cost model's time constants, refittable as one unit.

    ``kernel_factor`` is the relative byte cost of a hand-written kernel
    (``frontier_expand``, ``frontier_pull``, ``spmm_segment``) vs its
    plain version.  ``None`` means "not yet measured": the planner
    resolves it lazily through
    :func:`repro_torch.planner.calibrate.measured_kernel_factor` (a timed
    micro-benchmark on the dataset's device) the first time a kernel
    candidate is priced.

    ``pull_alpha``/``pull_beta`` own the direction-optimizing switch
    thresholds (:class:`repro_torch.core.operators.DirectionSwitch`): the
    planner stamps them onto every diropt pipeline it prices, so a
    calibrator refit that updates the constants re-thresholds the executed
    switch — the decision is priced and measured, not hard-coded.

    ``guard_degrade_us``/``guard_reject_us`` own the admission guard
    ladder (:mod:`repro_torch.planner.guards`): fixed microsecond budgets
    that a root's pre-dispatch cost estimate is compared against.  Because
    the estimate is priced through :func:`estimate_us` under the SAME
    constants the calibrator refits, a refit re-thresholds admission in
    rows without touching the budgets themselves (the refit preserves them
    via ``_replace``, like the pull thresholds)."""

    bytes_per_us: float = BYTES_PER_US
    level_us: float = LEVEL_US
    base_us: float = BASE_US
    kernel_factor: Optional[float] = None
    pull_alpha: float = PULL_ALPHA
    pull_beta: float = PULL_BETA
    guard_degrade_us: float = GUARD_DEGRADE_US
    guard_reject_us: float = GUARD_REJECT_US

    def to_json(self) -> dict:
        return {"bytes_per_us": self.bytes_per_us, "level_us": self.level_us,
                "base_us": self.base_us, "kernel_factor": self.kernel_factor,
                "pull_alpha": self.pull_alpha, "pull_beta": self.pull_beta,
                "guard_degrade_us": self.guard_degrade_us,
                "guard_reject_us": self.guard_reject_us}

    @classmethod
    def from_json(cls, doc: dict) -> "CostConstants":
        return cls(bytes_per_us=float(doc["bytes_per_us"]),
                   level_us=float(doc["level_us"]),
                   base_us=float(doc["base_us"]),
                   kernel_factor=(None if doc.get("kernel_factor") is None
                                  else float(doc["kernel_factor"])),
                   pull_alpha=float(doc.get("pull_alpha", PULL_ALPHA)),
                   pull_beta=float(doc.get("pull_beta", PULL_BETA)),
                   guard_degrade_us=float(doc.get("guard_degrade_us",
                                                  GUARD_DEGRADE_US)),
                   guard_reject_us=float(doc.get("guard_reject_us",
                                                 GUARD_REJECT_US)))


DEFAULT_CONSTANTS = CostConstants()


def estimate_us(constants: CostConstants, *, plain_bytes: float,
                kernel_bytes: float, levels: int) -> float:
    """The cost model's time formula over the factor-independent byte split:
    ``base + level_us * levels + (plain + kf * kernel) / bandwidth``.
    This is the single place bytes become microseconds — the optimizer, the
    calibrator's least-squares design matrix, and EXPLAIN all agree on it."""
    kf = constants.kernel_factor
    if kernel_bytes > 0.0 and kf is None:
        raise ValueError(
            "pricing a kernel-expansion pipeline needs a concrete "
            "kernel_factor; resolve it first (see "
            "repro_torch.planner.calibrate.measured_kernel_factor)")
    total = plain_bytes + (kf or 0.0) * kernel_bytes
    return (constants.base_us + constants.level_us * levels
            + total / constants.bytes_per_us)


class OpEstimate(NamedTuple):
    """One operator's totals across all executed levels."""

    label: str
    rows: float
    bytes: float


class PlanCost(NamedTuple):
    total_bytes: float
    est_us: float
    levels: int
    result_rows: float
    per_op: Tuple[OpEstimate, ...]     # seed, *loop ops, finisher
    # factor-independent byte split: total_bytes == plain_bytes +
    # kernel_factor * kernel_bytes.  The calibrator's design matrix and the
    # plan store re-price plans from these without re-walking the pipeline.
    plain_bytes: float = 0.0
    kernel_bytes: float = 0.0
    # a DirectionSwitch pipeline's PREDICTED per-level decision
    # ('push'/'pull'), one entry per priced level: the calibration
    # signature carries it so push-heavy and pull-heavy executions never
    # pool under one regression, and the plan store persists it
    level_dirs: Tuple[str, ...] = ()


def column_bytes(table) -> dict:
    """Per-row byte width of every column of a ColumnTable (+ the synthetic
    planner columns)."""
    widths = {name: table.width_bytes([name]) for name in table.names}
    widths["__next__"] = 4
    widths["depth"] = 4
    return widths


def _level_envs(pipeline: Pipeline, stats: GraphStats, *, row_bytes: int,
                col_bytes: dict, kernel_factor: float) -> list[CostEnv]:
    """One CostEnv per executed level, mirroring the driver's loop:

    * edge-seeded pipelines append the seed block (level 0) before the loop,
      then iteration ``i`` turns the level-``i`` frontier into level ``i+1``
      and runs while ``depth < max_depth`` and the frontier is non-empty;
    * the dense pipeline seeds a vertex bitmap and emits level ``i`` INSIDE
      iteration ``i`` (``inclusive`` loop bound).
    """
    md = pipeline.max_depth
    s = stats.level_edges
    n = stats.level_vertices

    def mk(f, u, m, seen):
        return CostEnv(frontier_rows=f, unique_rows=u, emitted_rows=m,
                       num_vertices=stats.num_vertices,
                       num_edges=stats.num_edges,
                       frontier_cap=pipeline.caps.frontier,
                       result_cap=pipeline.caps.result,
                       row_bytes=row_bytes, col_bytes=col_bytes,
                       kernel_factor=kernel_factor, visited_rows=seen)

    envs = []
    # vertices discovered before iteration i: the root + every earlier
    # level's new vertices (the pull-side work term)
    if pipeline.seed.kind == "dense":
        # frontier entering iteration i is the level-i vertex set
        limit = md + (1 if pipeline.inclusive else 0)
        seen = 1.0
        for i in range(limit):
            f = 1.0 if i == 0 else stats.vertices_at(i - 1)
            if f <= 0:
                break
            envs.append(mk(f, stats.vertices_at(i), stats.edges_at(i),
                           seen))
            seen += stats.vertices_at(i)
    else:
        seen = 1.0
        for i in range(md):
            f = stats.edges_at(i)
            if f <= 0:
                break
            envs.append(mk(f, stats.vertices_at(i), stats.edges_at(i + 1),
                           seen))
            seen += stats.vertices_at(i)
    return envs


def pipeline_cost(pipeline: Pipeline, stats: GraphStats, *, row_bytes: int,
                  col_bytes: dict,
                  constants: Optional[CostConstants] = None) -> PlanCost:
    """Estimate rows and bytes for every operator of ``pipeline`` and the
    total cost of running it to its fixed point.

    The per-operator byte estimates are linear in ``CostEnv.kernel_factor``
    (only a plugged expansion kernel scales with it), so two walks — one at
    factor 0, one at factor 1 — recover the factor-independent split
    ``plain_bytes + kernel_factor * kernel_bytes`` that the calibrator
    refits against and the plan store re-prices from."""
    consts = constants if constants is not None else DEFAULT_CONSTANTS
    envs = _level_envs(pipeline, stats, row_bytes=row_bytes,
                       col_bytes=col_bytes, kernel_factor=1.0)
    result_rows = stats.total_edges(pipeline.max_depth)
    all_ops = (pipeline.seed, *pipeline.ops, pipeline.finisher)
    # only a plugged kernel makes byte estimates factor-sensitive (the
    # expansion's or the pull's ``expand_fn``, the dense ⊕-combine's
    # ``spmm_fn``); everything else is priced in one walk
    has_kernel = any(getattr(op, "expand_fn", None) is not None
                     or getattr(op, "spmm_fn", None) is not None
                     for op in all_ops)

    def total_env(rows):
        return CostEnv(frontier_rows=rows, unique_rows=rows,
                       emitted_rows=rows, num_vertices=stats.num_vertices,
                       num_edges=stats.num_edges,
                       frontier_cap=pipeline.caps.frontier,
                       result_cap=pipeline.caps.result,
                       row_bytes=row_bytes, col_bytes=col_bytes,
                       kernel_factor=1.0, visited_rows=0.0)

    # (plain bytes at factor 0, unit kernel bytes = bytes@1 - bytes@0)
    def split(op, env) -> tuple[float, float, float]:
        at1 = op.estimate(env)
        if not has_kernel:
            return at1.rows, at1.bytes, 0.0
        at0 = op.estimate(env._replace(kernel_factor=0.0))
        return at1.rows, at0.bytes, at1.bytes - at0.bytes

    # the seed runs once, with the level-0 cardinalities
    seed_env = envs[0] if envs else total_env(stats.edges_at(0))
    rows, plain, kern = split(pipeline.seed, seed_env)
    per_op = [[pipeline.seed.describe(), rows, plain, kern]]

    for op in pipeline.ops:
        per_op.append([op.describe(), 0.0, 0.0, 0.0])
    for env in envs:
        for slot, op in zip(per_op[1:], pipeline.ops):
            rows, plain, kern = split(op, env)
            slot[1] += rows
            slot[2] += plain
            slot[3] += kern

    rows, plain, kern = split(pipeline.finisher, total_env(result_rows))
    per_op.append([pipeline.finisher.describe(), rows, plain, kern])

    plain_bytes = sum(slot[2] for slot in per_op)
    kernel_bytes = sum(slot[3] for slot in per_op)
    # a DirectionSwitch pipeline's predicted per-level decisions (the same
    # predicate the runtime switch evaluates, on the sampled profile)
    switch = next((op for op in pipeline.ops
                   if hasattr(op, "predict")), None)
    level_dirs = (tuple(switch.predict(env) for env in envs)
                  if switch is not None else ())
    # estimate_us is THE pricing formula (and the unresolved-kernel guard)
    est_us = estimate_us(consts, plain_bytes=plain_bytes,
                         kernel_bytes=kernel_bytes, levels=len(envs))
    kf = consts.kernel_factor or 0.0
    return PlanCost(
        total_bytes=plain_bytes + kf * kernel_bytes, est_us=est_us,
        levels=len(envs), result_rows=result_rows,
        per_op=tuple(OpEstimate(lbl, r, p + kf * k)
                     for lbl, r, p, k in per_op),
        plain_bytes=plain_bytes, kernel_bytes=kernel_bytes,
        level_dirs=level_dirs)
