"""Query layer: the paper's recursive query dispatched onto its pipeline.

A ``RecursiveQuery`` describes the SQL of §5.1: which payload columns
exist, which engine executes it and the traversal ``direction``.  A
``Dataset`` holds the column table and the CSR join index on one device.
A query's ``workload`` is ``reach`` (boolean BFS) or a value semiring of
:mod:`repro_torch.core.semiring`, which runs on ``precursive`` and
``bitmap`` with the edge weights of ``weight_col``.  :func:`run_query`
answers one root through the single fixed-point driver; on a CUDA dataset
it plugs the hand-written kernels in: ``frontier_expand`` into every
positional IndexJoin, ``frontier_pull`` into every pull step and
``spmm_segment`` into the dense (sum, ×) combine, as the reference's
planner does for its kernel candidates.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises where CUDA is unavailable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Optional

import torch

from ..kernels.frontier_expand.ops import frontier_expand_fused
from ..kernels.frontier_pull.ops import frontier_pull_fused
from ..kernels.spmm_segment.ops import spmm_segment_sorted
from .bitmap import (bitmap_plan, diropt_hybrid_plan, diropt_plan,
                     hybrid_plan, weighted_bitmap_plan)
from .csr import CSRIndex, build_csr, merged_indptr
from .operators import (DIRECTIONS, BFSResult, Context, EngineCaps, Pipeline,
                        execute)
from .recursive import precursive_plan, weighted_precursive_plan
from .semiring import WORKLOADS
from .table import ColumnTable, payload_names

__all__ = ["RecursiveQuery", "Dataset", "EngineCaps", "BFSResult",
           "ENGINE_NAMES", "DIROPT_ENGINE_NAMES", "PUSH_COUNTERPART",
           "WEIGHTED_ENGINE_NAMES", "build_plan", "query_context",
           "run_query", "resolve_device"]

Direction = Literal["outbound", "inbound", "both"]

# the engines the port runs, in the reference's ENGINE_NAMES order
ENGINE_NAMES: tuple[str, ...] = ("precursive", "bitmap", "hybrid", "diropt",
                                 "diropt_hybrid")

# the direction-optimizing engines (per-level push/pull switch) and their
# push-only counterparts, which they equal row for row
DIROPT_ENGINE_NAMES: tuple[str, ...] = ("diropt", "diropt_hybrid")
PUSH_COUNTERPART = {"diropt": "bitmap", "diropt_hybrid": "hybrid"}

# the engines that carry the semiring value plane (as in the reference)
WEIGHTED_ENGINE_NAMES: tuple[str, ...] = ("precursive", "bitmap")

# engines of the reference that later slices of the port bring, by slice
_LATER_SLICES = {
    **dict.fromkeys(("trecursive", "rowstore", "rowstore_index",
                     "trecursive_rewrite", "rowstore_rewrite",
                     "rowstore_index_rewrite"),
                    "the paper's other engines"),
    "multiquery": "MS-BFS",
}


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

    @property
    def out_cols(self) -> tuple[str, ...]:
        return ("id", "from", "to", "name",
                *payload_names(self.payload_cols))


# plan builders: engine name -> (query, expand_fn, pull_fn) -> Pipeline
_PLAN_BUILDERS = {
    "precursive": lambda q, expand_fn, pull_fn: precursive_plan(
        q.caps, q.max_depth, q.out_cols, q.dedup, q.direction,
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
}


def build_plan(q: RecursiveQuery, expand_fn=None, pull_fn=None,
               spmm_fn=None) -> Pipeline:
    """The engine's pipeline; ``expand_fn`` plugs a kernel into its
    positional IndexJoins, ``pull_fn`` into its pull steps and ``spmm_fn``
    into the dense weighted (sum, ×) combine."""
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
        if q.engine in _LATER_SLICES:
            raise ValueError(
                f"engine {q.engine!r} is not ported yet: it comes with the "
                f"ROADMAP slice '{_LATER_SLICES[q.engine]}'")
        raise ValueError(f"unknown engine {q.engine!r}; known: "
                         f"{ENGINE_NAMES}")
    return _PLAN_BUILDERS[q.engine](q, expand_fn, pull_fn)


@dataclasses.dataclass(frozen=True)
class Dataset:
    """A prepared graph on one device: the column table + the join index.

    Direction views are built on first use and cached on the instance.  The
    reverse CSR (over ``to``) serves ``inbound``, the pull steps of an
    outbound query, and the fused ``both`` view, which adds only one merged
    (V+1) indptr on top of it."""

    table: ColumnTable
    csr: CSRIndex
    num_vertices: int
    rows: None = None                      # the row table's slice comes later
    rcsr: CSRIndex | None = None           # reverse CSR (over `to`)
    both_indptr: torch.Tensor | None = None  # (V+1,) merged out+in indptr
    weights: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)  # weight columns
    #   cast to float32, built on first use

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

    def context(self, direction: str = "outbound",
                weight_col: Optional[str] = None) -> Context:
        """The direction-resolved join view the operators run against;
        ``weight_col`` attaches the edge-weight column (weighted
        workloads)."""
        self.ensure_direction(direction)
        frm, to = self.table.column("from"), self.table.column("to")
        w = self.edge_weights(weight_col) if weight_col is not None else None
        if direction == "inbound":
            return Context(table=self.table, csr=self.rcsr, join_src=to,
                           join_dst=frm, rcsr=self.csr, edge_weights=w)
        if direction == "both":
            return Context(table=self.table, csr=self.csr, join_src=frm,
                           join_dst=to, rcsr=self.rcsr,
                           both_indptr=self.both_indptr, bidir=True,
                           edge_weights=w)
        return Context(table=self.table, csr=self.csr, join_src=frm,
                       join_dst=to, rcsr=self.rcsr, edge_weights=w)


def query_context(q: RecursiveQuery, ds: Dataset) -> Context:
    """The join view a query runs against: direction-resolved, with the
    edge-weight column attached for weighted workloads."""
    wc = q.weight_col if q.workload != "reach" else None
    return ds.context(q.direction, weight_col=wc)


def run_query(q: RecursiveQuery, ds: Dataset, root: int) -> BFSResult:
    """Execute one query through the fixed-point driver.  On a CUDA dataset
    the hand-written kernels run in place of their plain versions:
    ``frontier_expand`` in every positional IndexJoin, ``frontier_pull`` in
    every pull step, for which the reverse CSR is built first (once per
    dataset), and ``spmm_segment`` in the dense (sum, ×) combine.  The
    result is bit-identical to the plain run, except that a (sum, ×) or
    (mul, ×) vertex value that combines several arrivals may differ in its
    last bits (summation order)."""
    if ds.device.type != "cuda":
        return execute(build_plan(q), query_context(q, ds), root,
                       ds.num_vertices)
    if q.engine in DIROPT_ENGINE_NAMES:
        ds.ensure_reverse()
    plan = build_plan(q, expand_fn=frontier_expand_fused,
                      pull_fn=frontier_pull_fused,
                      spmm_fn=spmm_segment_sorted)
    return execute(plan, query_context(q, ds), root, ds.num_vertices)
