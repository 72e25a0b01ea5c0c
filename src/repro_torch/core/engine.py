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
:func:`run_query_batch` many roots of a reach query at once (a leading
lane axis on every result field, :func:`result_lane` slices one out); on
a CUDA dataset both plug the hand-written kernels in: ``frontier_expand``
into every IndexJoin, ``frontier_pull`` into every pull step and
``spmm_segment`` into the dense (sum, ×) combine, as the reference's
planner does for its kernel candidates; ``late_gather`` runs in every
gather of the tables.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises where CUDA is unavailable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Optional

import torch

from ..kernels.frontier_expand.ops import frontier_expand_fused
from ..kernels.frontier_pull.layout import PullLayout, build_pull_layout
from ..kernels.frontier_pull.ops import frontier_pull_fused
from ..kernels.spmm_segment.ops import spmm_segment_sorted
from .bitmap import (bitmap_plan, diropt_hybrid_plan, diropt_plan,
                     hybrid_plan, weighted_bitmap_plan)
from .csr import CSRIndex, build_csr, merged_indptr
from .operators import (DIRECTIONS, BFSResult, Context, EngineCaps, Pipeline,
                        execute, execute_batch)
from .recursive import (precursive_plan, rowstore_plan,
                        rowstore_rewrite_plan, trecursive_plan,
                        trecursive_rewrite_plan, weighted_precursive_plan)
from .semiring import WORKLOADS
from .table import ColumnTable, RowTable, payload_names

__all__ = ["RecursiveQuery", "Dataset", "EngineCaps", "BFSResult",
           "ENGINE_NAMES", "DIROPT_ENGINE_NAMES", "PUSH_COUNTERPART",
           "WEIGHTED_ENGINE_NAMES", "VALUE_ENGINE_NAMES",
           "ROWSTORE_ENGINE_NAMES", "build_plan", "positions_available",
           "plan_repr", "query_context", "run_query", "run_query_batch",
           "result_lane", "resolve_device"]

Direction = Literal["outbound", "inbound", "both"]

# the reference's ENGINE_NAMES, in its order (MS-BFS stays out, as there)
ENGINE_NAMES: tuple[str, ...] = (
    "precursive", "trecursive", "rowstore", "rowstore_index", "bitmap",
    "hybrid", "trecursive_rewrite", "rowstore_rewrite",
    "rowstore_index_rewrite", "diropt", "diropt_hybrid")

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

# engines of the reference that later slices of the port bring, by slice
_LATER_SLICES = {"multiquery": "MS-BFS"}
# the batches these ROADMAP slices bring: weighted workloads, and the
# paper's tuple-based and row-store engines
_WEIGHTED_BATCH_SLICE = "batched roots, weighted"
_VALUE_BATCH_SLICE = "batched roots, the paper's other engines"


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
        if q.engine in _LATER_SLICES:
            raise ValueError(
                f"engine {q.engine!r} is not ported yet: it comes with the "
                f"ROADMAP slice '{_LATER_SLICES[q.engine]}'")
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


def run_query(q: RecursiveQuery, ds: Dataset, root: int) -> BFSResult:
    """Execute one query through the fixed-point driver.  On a CUDA dataset
    the hand-written kernels run in place of their plain versions:
    ``frontier_expand`` in every IndexJoin, ``frontier_pull`` in
    every pull step, for which the reverse CSR and the direction's pull
    layout are built first (once per dataset), and ``spmm_segment`` in the
    dense (sum, ×) combine.  The result is bit-identical to the plain run,
    except that a (sum, ×) or (mul, ×) vertex value that combines several
    arrivals may differ in its last bits (summation order)."""
    return execute(_device_plan(q, ds), query_context(q, ds), root,
                   ds.num_vertices)


def run_query_batch(q: RecursiveQuery, ds: Dataset, roots) -> BFSResult:
    """Execute one reach query for many roots at once: every field of the
    returned ``BFSResult`` gains a leading ``len(roots)`` lane axis, and
    lane i is bit-identical to ``run_query(q, ds, roots[i])``.  One
    fixed-point loop serves every lane, with one host read per level for
    all of them; on a CUDA dataset the same kernels as in
    :func:`run_query` run, one call per level for every lane that takes
    them.  A weighted query raises NotImplementedError (after the checks
    that :func:`run_query` makes), and so does a query on one of the
    paper's tuple-based or row-store engines (``VALUE_ENGINE_NAMES``)."""
    if q.workload != "reach" or q.engine in VALUE_ENGINE_NAMES:
        build_plan(q)
        what, slice_ = ((f"the weighted workload {q.workload!r}",
                         _WEIGHTED_BATCH_SLICE) if q.workload != "reach"
                        else (f"the engine {q.engine!r}", _VALUE_BATCH_SLICE))
        raise NotImplementedError(
            f"batched roots for {what} are not ported yet: they come with "
            f"the ROADMAP slice '{slice_}'; run one run_query per root")
    roots = torch.as_tensor(roots).reshape(-1).tolist()
    return execute_batch(_device_plan(q, ds), query_context(q, ds), roots,
                         ds.num_vertices)


def result_lane(r: BFSResult, lane: int) -> BFSResult:
    """Slice one lane out of a batched BFSResult."""
    return BFSResult(*(
        None if f is None else
        {k: v[lane] for k, v in f.items()} if isinstance(f, dict) else
        f[lane] for f in r))
