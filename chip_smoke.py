"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. print the card's name and power limit; build the CUDA kernels with
   ``nvcc`` from ``src/repro_torch/csrc`` and time the build;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (exact equality; ``frontier_expand`` at root 0's
   widest level and at the seeded cases that split its tiles
   (``expand_case``: F beside the 2,048-target scan tile, a zero-degree
   run longer than a tile, a hub across output tiles, a total on an
   output tile edge, cuts, out-of-range valid targets, F = 1, F = 0,
   E = 0), its device launches per call and its kernels' times read
   from ``torch.profiler`` after phase 3's profile lines; ``late_gather``
   at the take of all 12 output columns at root 0's positions, at one
   column in each of float32, int32 and bfloat16 and at DeepFM's lookup,
   each also with negative positions mixed in; ``frontier_pull`` at
   ``diropt`` root 0's first pull level over the dataset's pull layout
   (``ms``) and building its own (``wrapper_ms``), at the inbound view's
   hub (vertex 0 unvisited, its only frontier in-neighbor last in its
   83,619-entry row) and at the shared ``PULL_CASES`` (``frontier_pull
   cases:``), with its device launches per call, no memset, and its
   kernels' times read from ``torch.profiler`` last (``frontier_pull
   profile:``); ``spmm_segment`` at root
   0's widest ``bitmap`` aggregate_sum level (exact), on two random graphs
   with in-degree > 1 (within rtol = atol = 1e-5), on the tree's inbound
   view, whose vertex 0 owns 83,619 edges, at D = 1 (d) and at
   GraphSAGE-Reddit's D = 128 (e) (within 1e-5 of each row's sum of
   absolute terms), and on the shared tile cases (``spmm_tile_case``:
   hubs beside the tile starts and the hub threshold, medium rows,
   dropped edges, E < P, E = 0, no row) at D = 1, 4, 17 and 128 (rows of
   at most 32 edges equal to the CPU run, the rest within 1e-5 of their
   absolute sums, two calls bit-equal), with its device launches per
   call and its kernels' times at (a) and (d) read from
   ``torch.profiler`` after phase 3's profile lines;
   ``embedding_bag`` at four shapes, the first the full DeepFM table with
   the serve_bulk batch's 39 positions per sample as bags (within 1e-5 of
   each bag's sum of absolute terms, and bit-equal to the plain version
   run on the CPU), with the layout ``bag_layout`` chose, and on the
   shared layout cases (``bag_layout_case``: every layout, bags of 0, 1,
   K - 1, K, K + 1, 39 and 3,000 entries, a table at a storage offset),
   weighted and not, under sum and mean (bit-equal to the CPU run, two
   calls bit-equal), with its device launches per call and its kernel's
   own time at the four shapes read from ``torch.profiler`` after phase
   3's profile lines; the lane axis of ``frontier_expand`` and
   ``frontier_pull`` (one call for the BATCH_ROOTS lanes of root 0's
   batch, at root 0's widest expansion level and at ``diropt`` root 0's
   first pull level, bit-equal to the plain version and to each lane's
   one-lane call, and every ``expand_lanes_case`` / ``pull_lanes_case``,
   a shared case stacked as four lanes), with its device launches per
   call and its kernels' times read last (``frontier_expand lanes:``,
   ``frontier_pull lanes:``); the lane axis of ``spmm_segment`` (the
   eight lanes of the outbound aggregate_sum batch at root 0's widest
   dense level, each lane's frontier bits its source mask, exact against
   the lane-axis plain version, each lane bit-equal to its one-lane call
   on its masked sources, one lane with its mask equal to that call; the
   same edges with seeded x on every vertex and eight seeded masks of
   density 0 to 1 (``seeded``), exact; and every tile case at D = 1 and
   17 as eight lanes, lane 1 masked off, against the plain version run on
   the CPU; ``spmm_segment lane cases:``, then ``spmm_segment lanes:``
   with its device launches per call, the 8 one-lane calls in a row and
   ``torch.sparse.mm`` of all lanes at once beside it); and time the kernel,
   the plain version and, where one exists, a single PyTorch library
   call;
3. drive three paths at full size on the repo's own deployment
   (``src/repro/configs/posdb_bfs.py``: 2^20-vertex tree of height 16,
   8 payload columns, depth 16, result cap 2^20, plus a float32 edge
   weight column ``w`` uniform in [0.5, 2)) with a per-level frontier cap
   of 2^18, through ``run_query``: PRecursive for 10 requests; the dense
   and direction-optimizing engines (``bitmap``, ``hybrid``, ``diropt``,
   ``diropt_hybrid``) for 4 requests each, and the two direction-
   optimizing plans with the switch forced to pull; the weighted
   ``precursive`` (11 requests) and ``bitmap`` (7) engines under the five
   value semirings.  Every result must equal the port's CPU run bit for
   bit (``vertex_values`` included), ``diropt`` must equal ``bitmap`` and
   ``diropt_hybrid`` ``hybrid`` row for row, root 0 must equal the BFS
   oracle (and, weighted, the path sums and products of the weights), and
   each path's kernel launch counters (zeroed just before the path, read
   just after) must show it went through its kernels; then DeepFM serving
   at the published Criteo width (``src/repro/configs/deepfm.py``:
   32,722,432-row table, embed_dim 10, MLP 400-400-400, random weights
   from a seed) for 8 serve_p99 requests (B = 512), one serve_bulk request
   (B = 262,144) and one retrieval request (1,000,000 candidates), against
   the port's CPU run (positions equal except bucket flips at a bucket
   boundary, which are counted; scores within rtol = atol = 2e-5, TF32
   off), and one ``embedding_bag`` call at the serve_bulk bags as its
   users call it; then batched roots through ``run_query_batch``: each
   engine outbound over BATCH_ROOTS = 8 roots (the PRecursive requests'
   outbound roots), PRecursive inbound and both ways over 8 roots with
   the deepest vertex among them, and PRecursive over a 32-root serving
   bucket, every lane bit-equal to the card's single-root run of its
   root and root 0's lane to the BFS oracle, each per-level kernel
   called once a level for all lanes (its launches equal the levels at
   which some lane calls it), one ``batch:`` line per call; warm
   latencies and ``torch.profiler`` lines follow (the forced-pull
   ``diropt`` root 0's, the ``bags`` call's and the 8-root
   ``precursive`` and ``diropt`` batches' among them);
4. the paper's tuple-based and row-store engines (``trecursive``,
   ``rowstore``, ``rowstore_index`` and the three Exp-3 rewrites) on the
   deployment's table without the weight column, root 0 outbound, and
   ``trecursive`` and
   ``trecursive_rewrite`` from the deepest vertex inbound and both ways,
   through ``run_query`` (the row table, 47 slots of 188 bytes a row, is
   built on the first row-store request): every result equal to the
   port's CPU run
   bit for bit, root 0's rows (their ids mapped back to positions where
   the recursion carried values) equal to the BFS oracle, and the path's
   launches equal to the CPU run's levels (``frontier_expand`` a level on
   the IndexJoin engines, ``late_gather`` a level and one for the seed
   block, one more for a rewrite's top-level join); a ``profile:`` line
   each; ``late_gather`` at the row table's shape (``late_gather rows
   case:``, ``take_rows`` at ``rowstore`` root 0's widest level, with
   ``index_select`` as the library call); then the paper's Exp 1-3
   (Fig. 5-7) at depth 16 from root 0, ``exp1:`` on the same tree with no
   payload column (rows of 7 slots, 28 bytes), ``exp2:`` and ``exp3:`` on
   that 8-payload table: each engine's root 0 checked against the BFS
   oracle, then its warm ms (median of 3), busy ms, launches and idle
   share (the paper path's, where it ran the request), and its speedup
   against ``rowstore`` (Exp 1-2) or
   ``rowstore_rewrite`` (Exp 3) in warm and busy ms; last, after every
   earlier profile line (its host and device memory stay out of their
   numbers), the weighted batches over the eight batch roots on the
   table with ``w`` (``precursive`` outbound under each semiring and
   shortest_path inbound and both ways, ``bitmap`` outbound under each
   semiring and shortest_path and aggregate_sum inbound) and the
   value-engine batches on the paper's table (each of the six outbound,
   ``trecursive`` and ``trecursive_rewrite`` inbound and both ways):
   every lane bit-equal to its single-root card run, root 0's lane to
   the BFS and path oracles, ``spmm_segment``, ``frontier_expand`` and
   ``late_gather`` called once a level for all lanes (``batch:`` lines
   with warm ms beside the roots one by one, peak MiB and the reckoned
   result buffers; two ``profile:`` lines), and a weighted
   ``run_query_buckets`` in two buckets of 4 (``weighted buckets:``);
   then, on the same table without the weight column: MS-BFS
   (``run_query_multi``) over the 32-root serving bucket outbound,
   inbound and both ways, every lane the same rows (positions,
   count, depth, overflow, row depths, every column) as lane i of the
   card's ``diropt`` batch over the same roots, root 0's lane equal to
   the BFS oracle, the outbound call equal to the port's CPU run on every
   field, ``late_gather`` launched once a call and no traversal kernel
   (one ``multiquery:`` line a direction, with warm ms, busy ms and
   launches beside the ``diropt`` batch's); per-lane depth caps
   (``multiquery depth caps:``, each capped lane equal to ``diropt`` at
   that depth); the bucket executor on one MS-BFS bucket at result cap
   2^12, fallback caps (2^18, 2^20), evicting exactly the lanes over the
   cap (``multiquery eviction:``, each evicted lane equal to ``diropt`` at
   the fallback caps, the others keeping their rows); and
   ``run_query_buckets`` of ``precursive`` over the 32 roots in four
   buckets of 8, every root bit-equal to its single-root card run
   (``buckets:``, beside one 32-root batch);
5. print one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line last.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.deepfm import CONFIG as DEEPFM  # noqa: E402
from repro_torch.convert import dataset_from_numpy  # noqa: E402
from repro_torch.core.bitmap import (diropt_hybrid_plan,  # noqa: E402
                                     diropt_plan)
from repro_torch.core.csr import build_csr, expand_frontier  # noqa: E402
from repro_torch.core.engine import (PUSH_COUNTERPART,  # noqa: E402
                                     VALUE_ENGINE_NAMES, EngineCaps,
                                     RecursiveQuery, build_plan,
                                     dispatch_buckets, lane_eviction_count,
                                     positions_available, result_lane,
                                     run_query, run_query_batch,
                                     run_query_buckets, run_query_multi)
from repro_torch.core.operators import execute  # noqa: E402
from repro_torch.data.recsys_stream import (recsys_batch,  # noqa: E402
                                            vocab_sizes)
from repro_torch.data.treegen import (TreeSpec, bfs_reference,  # noqa: E402
                                      make_edge_table)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import \
    fixed_hot_lookup  # noqa: E402
from repro_torch.kernels.embedding_bag.embedding_bag import \
    bag_layout  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    BAG_LAYOUT_CASES, bag_cases, bag_layout_case, embedding_bag_ref,
    layout_table)
from repro_torch.kernels.frontier_expand import ops as fe_ops  # noqa: E402
from repro_torch.kernels.frontier_expand.ref import (  # noqa: E402
    EXPAND_CASES, expand_case, expand_lanes_case)
from repro_torch.kernels.frontier_pull import ops as fp_ops  # noqa: E402
from repro_torch.kernels.frontier_pull import (  # noqa: E402
    PULL_CASES, build_pull_layout, frontier_pull_layout_ref,
    frontier_pull_ref, pull_case, pull_lanes_case)
from repro_torch.kernels.late_gather import ops as lg_ops  # noqa: E402
from repro_torch.kernels.late_gather.ref import \
    late_gather_columns_ref  # noqa: E402
from repro_torch.kernels.spmm_segment import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.spmm_segment.ref import (  # noqa: E402
    SPMM_CASES, spmm_segment_lanes_ref, spmm_segment_ref, spmm_tile_case)
from repro_torch.kernels.spmm_segment.spmm_segment import (  # noqa: E402
    SHORT_ROW, tile_plan)
from repro_torch.models import recsys  # noqa: E402

# the posdb-bfs deployment (src/repro/configs/posdb_bfs.py), on one card:
# frontier_cap is 2^18 instead of the config's per-shard 2^15, because the
# widest level of this tree emits 155,901 edges
SPEC = TreeSpec(num_vertices=1 << 20, height=16, payload_cols=8, seed=0)
MAX_DEPTH = 16
CAPS = EngineCaps(frontier=1 << 18, result=1 << 20)
ROOT_SEED = 1
DEVICE = "cuda"                # the card
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, float32 off the tensor
#                                cores
TIMING_REPS = 20
PROFILE_TRIES = 3              # sessions taken while one loses its events
DENSE_ENGINES = ("bitmap", "hybrid", "diropt", "diropt_hybrid")
FORCE_PULL = dict(alpha=1e9, beta=1e9)
SEMIRINGS = ("shortest_path", "aggregate_sum", "aggregate_max",
             "aggregate_min", "aggregate_mul")
WEIGHT_COL = "w"
SPMM_TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_semiring.py's
# of each bag's sum of absolute terms: the kernel sums a bag in sorted
# order, the plain version's index_add_ with atomics in no fixed order
BAG_TOL = 1e-5
# tests/test_models_gnn_recsys.py's tolerance between the reference's two
# DeepFM paths: sums over fields and the MLP's dot products run in another
# order on the card than on the CPU
DEEPFM_TOL = dict(rtol=2e-5, atol=2e-5)
# RECSYS_SHAPES of src/repro/configs/registry.py
P99_BATCH, P99_REQUESTS = 512, 8
BULK_BATCH = 262_144
N_CANDIDATES = 1_000_000
PARAM_SEED = 0
NEG_SEED = 4                 # the negative positions of late_gather's checks
BATCH_ROOTS = 8              # benchmarks/exp1_bfs.py's lockstep batch
BUCKET_ROOTS = 32            # one serving bucket of the reference's planner
TRAVERSAL_KERNELS = ("frontier_expand", "frontier_pull")
# the kernels a batch calls once a level for all lanes
LEVEL_KERNELS = TRAVERSAL_KERNELS + ("spmm_segment",)
SPMM_LANE_DIMS = (1, 17)       # the widths of the lane-axis tile cases
BATCH_ENGINES = ("precursive",) + DENSE_ENGINES   # the reach batches
# the engines whose plan has a CSRIndexJoin, so frontier_expand each level
INDEX_JOIN_ENGINES = ("precursive", "trecursive", "trecursive_rewrite",
                      "rowstore_index", "rowstore_index_rewrite")
# the paper's Exp 1-3 (benchmarks/exp1_bfs.py, exp2_payload.py and
# exp3_rewrite.py; Fig. 5-7): the engines, the payload columns of the
# table and the engine each speedup is read against.  Exp 1's table is
# the deployment's tree with no payload column.
EXPERIMENTS = (
    ("exp1", "Fig. 5", ("precursive", "trecursive", "rowstore",
                        "rowstore_index", "bitmap", "hybrid"), 0,
     "rowstore"),
    ("exp2", "Fig. 6", ("precursive", "trecursive", "rowstore"), 8,
     "rowstore"),
    ("exp3", "Fig. 7", ("precursive", "trecursive_rewrite",
                        "rowstore_rewrite", "rowstore_index_rewrite"), 8,
     "rowstore_rewrite"),
)


class Request(NamedTuple):
    engine: str
    direction: str
    root: int
    workload: str = "reach"

    def __str__(self) -> str:
        label = f"{self.engine} {self.direction} root {self.root}"
        return label if self.workload == "reach" else \
            f"{label} {self.workload}"


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over TIMING_REPS runs, CUDA events
    around each run, with the 50 MB L2 evicted before each (a 256 MB
    write), so each run finds its inputs in device memory as the main path
    does."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(TIMING_REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes: float, fp32_ops: float = 0.0) -> float:
    """The larger of the bytes over the memory rate and the float32
    operations over the card's float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, fp32_ops / FP32_OPS_PER_S) * 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# the requests and their checks
# ---------------------------------------------------------------------------

def make_requests(cols: dict, num_vertices: int) -> list[Request]:
    """PRecursive: root 0, three depth-1 vertices and four seeded random
    roots outbound; the deepest vertex inbound and both ways."""
    children = cols["to"][cols["from"] == 0][:3]
    out = [0, *children.tolist(), *random_roots(num_vertices)]
    last = num_vertices - 1
    return ([Request("precursive", "outbound", int(r)) for r in out]
            + [Request("precursive", "inbound", last),
               Request("precursive", "both", last)])


def random_roots(num_vertices: int) -> list[int]:
    return np.random.default_rng(ROOT_SEED).integers(
        0, num_vertices, 4).tolist()


def make_dense_requests(cols: dict, num_vertices: int) -> list[Request]:
    """Each dense engine: root 0 (the whole tree, both sides of the
    switch) and one depth-1 vertex outbound, the deepest vertex inbound
    and both ways."""
    child = int(cols["to"][cols["from"] == 0][0])
    last = num_vertices - 1
    return [Request(engine, direction, root) for engine in DENSE_ENGINES
            for direction, root in (("outbound", 0), ("outbound", child),
                                    ("inbound", last), ("both", last))]


def make_weighted_requests(num_vertices: int) -> list[Request]:
    """Weighted ``precursive``: root 0 outbound under each semiring,
    shortest path from the deepest vertex inbound and both ways and from
    the four random roots outbound.  Weighted ``bitmap``: root 0 outbound
    under each semiring, shortest path and aggregate_sum from the deepest
    vertex inbound.  The bitmap aggregate_sum requests run spmm_segment."""
    last = num_vertices - 1
    sp = "shortest_path"
    return ([Request("precursive", "outbound", 0, s) for s in SEMIRINGS]
            + [Request("precursive", "inbound", last, sp),
               Request("precursive", "both", last, sp)]
            + [Request("precursive", "outbound", r, sp)
               for r in random_roots(num_vertices)]
            + [Request("bitmap", "outbound", 0, s) for s in SEMIRINGS]
            + [Request("bitmap", "inbound", last, sp),
               Request("bitmap", "inbound", last, "aggregate_sum")])


def make_paper_requests(num_vertices: int) -> list[Request]:
    """Each of the paper's tuple-based and row-store engines from root 0
    outbound; the two tuple engines also from the deepest vertex inbound
    and both ways (the row store is outbound-only)."""
    last = num_vertices - 1
    return ([Request(engine, "outbound", 0) for engine in VALUE_ENGINE_NAMES]
            + [Request(engine, direction, last)
               for engine in ("trecursive", "trecursive_rewrite")
               for direction in ("inbound", "both")])


def query(engine: str, direction: str = "outbound",
          workload: str = "reach",
          payload_cols: int = SPEC.payload_cols) -> RecursiveQuery:
    return RecursiveQuery(engine, MAX_DEPTH, payload_cols, CAPS,
                          direction=direction, workload=workload,
                          weight_col=None if workload == "reach"
                          else WEIGHT_COL)


def run_request(ds, req: Request):
    return run_query(query(req.engine, req.direction, req.workload), ds,
                     req.root)


def run_requests(ds, requests) -> list:
    return [run_request(ds, req) for req in requests]


KERNEL_OPS = {"frontier_expand": fe_ops, "late_gather": lg_ops,
              "frontier_pull": fp_ops, "spmm_segment": spmm_ops,
              "embedding_bag": eb_ops}


def reset_launches() -> None:
    for ops in KERNEL_OPS.values():
        ops.LAUNCHES = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: ops.LAUNCHES for name, ops in KERNEL_OPS.items()}


def launch_levels(req: Request, r, num_vertices: int) -> dict:
    """The levels at which the card's run of one request calls each
    per-level kernel, read off a run's result: ``frontier_expand`` at
    every executed level of PRecursive (weighted or not) and of the tuple
    and row-store engines with an IndexJoin, and at each
    sparse (positional) push level of the hybrid engines,
    ``frontier_pull`` at each pull level, both only outside the fused
    ``both`` view (which has no kernel, as in the reference);
    ``spmm_segment`` at every executed level of a ``bitmap`` aggregate_sum
    request.  A hybrid level is sparse when its frontier block, the rows
    first emitted at that level, is below :func:`hybrid_threshold`."""
    engine, depth = req.engine, int(r.depth)
    out = {"frontier_expand": set(), "frontier_pull": set(),
           "spmm_segment": set()}
    if req.workload == "aggregate_sum" and engine == "bitmap":
        out["spmm_segment"] = set(range(depth))
    if req.direction == "both":
        return out
    if engine in INDEX_JOIN_ENGINES:
        out["frontier_expand"] = set(range(depth))
        return out
    dirs = (r.level_dirs.tolist() if r.level_dirs is not None
            else [0] * depth)
    widths = torch.bincount(r.row_depths[:int(r.count)].long(),
                            minlength=depth).tolist()
    for d in range(depth):
        if dirs[d] == 1:
            out["frontier_pull"].add(d)
        elif engine in ("hybrid", "diropt_hybrid") and \
                widths[d] < hybrid_threshold(engine, num_vertices):
            out["frontier_expand"].add(d)
    return out


def late_gathers(req: Request, r) -> int:
    """``late_gather`` launches of one request: one take of all its output
    columns; on the tuple and row-store engines one take a level and one
    for the seed block (``EarlyMaterialize``, up to 32 columns a launch),
    and one more for an Exp-3 rewrite's top-level join."""
    if req.engine not in VALUE_ENGINE_NAMES:
        return 1
    return int(r.depth) + 1 + req.engine.endswith("_rewrite")


def expected_launches(requests, results, num_vertices: int) -> dict:
    """The launches the card's run of ``requests`` must make, read off the
    CPU run's results: each per-level kernel once per level of
    :func:`launch_levels`; ``late_gather`` as :func:`late_gathers` says;
    ``embedding_bag`` never."""
    out = {"frontier_expand": 0,
           "late_gather": sum(late_gathers(req, r)
                              for req, r in zip(requests, results)),
           "frontier_pull": 0, "spmm_segment": 0, "embedding_bag": 0}
    for req, r in zip(requests, results):
        for kernel, levels in launch_levels(req, r, num_vertices).items():
            out[kernel] += len(levels)
    return out


def hybrid_threshold(engine: str, num_vertices: int) -> int:
    """The frontier size below which the engine's ``HybridStep`` (alone,
    or the push side of its ``DirectionSwitch``) takes its sparse branch,
    read off the plan ``run_query`` builds."""
    step = build_plan(query(engine)).ops[0]
    step = getattr(step, "push", step)
    return max(1, int(num_vertices * step.switch_frac))


def require_equal(a, b, label: str, other: str = "the CPU run") -> None:
    """Field-for-field, bit-for-bit equality of two BFSResults, compared
    on ``a``'s device."""
    for field in ("positions", "count", "depth", "overflow", "row_depths",
                  "level_dirs", "vertex_values"):
        x, y = getattr(a, field), getattr(b, field)
        if x is None or y is None:
            require(x is None and y is None, f"{label}: field {field}")
            continue
        y = y.to(x.device)
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"{label}: field {field} differs from {other}")
    require(a.values.keys() == b.values.keys(), f"{label}: value columns")
    for k in a.values:
        x = a.values[k]
        y = b.values[k].to(x.device)
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"{label}: column {k} differs from {other}")


def require_same_rows(a, b, label: str,
                      other: str = "the push-only engine") -> None:
    """The rows, their order and depths, and the loop accounting of two
    results (a direction-optimizing engine and its push-only twin, or an
    MS-BFS lane and ``diropt`` on its root)."""
    for field in ("positions", "count", "depth", "overflow", "row_depths"):
        require(torch.equal(getattr(a, field), getattr(b, field)),
                f"{label}: field {field} differs from {other}")
    require(a.values.keys() == b.values.keys(), f"{label}: value columns")
    for k in a.values:
        require(torch.equal(a.values[k], b.values[k]),
                f"{label}: column {k} differs from {other}")


def check_result_shape(r, caps: EngineCaps, label: str) -> None:
    require(r.positions.shape == (caps.result,), f"{label}: positions shape")
    for k, v in r.values.items():
        require(v.shape[0] == caps.result, f"{label}: column {k} shape")
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f"{label}: {k} not finite")


def real_positions(engine: str, r, id_to_pos: torch.Tensor
                   ) -> torch.Tensor:
    """The edge positions of a result's rows: its positions, or, where the
    engine's recursion carried values (positions all -1), the rows' ids
    (float32 on the row store, exact below 2^24) mapped back to positions
    through ``id_to_pos``, the inverse of the table's id column."""
    if positions_available(engine):
        return r.positions
    ids = r.values["id"].cpu().long().clamp(0, id_to_pos.shape[0] - 1)
    return id_to_pos[ids]


def check_root0(r, levels: list, spec: TreeSpec, label: str,
                positions: torch.Tensor | None = None) -> None:
    """Root 0 reaches the whole tree without overflow, level by level equal
    to the pure-Python BFS oracle's ``levels``; ``positions`` are the rows'
    edge positions (by default the result's)."""
    count = int(r.count)
    require(count == spec.num_edges,
            f"{label}: count {count} != {spec.num_edges}")
    require(not bool(r.overflow), f"{label} overflowed")
    positions = r.positions if positions is None else positions
    pos = positions[:count].cpu().numpy()
    depth = r.row_depths[:count].cpu().numpy()
    for d, want in enumerate(levels):
        require(set(pos[depth == d].tolist()) == want,
                f"{label}: level {d} differs from bfs_reference")
    require(int(depth.max()) + 1 == len([s for s in levels if s]),
            f"{label}: extra levels")


def widest_level(r0, cols: dict, capacity: int):
    """The targets of the widest level of root 0's traversal, in the
    frontier order the engine gives them (the previous level's rows in
    emission order), padded to ``capacity``: a real input of the
    expansion.  Returns (targets, valid, level, emitted) on the CPU."""
    count = int(r0.count)
    pos = r0.positions[:count].cpu().numpy()
    depth = r0.row_depths[:count].cpu().numpy()
    widths = np.bincount(depth)
    level = int(np.argmax(widths[1:])) + 1
    prev = cols["to"][pos[depth == level - 1]]
    targets = torch.full((capacity,), -1, dtype=torch.int32)
    targets[:prev.shape[0]] = torch.from_numpy(prev.astype(np.int32))
    valid = torch.arange(capacity) < prev.shape[0]
    return targets, valid, level, int(widths[level])


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions, at the main path's shapes
# ---------------------------------------------------------------------------

def device_events(prof) -> list:
    """The device-side entries (kernels, copies, fills) of a profiler
    session's ``key_averages()``."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def profiled(run, enough) -> list:
    """The device events of a ``torch.profiler`` session around ``run()``.
    The session records device activity only: the host ops are not read,
    and summing them costs the session most of its time.  On this card a
    session sometimes loses some or all of its device events (PERF.md §7)
    and never gains one, so a session is taken again, up to
    PROFILE_TRIES times, until ``enough(events)``; the fullest one is
    returned."""
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = device_events(prof)
        if best is None or sum(e.count for e in events) > \
                sum(e.count for e in best):
            best = events
        if enough(best):
            break
    return best


def device_profile(fn, flush, launches: int) -> tuple[int, dict]:
    """The device launches of one call of ``fn`` (sessions taken until one
    sees ``launches``, so a call that makes more still shows more), and
    the mean device time of each of its kernels, by the profiler's name,
    over TIMING_REPS calls with the L2 evicted before each, from
    ``torch.profiler``.  Run after the profile lines: an earlier profiler
    session changes their event counts."""
    fn()
    torch.cuda.synchronize()
    events = profiled(fn, lambda ev: sum(e.count for e in ev) >= launches)
    keys = {e.key for e in events}         # not the L2 flush's fill

    def reps():
        for _ in range(TIMING_REPS):
            flush.zero_()
            fn()

    timed = profiled(reps, lambda ev: keys <= {e.key for e in ev})
    return sum(e.count for e in events), {
        e.key: e.self_device_time_total / e.count / 1e3
        for e in timed if e.key in keys}


def kernel_times(by_key: dict, names, label: str) -> dict:
    """Each of ``names``' mean ms from :func:`device_profile`'s keys (one
    key each)."""
    found = {n: [ms for key, ms in by_key.items() if n in key]
             for n in names}
    require(all(len(ms) == 1 for ms in found.values()),
            f"{label}: the profiler's kernels {sorted(by_key)}")
    return {n: ms[0] for n, ms in found.items()}


def expand_profile(fn, flush) -> dict:
    """``frontier_expand``'s device launches per call (3) and the mean
    time of each of its kernels."""
    launches, by_key = device_profile(fn, flush, 3)
    require(launches == 3, f"frontier_expand: {launches} device launches "
            "in one call, want 3")
    by_kernel = kernel_times(by_key, ("frontier_degree_sums",
                                      "frontier_scan_ends",
                                      "frontier_expand_slots"),
                             "frontier_expand")
    return {"expand_only_ms": by_kernel["frontier_expand_slots"],
            "device_launches_per_call": launches,
            "device_ms_by_kernel": by_kernel}


SPMM_KERNELS = ("spmm_segment_rows", "spmm_segment_hub_fixup")


def spmm_profile(calls: dict, flush) -> dict:
    """``spmm_segment``'s device launches per call and the mean time of
    each of its two kernels at each case of ``calls`` (each has E > H, so
    both run)."""
    out = {}
    for case, fn in calls.items():
        launches, by_key = device_profile(fn, flush, 2)
        require(launches == 2, f"spmm_segment ({case}): {launches} device "
                "launches in one call, want 2")
        out[case] = {"device_launches_per_call": launches,
                     "device_ms_by_kernel": kernel_times(
                         by_key, SPMM_KERNELS, f"spmm_segment ({case})")}
    return out


def expand_cases_on_card() -> dict:
    """Each :func:`expand_case` on the card: the kernel route bit-equal to
    the plain version in all three outputs.  Returns each case's F,
    capacity, count and overflow."""
    cases = {}
    for case in EXPAND_CASES:
        src, v, targets, valid, capacity = expand_case(case)
        csr = build_csr(torch.from_numpy(src).to(DEVICE), v)
        t = torch.from_numpy(targets).to(DEVICE)
        m = torch.from_numpy(valid).to(DEVICE)
        got = fe_ops.frontier_expand_fused(csr, t, m, capacity)
        want = expand_frontier(csr, t, m, capacity)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("positions", "total", "overflow")):
            require(g.dtype == w.dtype and g.shape == w.shape
                    and torch.equal(g, w),
                    f"frontier_expand case {case}: {name} differs")
        cases[case] = {"F": targets.shape[0], "capacity": capacity,
                       "count": int(got[1]), "overflow": bool(got[2])}
    return cases


def frontier_expand_phase(ds, targets, valid, capacity, emitted, flush):
    """Root 0's widest level (the kernel line's entry) and the tile cases,
    each bit-equal to the plain version; then the wrapper's and the plain
    version's times at the widest level.  Returns the entry, the cases and
    the widest level's call, for :func:`expand_profile`."""
    csr = ds.csr
    t, v = targets.to(DEVICE), valid.to(DEVICE)
    got = fe_ops.frontier_expand_fused(csr, t, v, capacity)
    want = expand_frontier(csr, t, v, capacity)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("positions", "total", "overflow")):
        require(g.dtype == w.dtype and torch.equal(g, w),
                f"frontier_expand: {name} differs")
    require(int(got[1]) == emitted, "frontier_expand: level total")
    err = max_abs_err(got[0], want[0])
    cases = expand_cases_on_card()

    def call():
        return fe_ops.frontier_expand_fused(csr, t, v, capacity)

    f, live = t.shape[0], int(v.sum())
    # targets + valid read once, two indptr entries per live target, the
    # reached perm entries, the (capacity,) output written once
    nbytes = f * 5 + live * 8 + min(emitted, capacity) * 4 + capacity * 4
    entry = {
        "name": "frontier_expand", "route": "cuda",
        "source": "src/repro_torch/csrc/frontier_expand.cu",
        "replaces": "src/repro/kernels/frontier_expand/frontier_expand.py:84",
        "max_abs_err": err,
        "ms": time_ms(call, flush),
        "plain_ms": time_ms(lambda: expand_frontier(csr, t, v, capacity),
                            flush),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None,
        "shape": f"F={f} capacity={capacity} live={live} "
                 f"emitted={emitted} E={csr.num_edges}",
    }
    return entry, cases, call


def with_negatives(positions: torch.Tensor, num_rows: int) -> torch.Tensor:
    """A copy of ``positions`` with every 64th replaced by a negative from
    a numpy seed: in [-R, 0), which counts from the end once, and every
    16th of those below -R, which gives a zero row."""
    rng = np.random.default_rng(NEG_SEED)
    out = positions.clone()
    n = out[::64].numel()
    neg = -rng.integers(1, num_rows + 1, n)
    neg[::16] = -num_rows - 1 - rng.integers(0, 1000, neg[::16].shape[0])
    out[::64] = torch.from_numpy(neg.astype(np.int32)).to(out.device)
    return out


def late_gather_case(tables: list, positions: torch.Tensor, flush) -> dict:
    """``late_gather_columns`` on ``tables`` held bit-equal to the plain
    version at ``positions`` and at :func:`with_negatives` of them, then
    timed at ``positions``.  ``library_ms`` is ``index_select``'s time for
    one table; for several, no single call computes the function, and
    ``index_select_sum_ms`` adds the per-column ``index_select`` times."""
    r = tables[0].shape[0]
    for pos in (positions, with_negatives(positions, r)):
        got = lg_ops.late_gather_columns(tables, pos)
        want = late_gather_columns_ref(tables, pos)
        torch.cuda.synchronize()
        for g, w, t in zip(got, want, tables):
            require(g.dtype == w.dtype and g.shape == w.shape and torch.equal(
                g.view(torch.uint8), w.view(torch.uint8)),
                f"late_gather {t.dtype} {tuple(t.shape)} differs")
    p = positions.shape[0]
    wrapped = torch.where(positions < 0, positions.long() + r,
                          positions.long())
    in_range = (wrapped >= 0) & (wrapped < r)
    live = int(in_range.sum())
    rows = int(torch.unique(wrapped[in_range]).numel())
    row_bytes = sum(t.shape[1] * t.element_size() for t in tables)
    safe = wrapped.clamp(0, r - 1)
    selects = [time_ms(lambda t=t: torch.index_select(t, 0, safe), flush)
               for t in tables]
    case = {
        "max_abs_err": max(max_abs_err(g, w) for g, w in zip(got, want)),
        "ms": time_ms(lambda: lg_ops.late_gather_columns(tables, positions),
                      flush),
        "plain_ms": time_ms(lambda: late_gather_columns_ref(tables,
                                                            positions),
                            flush),
        "library_ms": selects[0] if len(tables) == 1 else None,
        # positions read once, each distinct live row of each column read
        # once, every output row written once
        "bound_ms": bound_ms(p * 4 + rows * row_bytes + p * row_bytes),
        "bound_by": "bytes",
        "shape": (f"R={r} P={p} live={live} rows={rows} columns="
                  + ",".join(f"{str(t.dtype)[6:]}x{t.shape[1]}"
                             for t in tables)),
    }
    if len(tables) > 1:
        case["index_select_sum_ms"] = sum(selects)
    return case


def late_gather_phase(ds, positions, out_cols, flush):
    """Root 0's result positions: all the query's output columns in one
    take (the main path's call, and the kernel line's entry), and the
    f32, int32 and bf16 one-column cases."""
    table = ds.table
    payload = table.column("column1")
    cases = {
        "columns": late_gather_case(
            [table.column(n).reshape(table.num_rows, -1) for n in out_cols],
            positions, flush),
        "f32": late_gather_case([payload], positions, flush),
        "int32": late_gather_case([table.column("id")[:, None]], positions,
                                  flush),
        "bf16": late_gather_case([payload.to(torch.bfloat16)], positions,
                                 flush),
    }
    entry = {
        "name": "late_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/late_gather.cu",
        "replaces": "src/repro/kernels/late_gather/late_gather.py:34",
        **cases["columns"],
    }
    return entry, cases


def pull_input(r, cols: dict, num_vertices: int):
    """The first pull level of a root-0 ``diropt`` run, rebuilt from its
    rows (the vertex reached by a row has the row's depth + 1): its (V,)
    frontier and visited masks on the CPU, and the level."""
    count = int(r.count)
    pos = r.positions[:count].long()
    vd = torch.full((num_vertices,), -1, dtype=torch.int32)
    vd[0] = 0
    vd[torch.from_numpy(cols["to"])[pos].long()] = r.row_depths[:count] + 1
    level = r.level_dirs.tolist().index(1)
    return vd == level, (vd >= 0) & (vd <= level), level


def walk_bytes(layout, f: torch.Tensor, v: torch.Tensor) -> int:
    """The bytes the layout route can not avoid (``layout_bound_ms``):
    ``visited`` and the output (V each), and for each unvisited vertex with
    an in-entry its two ``ptr`` words, then one ``nbr`` word and one
    frontier byte for each entry of its row up to its first hit (the whole
    row when none hits; one entry at the main shape, where every vertex
    has one in-entry)."""
    nv, e = f.shape[0], layout.num_edges
    ptr = layout.ptr.long()
    deg = ptr[1:] - ptr[:-1]
    open_rows = ~v & (deg > 0)
    owner = torch.repeat_interleave(torch.arange(nv, device=f.device), deg)
    rank = torch.arange(e, device=f.device) - ptr[owner]
    first = deg.clone().scatter_reduce_(
        0, owner, torch.where(f[layout.nbr], rank, deg[owner]), "amin")
    read = torch.minimum(first + 1, deg)[open_rows]
    return 2 * nv + int(open_rows.sum()) * 8 + int(read.sum()) * 5


def frontier_pull_shape(ctx, f: torch.Tensor, v: torch.Tensor, flush):
    """``frontier_pull`` at one shape of a direction's join view: the
    kernel over the dataset's layout (``ms``, the per-level call) and
    without it (``wrapper_ms``, which builds a layout in the call) held
    bit-equal to both plain versions.  ``bound_ms`` (also printed as
    ``layout_bound_ms``) counts what the timed call needs, from
    :func:`walk_bytes`; ``entry_bound_ms`` keeps the per-entry kernel's
    count (perm and join_dst in full, visited, join_src and the frontier
    bytes that the open entries need, the output), which the layout call
    does not read.  Returns the numbers and the per-level call."""
    rcsr, src, dst, layout = ctx.rcsr, ctx.join_src, ctx.join_dst, \
        ctx.pull_layout
    require(layout is not None, "the dataset built no pull layout")

    def call():
        return fp_ops.frontier_pull_fused(rcsr, src, dst, f, v,
                                          layout=layout)

    def wrapper():
        return fp_ops.frontier_pull_fused(rcsr, src, dst, f, v)

    want = frontier_pull_ref(rcsr, src, dst, f, v)
    got = call()
    for g, what in ((got, "the kernel"), (wrapper(), "the wrapper"),
                    (frontier_pull_layout_ref(layout, f, v),
                     "the layout's plain version")):
        torch.cuda.synchronize()
        require(g.dtype == want.dtype and torch.equal(g, want),
                f"frontier_pull: {what} differs from the plain version")
    e, nv = rcsr.num_edges, f.shape[0]
    vtx = dst[rcsr.perm].clamp(0, nv - 1)
    nbr = src[rcsr.perm].clamp(0, nv - 1)
    open_entries = ~v[vtx]
    pending = int(open_entries.sum())
    needed = int(torch.unique(nbr[open_entries]).numel())
    nbytes = e * 4 + e * 4 + nv + pending * 4 + needed + nv
    walk_ms = bound_ms(walk_bytes(layout, f, v))
    return {
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(call, flush),
        "wrapper_ms": time_ms(wrapper, flush),
        "plain_ms": time_ms(lambda: frontier_pull_ref(rcsr, src, dst, f, v),
                            flush),
        "bound_ms": walk_ms,
        "layout_bound_ms": walk_ms,
        "entry_bound_ms": bound_ms(nbytes),
        "bound_by": "bytes",
        "library_ms": None,
        "shape": f"E={e} V={nv} frontier={int(f.sum())} "
                 f"unvisited={int((~v).sum())} open_entries={pending} "
                 f"needed={needed} tiles={layout.tile_vtx.shape[0]} "
                 f"next={int(got.sum())}",
    }, call


def hub_input(ds):
    """The inbound view's hub, vertex 0 (83,619 entries): unvisited, with
    its last in-neighbor the only frontier vertex and every other vertex
    visited, so its tiles are read to the end."""
    layout = ds.context("inbound").pull_layout
    last = int(layout.nbr[int(layout.ptr[1]) - 1])
    f = torch.zeros((ds.num_vertices,), dtype=torch.bool, device=DEVICE)
    f[last] = True
    v = torch.ones_like(f)
    v[0] = False
    return f, v


def pull_cases_on_card() -> dict:
    """Each :func:`pull_case` on the card: the kernel over a layout built
    there, and the wrapper building its own, bit-equal to the plain
    version.  Returns each case's V, E, tiles and next-frontier size."""
    cases = {}
    for case in PULL_CASES:
        src, dst, frontier, visited = (torch.from_numpy(a).to(DEVICE)
                                       for a in pull_case(case))
        nv = frontier.shape[0]
        rcsr = build_csr(dst, nv)
        layout = build_pull_layout(rcsr, src, dst, nv)
        want = frontier_pull_ref(rcsr, src, dst, frontier, visited)
        for got in (fp_ops.frontier_pull_fused(rcsr, src, dst, frontier,
                                               visited, layout=layout),
                    fp_ops.frontier_pull_fused(rcsr, src, dst, frontier,
                                               visited)):
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"frontier_pull case {case}: differs")
        cases[case] = {"V": nv, "E": layout.num_edges,
                       "tiles": layout.tile_vtx.shape[0],
                       "next": int(want.sum())}
    return cases


def frontier_pull_phase(ds, frontier, visited, level, flush):
    """The first pull level of ``diropt`` root 0 (the kernel line's entry),
    the inbound view's hub and the shared cases, each bit-equal to the
    plain version.  Returns the entry, the cases and each shape's call,
    for :func:`pull_profile`."""
    ds.ensure_pull_layout("outbound")
    ds.ensure_pull_layout("inbound")
    main, main_call = frontier_pull_shape(
        ds.context("outbound"), frontier.to(DEVICE), visited.to(DEVICE),
        flush)
    main["shape"] = f"level={level} " + main["shape"]
    hub, hub_call = frontier_pull_shape(ds.context("inbound"),
                                        *hub_input(ds), flush)
    nxt = hub_call()
    require(bool(nxt[0]) and int(nxt.sum()) == 1,
            "frontier_pull hub: the next frontier is not vertex 0 alone")
    entry = {
        "name": "frontier_pull", "route": "cuda",
        "source": "src/repro_torch/csrc/frontier_pull.cu",
        "replaces": "src/repro/kernels/frontier_pull/frontier_pull.py:60",
        **main, "hub": hub,
    }
    return entry, pull_cases_on_card(), {"main": main_call, "hub": hub_call}


PULL_KERNELS = ("frontier_pull_rows", "frontier_pull_tiles")


def pull_profile(calls: dict, flush) -> dict:
    """``frontier_pull``'s device launches per call (1 at the main shape,
    whose layout has no hub tile; 2 at the hub) and the mean time of each
    kernel, with no memset among the device events."""
    out = {}
    for (case, fn), kernels in zip(calls.items(), (1, 2)):
        launches, by_key = device_profile(fn, flush, kernels)
        require(launches == kernels and not any(
            "memset" in k.lower() for k in by_key),
            f"frontier_pull ({case}): {launches} device launches "
            f"{sorted(by_key)}, want {kernels} and no memset")
        out[case] = {"device_launches_per_call": launches,
                     "device_ms_by_kernel": kernel_times(
                         by_key, PULL_KERNELS[:kernels],
                         f"frontier_pull ({case})")}
    return out


def batch_roots(cols: dict, num_vertices: int) -> list[int]:
    """BATCH_ROOTS roots: PRecursive's outbound single-root requests (root
    0, the three depth-1 vertices, the four random roots)."""
    return [req.root for req in make_requests(cols, num_vertices)
            if req.direction == "outbound"]


def lane_targets(results, cols: dict, level: int, capacity: int):
    """Each lane's targets at ``level`` of its own traversal, as
    :func:`widest_level` builds them for root 0: the ``to`` of the lane's
    rows of level - 1 in emission order, padded to ``capacity``.  Returns
    (targets (L, capacity), valid (L, capacity), each lane's rows at
    ``level``) on the CPU."""
    targets = torch.full((len(results), capacity), -1, dtype=torch.int32)
    valid = torch.zeros((len(results), capacity), dtype=torch.bool)
    emitted = []
    for i, r in enumerate(results):
        count = int(r.count)
        pos = r.positions[:count].cpu().numpy()
        depth = r.row_depths[:count].cpu().numpy()
        prev = cols["to"][pos[depth == level - 1]]
        targets[i, :prev.shape[0]] = torch.from_numpy(prev.astype(np.int32))
        valid[i, :prev.shape[0]] = True
        emitted.append(int((depth == level).sum()))
    return targets, valid, emitted


def expand_lane_cases_on_card() -> dict:
    """Each :func:`expand_lanes_case` (a tile case stacked as four lanes:
    itself, an empty lane, itself reversed, every other target) on the
    card: one call bit-equal to the plain version on every lane.  Returns
    each case's per-lane counts and overflow flags and the call's ms."""
    cases = {}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    for case in EXPAND_CASES:
        src, v, targets, valid, capacity = expand_lanes_case(case)
        csr = build_csr(torch.from_numpy(src).to(DEVICE), v)
        t = torch.from_numpy(targets.copy()).to(DEVICE)
        m = torch.from_numpy(valid.copy()).to(DEVICE)
        got = fe_ops.frontier_expand_fused(csr, t, m, capacity)
        want = expand_frontier(csr, t, m, capacity)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("positions", "total", "overflow")):
            require(g.dtype == w.dtype and g.shape == w.shape
                    and torch.equal(g, w),
                    f"frontier_expand lane case {case}: {name} differs")
        cases[case] = {"count": got[1].tolist(), "overflow": got[2].tolist(),
                       "ms": time_ms(lambda: fe_ops.frontier_expand_fused(
                           csr, t, m, capacity), flush)}
    return cases


def frontier_expand_lane_phase(ds, targets, valid, capacity, emitted,
                               flush):
    """The lane axis at the widest level of root 0's batch: the
    BATCH_ROOTS lanes' targets at that level in one call, bit-equal to the
    plain version and to each lane's one-lane call, then timed beside the
    plain version and the one-lane calls one after another.  Returns the
    numbers, the stacked cases and the call, for :func:`expand_profile`."""
    csr = ds.csr
    t, v = targets.to(DEVICE), valid.to(DEVICE)
    lanes = t.shape[0]
    got = fe_ops.frontier_expand_fused(csr, t, v, capacity)
    want = expand_frontier(csr, t, v, capacity)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("positions", "total", "overflow")):
        require(g.dtype == w.dtype and torch.equal(g, w),
                f"frontier_expand lanes: {name} differs")
    require(got[1].tolist() == [min(n, capacity) for n in emitted],
            "frontier_expand lanes: level totals")
    rows = [(t[i].contiguous(), v[i].contiguous()) for i in range(lanes)]
    for i, (ti, vi) in enumerate(rows):
        one = fe_ops.frontier_expand_fused(csr, ti, vi, capacity)
        require(all(torch.equal(g[i], o) for g, o in zip(got, one)),
                f"frontier_expand lanes: lane {i} differs from its own call")

    def call():
        return fe_ops.frontier_expand_fused(csr, t, v, capacity)

    def per_lane_calls():
        for ti, vi in rows:
            fe_ops.frontier_expand_fused(csr, ti, vi, capacity)

    live = v.sum(-1).tolist()
    nbytes = sum(t.shape[1] * 5 + n * 8 + min(e, capacity) * 4 + capacity * 4
                 for n, e in zip(live, emitted))
    entry = {
        "lanes": lanes, "max_abs_err": max_abs_err(got[0], want[0]),
        "ms": time_ms(call, flush),
        "per_lane_calls_ms": time_ms(per_lane_calls, flush),
        "plain_ms": time_ms(lambda: expand_frontier(csr, t, v, capacity),
                            flush),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None,
        "shape": f"L={lanes} F={t.shape[1]} capacity={capacity} "
                 f"live={live} emitted={emitted}",
    }
    return entry, expand_lane_cases_on_card(), call


def pull_lane_input(results, roots, cols: dict, num_vertices: int,
                    level: int):
    """Each lane's (V,) frontier and visited masks at ``level`` of its own
    traversal, rebuilt from its rows as :func:`pull_input` rebuilds root
    0's: (L, V) planes on the CPU."""
    to = torch.from_numpy(cols["to"])
    frontier, visited = [], []
    for r, root in zip(results, roots):
        count = int(r.count)
        pos = r.positions[:count].cpu().long()
        vd = torch.full((num_vertices,), -1, dtype=torch.int32)
        vd[root] = 0
        vd[to[pos].long()] = r.row_depths[:count].cpu() + 1
        frontier.append(vd == level)
        visited.append((vd >= 0) & (vd <= level))
    return torch.stack(frontier), torch.stack(visited)


def pull_lane_cases_on_card() -> dict:
    """Each :func:`pull_lanes_case` (a pull case stacked as four lanes:
    itself, an empty frontier, the frontier moved on by one, every other
    vertex open) on the card: one call bit-equal to the plain version on
    every lane.  Returns each case's next-frontier sizes and the call's
    ms."""
    cases = {}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    for case in PULL_CASES:
        src, dst, frontier, visited = (torch.from_numpy(a.copy()).to(DEVICE)
                                       for a in pull_lanes_case(case))
        nv = frontier.shape[-1]
        rcsr = build_csr(dst, nv)
        layout = build_pull_layout(rcsr, src, dst, nv)
        want = frontier_pull_ref(rcsr, src, dst, frontier, visited)

        def call():
            return fp_ops.frontier_pull_fused(rcsr, src, dst, frontier,
                                              visited, layout=layout)
        got = call()
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"frontier_pull lane case {case}: differs")
        cases[case] = {"next": got.sum(-1).tolist(),
                       "ms": time_ms(call, flush)}
    return cases


def frontier_pull_lane_phase(ds, frontier, visited, level, flush):
    """The lane axis at ``diropt`` root 0's first pull level: the
    BATCH_ROOTS lanes' (V,) planes at that level in one call over the one
    outbound layout, bit-equal to both plain versions and to each lane's
    one-lane call, then timed beside the plain version and the one-lane
    calls one after another.  ``bound_ms`` sums :func:`walk_bytes` over
    the lanes.  Returns the numbers, the stacked cases and the call."""
    ctx = ds.context("outbound")
    rcsr, src, dst, layout = ctx.rcsr, ctx.join_src, ctx.join_dst, \
        ctx.pull_layout
    f, v = frontier.to(DEVICE), visited.to(DEVICE)
    lanes = f.shape[0]

    def call():
        return fp_ops.frontier_pull_fused(rcsr, src, dst, f, v,
                                          layout=layout)

    rows = [(f[i].contiguous(), v[i].contiguous()) for i in range(lanes)]

    def per_lane_calls():
        for fi, vi in rows:
            fp_ops.frontier_pull_fused(rcsr, src, dst, fi, vi, layout=layout)

    want = frontier_pull_ref(rcsr, src, dst, f, v)
    got = call()
    torch.cuda.synchronize()
    require(torch.equal(got, want) and torch.equal(
        frontier_pull_layout_ref(layout, f, v), want),
        "frontier_pull lanes: differs from the plain versions")
    for i, (fi, vi) in enumerate(rows):
        require(torch.equal(got[i], fp_ops.frontier_pull_fused(
            rcsr, src, dst, fi, vi, layout=layout)),
            f"frontier_pull lanes: lane {i} differs from its own call")
    nbytes = sum(walk_bytes(layout, fi, vi) for fi, vi in rows)
    entry = {
        "lanes": lanes, "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(call, flush),
        "per_lane_calls_ms": time_ms(per_lane_calls, flush),
        "plain_ms": time_ms(lambda: frontier_pull_ref(rcsr, src, dst, f, v),
                            flush),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None,
        "shape": f"L={lanes} level={level} V={f.shape[1]} "
                 f"frontier={f.sum(-1).tolist()} "
                 f"unvisited={(~v).sum(-1).tolist()} "
                 f"next={got.sum(-1).tolist()} "
                 f"tiles={layout.tile_vtx.shape[0]}",
    }
    return entry, pull_lane_cases_on_card(), call


def spmm_case(x, src, dst, w, num_out: int, check: str, flush):
    """``spmm_segment`` against its plain version on the card, ``check``
    ``exact``, ``close`` (SPMM_TOL) or ``scaled`` (within 1e-5 of each
    row's sum of absolute terms, for rows of thousands of edges).  ``ms`` is
    the call the engine makes each level (the kernel on edges already in
    destination order); ``wrapper_ms`` adds the wrapper's stable sort;
    ``library_ms`` is ``torch.sparse.mm`` of the (num_out x N) CSR matrix
    of the live edges' weights, built outside the timed region.  Returns
    the case's numbers and its kernel call, for :func:`spmm_profile`."""
    n, d = x.shape
    seg = spmm_ops.segments(dst, num_out)
    s_src, s_w = src[seg.order], w[seg.order]
    got = spmm_ops.spmm_segment_sorted(x, s_src, seg.seg, s_w, seg.offsets)
    via_wrapper = spmm_ops.spmm_segment(x, src, dst, w, num_out)
    want = spmm_segment_ref(x, src, dst, w, num_out)
    torch.cuda.synchronize()
    label = f"spmm_segment N={n} E={src.shape[0]} D={d}"
    require(torch.equal(got, via_wrapper), f"{label}: wrapper differs")
    require(got.shape == (num_out, d) and bool(got.isfinite().all()),
            f"{label}: shape {tuple(got.shape)} or a non-finite value")
    if check == "exact":
        require(torch.equal(got, want), f"{label} differs from its plain "
                                        f"version")
    elif check == "close":
        require(bool(torch.isclose(got, want, **SPMM_TOL).all()),
                f"{label} differs from its plain version beyond "
                f"{SPMM_TOL}")
    else:
        scale = spmm_segment_ref(x.abs(), src, dst, w.abs(), num_out)
        require(bool(((got - want).abs() <= 1e-5 * scale + 1e-5).all()),
                f"{label} differs from its plain version beyond 1e-5 of "
                f"the rows' absolute sums")
    live = (src >= 0) & (src < n) & (dst >= 0) & (dst < num_out)
    n_live = int(live.sum())
    rows = int(torch.unique(src[live]).numel())
    sparse = torch.sparse_coo_tensor(
        torch.stack([dst[live], src[live]]).long(), w[live],
        (num_out, n)).coalesce().to_sparse_csr()
    e = src.shape[0]
    # the kernel's call: offsets and src in full, w and the x rows of the
    # live edges (each distinct row once), the output written once
    nbytes = (num_out + 1) * 4 + e * 4 + n_live * 4 + rows * d * 4 \
        + num_out * d * 4
    ops = 2.0 * n_live * d

    def call():
        return spmm_ops.spmm_segment_sorted(x, s_src, seg.seg, s_w,
                                            seg.offsets)

    return {
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(call, flush),
        "wrapper_ms": time_ms(lambda: spmm_ops.spmm_segment(
            x, src, dst, w, num_out), flush),
        "plain_ms": time_ms(lambda: spmm_segment_ref(x, src, dst, w,
                                                     num_out), flush),
        "library_ms": time_ms(lambda: torch.sparse.mm(sparse, x), flush),
        "bound_ms": bound_ms(nbytes, ops),
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= ops / FP32_OPS_PER_S else "operations",
        # the wrapper's call: src, dst and w read in full, the live x rows,
        # the output, and the sort's own output (sorted keys, int64 order)
        "wrapper_bound_ms": bound_ms(e * 12 + rows * d * 4 + num_out * d * 4
                                     + e * 12, ops),
        "shape": f"N={n} E={e} D={d} live={n_live} rows={rows} "
                 f"out={num_out}",
    }, call


def spmm_main_input(r, cols: dict, num_vertices: int):
    """The widest level of a root-0 ``bitmap`` aggregate_sum run, rebuilt
    from its rows and values: the frontier is the sources of the level's
    rows, ``x`` their values (zero elsewhere), and ``src`` is masked with
    the padding V outside the frontier, as ``WeightedDenseStep`` masks it.
    Returns (x (V, 1), src, dst, w, level) on the CPU."""
    count = int(r.count)
    pos = r.positions[:count].long()
    depth = r.row_depths[:count]
    level = int(torch.bincount(depth).argmax())
    frm = torch.from_numpy(cols["from"])
    frontier = torch.zeros((num_vertices,), dtype=torch.bool)
    frontier[frm[pos[depth == level]].long()] = True
    x = torch.where(frontier, r.vertex_values, 0.0)[:, None].contiguous()
    src = torch.where(frontier[frm.long()], frm, num_vertices)
    return (x, src, torch.from_numpy(cols["to"]),
            torch.from_numpy(cols[WEIGHT_COL]), level)


def spmm_random_input(seed: int, num_vertices: int, num_edges: int, d: int):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, num_edges).astype(np.int32)
    dst = rng.integers(0, num_vertices, num_edges).astype(np.int32)
    w = rng.uniform(0.5, 2.0, num_edges).astype(np.float32)
    x = rng.standard_normal((num_vertices, d), dtype=np.float32)
    return (torch.from_numpy(x).to(DEVICE), torch.from_numpy(src).to(DEVICE),
            torch.from_numpy(dst).to(DEVICE), torch.from_numpy(w).to(DEVICE))


def spmm_tile_cases_on_card() -> dict:
    """Each shared tile case (``spmm_tile_case``) at D = 1, 4, 17 and 128
    on the card: rows of at most S edges equal to the plain version run on
    the CPU, every row within 1e-5 of its sum of absolute terms, two calls
    bit-equal.  Returns each case's E, hubs and largest error per D."""
    cases = {}
    for case in SPMM_CASES:
        for d in (1, 4, 17, 128):
            x, src, dst, w, n_out = spmm_tile_case(case, d)
            x, src, dst, w = (torch.from_numpy(a) for a in (x, src, dst, w))
            want = spmm_segment_ref(x, src, dst, w, n_out)
            scale = spmm_segment_ref(x.abs(), src, dst, w.abs(), n_out)
            deg = spmm_ops.segments(dst, n_out).offsets.diff()
            args = [t.to(DEVICE) for t in (x, src, dst, w)]
            got = spmm_ops.spmm_segment(*args, n_out)
            again = spmm_ops.spmm_segment(*args, n_out)
            torch.cuda.synchronize()
            label = f"spmm_segment tile case {case} D={d}"
            require(torch.equal(got.view(torch.int32),
                                again.view(torch.int32)),
                    f"{label}: two calls differ")
            got = got.cpu()
            short = deg <= SHORT_ROW
            require(got.shape == want.shape
                    and torch.equal(got[short], want[short]),
                    f"{label}: a short row differs from the CPU run")
            require(bool(((got - want).abs() <= 1e-5 * scale + 1e-5).all()),
                    f"{label}: beyond 1e-5 of the rows' absolute sums")
            hub = tile_plan(src.shape[0], d).hub_edges
            cases.setdefault(case, {})[d] = {
                "E": src.shape[0], "hubs": int((deg > hub).sum()),
                "max_abs_err": max_abs_err(got, want)}
    return cases


def spmm_segment_phase(r, cols: dict, num_vertices: int, flush):
    """Cases (a)-(e) against the plain version (the kernel line's entry is
    (a)); returns the entry, the cases and the kernel calls at (a) and
    (d), for :func:`spmm_profile`."""
    x, src, dst, w, level = spmm_main_input(r, cols, num_vertices)
    frm = torch.from_numpy(cols["from"]).to(DEVICE)
    to, w = dst.to(DEVICE), w.to(DEVICE)
    main, main_call = spmm_case(x.to(DEVICE), src.to(DEVICE), to, w,
                                num_vertices, "exact", flush)
    main["shape"] += f" level={level}"
    cases, calls = {"a": main}, {"a": main_call}
    cases["b"], _ = spmm_case(*spmm_random_input(2, 1 << 20, 1 << 22, 1),
                              1 << 20, "close", flush)
    cases["c"], _ = spmm_case(*spmm_random_input(3, 1 << 16, 1 << 18, 128),
                              1 << 16, "close", flush)
    # the inbound view: every edge live, grouped by its `from` vertex
    # (vertex 0 owns 83,619 edges), at D = 1 and at GraphSAGE-Reddit's
    # d_hidden = 128 (src/repro/configs/graphsage_reddit.py)
    for case, seed, d in (("d", 4, 1), ("e", 5, 128)):
        xs = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (num_vertices, d), dtype=np.float32)).to(DEVICE)
        cases[case], calls[case] = spmm_case(xs, to, frm, w, num_vertices,
                                             "scaled", flush)
        del xs
    del calls["e"]
    entry = {
        "name": "spmm_segment", "route": "cuda",
        "source": "src/repro_torch/csrc/spmm_segment.cu",
        "replaces": "src/repro/kernels/spmm_segment/spmm_segment.py:43",
        **main,
    }
    return entry, cases, calls


def spmm_lane_bytes(xs: torch.Tensor, s_src: torch.Tensor,
                    mask: torch.Tensor, num_out: int) -> tuple[int, int]:
    """The bytes and float32 operations of one lane-axis call, each input
    read once and each output written once, for this call's data: offsets
    and the shared src in full, each lane's mask bytes at the sources of
    in-range edges (the kernel reads no other), the weights of the edges
    live in some lane, each lane's x rows that a live edge reads, and
    every lane's output rows; two operations a live term."""
    lanes, n, d = xs.shape
    e = s_src.shape[0]
    in_range = (s_src >= 0) & (s_src < n)
    live = mask[:, s_src.clamp(0, n - 1).long()] & in_range
    has_edge = torch.zeros((n,), dtype=torch.bool, device=xs.device)
    has_edge[s_src[in_range].long()] = True
    sources = int(has_edge.sum())
    rows = int((mask & has_edge).sum())
    nbytes = ((num_out + 1) * 4 + e * 4 + lanes * sources
              + int(live.any(0).sum()) * 4 + rows * d * 4
              + lanes * num_out * d * 4)
    return nbytes, 2 * int(live.sum()) * d


def spmm_lanes_library(xs, s_src, seg, s_w, mask, num_out: int):
    """The one PyTorch call that computes every lane at once: the (num_out
    x N) CSR matrix of the in-range edges' weights times the lanes' x,
    each masked to 0 off its lane's sources and laid out as (N, L * D).
    Returns the call, built outside any timed region, and its output's
    (L, num_out, D) view."""
    lanes, n, d = xs.shape
    keep = (s_src >= 0) & (s_src < n) & (seg >= 0) & (seg < num_out)
    sparse = torch.sparse_coo_tensor(
        torch.stack([seg[keep], s_src[keep]]).long(), s_w[keep],
        (num_out, n)).coalesce().to_sparse_csr()
    dense = torch.where(mask[..., None], xs, 0).permute(1, 0, 2).reshape(
        n, lanes * d)

    def call():
        return torch.sparse.mm(sparse, dense)
    return call, lambda out: out.reshape(num_out, lanes, d).permute(1, 0, 2)


def spmm_lanes_call(xs, s_src, seg, s_w, offsets, mask, flush,
                    exact: bool, label: str, want=None, scale=None,
                    short=None, library: bool = False
                    ) -> tuple[dict, object]:
    """One lane-axis ``spmm_segment`` call on the card: two calls bit-equal,
    every lane bit-equal to the one-lane call on its sources masked to N,
    one lane with its mask equal to that call, a lane whose mask is all
    off zero, and the lanes equal to ``want`` (the lane-axis plain
    version): exactly where ``exact``, else on the ``short`` rows exactly
    and elsewhere within 1e-5 of each row's absolute sum ``scale``.  Times
    the call, the plain version (on the card) and the lanes' one-lane
    calls in a row, the L one-lane sources masked beforehand, and with
    ``library`` :func:`spmm_lanes_library`'s call.  Returns the numbers
    and the call."""
    lanes, n, d = xs.shape
    num_out = offsets.shape[0] - 1

    def call():
        return spmm_ops.spmm_segment_sorted(xs, s_src, seg, s_w, offsets,
                                            mask)
    before = spmm_ops.LAUNCHES
    got, again = call(), call()
    torch.cuda.synchronize()
    require(spmm_ops.LAUNCHES == before + 2 * (num_out * d * lanes > 0),
            f"{label}: {spmm_ops.LAUNCHES - before} launches for two calls")
    require(got.shape == (lanes, num_out, d)
            and torch.equal(got.view(torch.int32), again.view(torch.int32)),
            f"{label}: shape {tuple(got.shape)} or two calls differ")
    masked = [torch.where(mask[i][s_src.clamp(0, n - 1).long()], s_src, n)
              for i in range(lanes)]
    for i in range(lanes):
        one = spmm_ops.spmm_segment_sorted(xs[i], masked[i], seg, s_w,
                                           offsets)
        require(torch.equal(got[i].view(torch.int32), one.view(torch.int32)),
                f"{label}: lane {i} differs from its one-lane call")
        if i == 0:
            alone = spmm_ops.spmm_segment_sorted(xs[:1], s_src, seg, s_w,
                                                 offsets, mask[:1])[0]
            require(torch.equal(alone.view(torch.int32),
                                one.view(torch.int32)),
                    f"{label}: L = 1 differs from the one-lane call")
        if not bool(mask[i].any()):
            require(not bool(got[i].any()), f"{label}: empty lane {i}")
    if want is None:
        want = spmm_segment_lanes_ref(xs, s_src, seg, s_w, num_out, mask)
    got_w = got.to(want.device)
    if exact:
        require(torch.equal(got_w, want),
                f"{label} differs from the lane-axis plain version")
    else:
        require(torch.equal(got_w[:, short], want[:, short])
                and bool(((got_w - want).abs()
                          <= 1e-5 * scale + 1e-5).all()),
                f"{label} differs from the lane-axis plain version beyond "
                f"1e-5 of the rows' absolute sums")
    nbytes, ops = spmm_lane_bytes(xs, s_src, mask, num_out)

    def one_by_one():
        for i in range(lanes):
            spmm_ops.spmm_segment_sorted(xs[i], masked[i], seg, s_w, offsets)
    plain = None if not exact else time_ms(
        lambda: spmm_segment_lanes_ref(xs, s_src, seg, s_w, num_out, mask),
        flush)
    lib = {}
    if library:
        lib_call, lanes_of = spmm_lanes_library(xs, s_src, seg, s_w, mask,
                                                num_out)
        lib_out = lanes_of(lib_call()).to(want.device)
        require(bool(torch.isclose(lib_out, want, **SPMM_TOL).all()),
                f"{label}: torch.sparse.mm differs from the lane-axis "
                f"plain version beyond {SPMM_TOL}")
        lib = {"library_ms": time_ms(lib_call, flush),
               "library_max_abs_err": max_abs_err(lib_out, want)}
    return {
        "max_abs_err": max_abs_err(got_w, want),
        "ms": time_ms(call, flush),
        "one_lane_calls_ms": time_ms(one_by_one, flush),
        "plain_ms": plain,
        **lib,
        "bound_ms": bound_ms(nbytes, ops),
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= ops / FP32_OPS_PER_S else "operations",
        "live_lanes": int(mask.any(-1).sum()),
    }, call


def spmm_lane_input(results, roots, cols: dict, num_vertices: int,
                    level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's frontier and values at ``level`` of the outbound
    aggregate_sum traversal from its root, rebuilt from the lane's
    PRecursive rows (on the tree the two emit the same rows level by
    level): the frontier is the sources of the lane's rows of that level,
    and a frontier vertex's value the product of the weights on its path
    from the root, in float32 root-down, as the engine folds it.  Returns
    (xs (L, V, 1), mask (L, V)) on the CPU."""
    frm, to, w = cols["from"], cols["to"], cols[WEIGHT_COL]
    xs = np.zeros((len(results), num_vertices), np.float32)
    mask = np.zeros((len(results), num_vertices), bool)
    for i, (r, root) in enumerate(zip(results, roots)):
        count = int(r.count)
        pos = r.positions[:count].cpu().numpy()
        depth = r.row_depths[:count].cpu().numpy()
        prod = np.ones(num_vertices, np.float32)
        for d in range(level):
            p = pos[depth == d]
            prod[to[p]] = prod[frm[p]] * w[p]
        f = frm[pos[depth == level]]
        mask[i, f] = True
        xs[i, f] = prod[f]
    return torch.from_numpy(xs)[..., None], torch.from_numpy(mask)


def spmm_lane_cases_on_card(flush) -> dict:
    """Each shared tile case (``spmm_tile_case``) at the widths
    SPMM_LANE_DIMS as BATCH_ROOTS lanes in one call: each lane its own
    seeded x and source mask (lane 1 masks every source off), checked by
    :func:`spmm_lanes_call` against the lane-axis plain version run on the
    CPU.  Returns each case's numbers per width."""
    cases = {}
    for case in SPMM_CASES:
        for d in SPMM_LANE_DIMS:
            x, src, dst, w, n_out = spmm_tile_case(case, d)
            n = x.shape[0]
            rng = np.random.default_rng(SPMM_CASES.index(case) + 1000 * d)
            xs = torch.from_numpy(rng.standard_normal(
                (BATCH_ROOTS, n, d), dtype=np.float32))
            mask = torch.from_numpy(rng.random((BATCH_ROOTS, n)) < 0.6)
            mask[1] = False
            dst = torch.from_numpy(dst)
            seg = spmm_ops.segments(dst, n_out)
            s_src = torch.from_numpy(src)[seg.order]
            s_w = torch.from_numpy(w)[seg.order]
            want = spmm_segment_lanes_ref(xs, s_src, seg.seg, s_w, n_out,
                                          mask)
            scale = spmm_segment_lanes_ref(xs.abs(), s_src, seg.seg,
                                           s_w.abs(), n_out, mask)
            short = seg.offsets.diff() <= SHORT_ROW
            on = [t.to(DEVICE) for t in (xs, s_src, seg.seg, s_w,
                                         seg.offsets, mask)]
            numbers, _ = spmm_lanes_call(
                *on, flush, False, f"spmm_segment lane case {case} D={d}",
                want, scale, short)
            hub = tile_plan(s_src.shape[0], d).hub_edges
            numbers.update(E=s_src.shape[0],
                           hubs=int((seg.offsets.diff() > hub).sum()))
            cases.setdefault(case, {})[d] = numbers
    return cases


# the source-mask densities of the seeded main-shape lane case: an empty
# lane, a full one, and six between
SPMM_LANE_DENSITIES = (0.0, 0.05, 0.15, 0.3, 0.5, 0.7, 0.9, 1.0)


def spmm_segment_lane_phase(ds, xs, mask, level: int, flush):
    """The lane axis at the deployment's widest dense level: the
    BATCH_ROOTS lanes of the outbound aggregate_sum batch (root 0's
    widest level, the other lanes at the same level of their own
    traversals) in one call over the tree's edges in destination order,
    exact against the lane-axis plain version (every row of the tree has
    at most one edge).  Then the same edges with seeded x on every vertex
    and each lane its own seeded mask (SPMM_LANE_DENSITIES), where a lane
    that ignored its mask, or read another lane's, would differ; then the
    tile cases.  Returns the entry (the seeded case under ``seeded``), the
    cases and the call."""
    frm, to = ds.table.column("from"), ds.table.column("to")
    w = ds.edge_weights(WEIGHT_COL)
    seg = spmm_ops.segments(to, SPEC.num_vertices)
    s_src, s_w = frm[seg.order], w[seg.order]
    xs, mask = xs.to(DEVICE), mask.to(DEVICE)
    entry, call = spmm_lanes_call(xs, s_src, seg.seg, s_w, seg.offsets,
                                  mask, flush, True,
                                  f"spmm_segment lanes level {level}",
                                  library=True)
    entry["shape"] = (f"L={xs.shape[0]} level={level} V={xs.shape[1]} "
                      f"E={s_src.shape[0]} D=1 "
                      f"frontier={mask.sum(-1).tolist()}")
    rng = np.random.default_rng(SPEC.seed + 2)
    lanes, n = mask.shape
    seeded_x = torch.from_numpy(rng.standard_normal(
        (lanes, n, 1), dtype=np.float32)).to(DEVICE)
    seeded_mask = torch.from_numpy(
        rng.random((lanes, n)) < np.asarray(SPMM_LANE_DENSITIES)[:, None]
    ).to(DEVICE)
    seeded, _ = spmm_lanes_call(seeded_x, s_src, seg.seg, s_w, seg.offsets,
                                seeded_mask, flush, True,
                                "spmm_segment lanes seeded", library=True)
    seeded["shape"] = (f"L={lanes} V={n} E={s_src.shape[0]} D=1 "
                       f"mask={seeded_mask.sum(-1).tolist()}")
    entry["seeded"] = seeded
    return entry, spmm_lane_cases_on_card(flush), call


def value_oracle(levels: list, cols: dict, num_vertices: int
                 ) -> dict[str, np.ndarray]:
    """Root 0's vertex values on the tree, from ``bfs_reference``'s levels:
    the sum of the weights along each vertex's root path (shortest_path)
    and their product (the four aggregates coincide on a tree), both
    accumulated root-down in float32, as the engines do; the identity where
    a vertex is not reached."""
    frm, to, w = cols["from"], cols["to"], cols[WEIGHT_COL]
    total = np.full(num_vertices, np.inf, np.float32)
    prod = np.full(num_vertices, np.nan, np.float32)
    total[0], prod[0] = 0.0, 1.0
    for level in levels:
        p = np.fromiter(level, np.int64)
        total[to[p]] = total[frm[p]] + w[p]
        prod[to[p]] = prod[frm[p]] * w[p]
    reached = ~np.isnan(prod)
    identity = {"aggregate_sum": 0.0, "aggregate_max": -np.inf,
                "aggregate_min": np.inf, "aggregate_mul": 1.0}
    out = {"shortest_path": total}
    for name, ident in identity.items():
        out[name] = np.where(reached, prod, np.float32(ident))
    return out


def embedding_bag_case(table, idx, seg, w, num_bags: int, combiner: str,
                       flush) -> dict:
    """``embedding_bag`` against its plain version on the card, within
    BAG_TOL of each bag's sum of absolute terms.  ``ms`` is the kernel on
    entries already in bag order; ``wrapper_ms`` adds the wrapper's stable
    sort; ``library_ms`` is ``torch.nn.functional.embedding_bag`` over the
    live entries (in-range segment, index wrapped into [0, R)) in bag
    order, built outside the timed region.  ``cpu_exact``: the kernel
    equals the plain version run on the CPU bit for bit (its
    ``index_add_`` adds in the entries' order there, as the kernel does);
    required.  ``layout`` is the kernel's, from ``bag_layout``.  Returns
    the case and the kernel's call on the sorted entries."""
    r, d = table.shape
    n = idx.shape[0]
    s = spmm_ops.segments(seg, num_bags)
    s_idx = idx[s.order]
    s_w = None if w is None else w[s.order]
    got = eb_ops.embedding_bag_sorted(table, s_idx, s.seg, s_w, s.offsets,
                                      combiner=combiner)
    via_wrapper = eb_ops.embedding_bag(table, idx, seg, num_bags, w,
                                       combiner=combiner)
    want = embedding_bag_ref(table, idx, seg, num_bags, w, combiner=combiner)
    scale = embedding_bag_ref(table.abs(), idx, seg, num_bags,
                              None if w is None else w.abs(),
                              combiner=combiner)
    torch.cuda.synchronize()
    label = f"embedding_bag R={r} D={d} I={n} bags={num_bags} {combiner}"
    require(torch.equal(got, via_wrapper), f"{label}: wrapper differs")
    require(bool(((got - want).abs() <= BAG_TOL * scale).all()),
            f"{label} differs from its plain version beyond {BAG_TOL} of "
            f"the bags' absolute sums")
    want_cpu = embedding_bag_ref(table.cpu(), idx.cpu(), seg.cpu(), num_bags,
                                 None if w is None else w.cpu(),
                                 combiner=combiner)
    require(torch.equal(got.cpu().view(torch.int32),
                        want_cpu.view(torch.int32)),
            f"{label} differs from its plain version run on the CPU")
    # the library call's inputs: live entries in bag order, bag offsets
    wrapped = torch.where(s_idx < 0, s_idx + r, s_idx).long()
    in_bag = (s.seg >= 0) & (s.seg < num_bags)
    live = in_bag & (wrapped >= 0) & (wrapped < r)
    lib_idx, lib_seg = wrapped[live], s.seg[live]
    lib_w = None if s_w is None else s_w[live]
    lib_off = torch.searchsorted(lib_seg, torch.arange(
        num_bags, dtype=lib_seg.dtype, device=lib_seg.device))
    mode = "sum" if combiner == "sum" else "mean"
    require(mode == "sum" or lib_w is None,
            "the library's mean takes no weights")

    def library():
        return torch.nn.functional.embedding_bag(
            lib_idx, table, lib_off, mode=mode, per_sample_weights=lib_w)

    n_live = int(live.sum())
    rows = int(torch.unique(lib_idx).numel())
    entries = int(in_bag.sum())
    weighted = w is not None
    # the kernel's call: offsets, the in-bag entries' indices (and
    # weights), each distinct live row once, the output written once
    nbytes = (num_bags + 1) * 4 + entries * (8 if weighted else 4) \
        + rows * d * 4 + num_bags * d * 4
    ops = (2.0 if weighted else 1.0) * n_live * d

    def kernel():
        return eb_ops.embedding_bag_sorted(table, s_idx, s.seg, s_w,
                                           s.offsets, combiner=combiner)

    return {
        "max_abs_err": max_abs_err(got, want),
        "cpu_exact": True,
        "layout": bag_layout(d, table.data_ptr())._asdict(),
        "library_max_abs_err": max_abs_err(got, library()),
        "ms": time_ms(kernel, flush),
        "wrapper_ms": time_ms(lambda: eb_ops.embedding_bag(
            table, idx, seg, num_bags, w, combiner=combiner), flush),
        "plain_ms": time_ms(lambda: embedding_bag_ref(
            table, idx, seg, num_bags, w, combiner=combiner), flush),
        "library_ms": time_ms(library, flush),
        "bound_ms": bound_ms(nbytes, ops),
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= ops / FP32_OPS_PER_S else "operations",
        # the wrapper's call adds the segment ids read and the sort's own
        # output (sorted keys, int64 order) and the permuted copies
        "wrapper_bound_ms": bound_ms(nbytes + n * 4 + n * 12
                                     + n * (8 if weighted else 4), ops),
        "shape": f"R={r} D={d} I={n} bags={num_bags} live={n_live} "
                 f"rows={rows} {combiner}{' weighted' if weighted else ''}",
        # one lane group walks a bag in series: the longest sets the tail
        "largest_bag": int(s.offsets.diff().max()) if num_bags else 0,
    }, kernel


def bag_inputs(case: str):
    """``bag_cases``'s case (b) or (c), on the card."""
    *tensors, num_bags = bag_cases(case)
    return [t.to(DEVICE) for t in tensors] + [num_bags]


def embedding_bag_phase(table, pos, flush):
    """(a) the full DeepFM table, one bag per serve_bulk sample over its 39
    positions (unweighted sum), whose sums must also equal the forward
    pass's ``emb.sum(1)``; (b) and (c) weighted with out-of-range entries
    (:func:`bag_inputs`); (d) (b)'s entries unweighted under ``mean``.
    Returns the kernel line's entry (a), the cases, (a)'s bags and each
    case's kernel call on sorted entries."""
    b, k = pos.shape
    idx = pos.reshape(-1).contiguous()
    seg = torch.arange(b, dtype=torch.int32, device=DEVICE) \
        .repeat_interleave(k)
    main, main_call = embedding_bag_case(table, idx, seg, None, b, "sum",
                                         flush)
    bags = eb_ops.embedding_bag(table, idx, seg, b)
    emb = fixed_hot_lookup(table, pos)
    torch.cuda.synchronize()
    require(bool(((bags - emb.sum(1)).abs()
                  <= BAG_TOL * emb.abs().sum(1)).all()),
            "embedding_bag (a) differs from the forward pass's emb.sum(1)")
    tab_b, idx_b, seg_b, w_b, nb = bag_inputs("b")
    cases, calls = {"a": main}, {"a": main_call}
    for case, args in (("b", (tab_b, idx_b, seg_b, w_b, nb, "sum")),
                       ("c", (*bag_inputs("c")[:4], 8192, "sum")),
                       ("d", (tab_b, idx_b, seg_b, None, nb, "mean"))):
        cases[case], calls[case] = embedding_bag_case(*args, flush)
    entry = {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:47",
        **main,
    }
    return entry, cases, (idx, seg, bags), calls


def embedding_bag_layout_cases_on_card() -> dict:
    """Each shared layout case (``bag_layout_case``: every layout of
    ``bag_layout``, bags of 0, 1, K - 1, K, K + 1, 39 and 3,000 entries, a
    table at a storage offset) on the card, weighted and not, under sum
    and mean: bit-equal to the plain version run on the CPU, two calls
    bit-equal, empty bags zero.  Returns each case's layout and largest
    error against the card's plain version."""
    cases = {}
    for case in BAG_LAYOUT_CASES:
        tab, idx, seg, w, b, offset = bag_layout_case(case)
        idx, seg, w = (torch.from_numpy(a) for a in (idx, seg, w))
        t = layout_table(tab, offset, DEVICE)
        layout = bag_layout(t.shape[1], t.data_ptr())
        require(not offset or layout.vec == 1,
                f"embedding_bag layout case {case}: {layout}")
        errs = {}
        for weighted in (False, True):
            for combiner in ("sum", "mean"):
                ww = w if weighted else None
                want = embedding_bag_ref(layout_table(tab, offset), idx,
                                         seg, b, ww, combiner=combiner)
                args = [None if a is None else a.to(DEVICE)
                        for a in (idx, seg, ww)]
                got = eb_ops.embedding_bag(t, args[0], args[1], b, args[2],
                                           combiner=combiner)
                again = eb_ops.embedding_bag(t, args[0], args[1], b,
                                             args[2], combiner=combiner)
                torch.cuda.synchronize()
                label = (f"embedding_bag layout case {case} {combiner}"
                         f"{' weighted' if weighted else ''}")
                bits = got.view(torch.int32)
                require(torch.equal(bits, again.view(torch.int32)),
                        f"{label}: two calls differ")
                require(torch.equal(bits.cpu(), want.view(torch.int32)),
                        f"{label}: differs from the CPU run")
                require(not got[[0, b - 1]].any(),
                        f"{label}: an empty bag is not zero")
                errs[f"{combiner}{' weighted' if weighted else ''}"] = \
                    max_abs_err(got, embedding_bag_ref(
                        t, *args[:2], b, args[2], combiner=combiner))
        cases[case] = {"D": tab.shape[1], "I": int(idx.shape[0]),
                       "layout": layout._asdict(),
                       "max_abs_err_vs_card_plain": errs}
    return cases


def bag_profile(calls: dict, flush) -> dict:
    """``embedding_bag``'s device launches per call (1) and its kernel's
    own mean device time at each case of ``calls``."""
    out = {}
    for case, fn in calls.items():
        launches, by_key = device_profile(fn, flush, 1)
        require(launches == 1, f"embedding_bag ({case}): {launches} device "
                "launches in one call, want 1")
        out[case] = {"device_launches_per_call": launches,
                     "kernel_device_ms": kernel_times(
                         by_key, ("embedding_bag_kernel",),
                         f"embedding_bag ({case})")["embedding_bag_kernel"]}
    return out


# ---------------------------------------------------------------------------
# DeepFM serving at the published Criteo width
# ---------------------------------------------------------------------------

class RecsysRequest(NamedTuple):
    kind: str                       # serve_p99 | serve_bulk | retrieval_cand
    dense: torch.Tensor             # on the host, as a request arrives
    sparse: torch.Tensor
    cand: torch.Tensor | None = None

    def __str__(self) -> str:
        n = f" C={self.cand.shape[0]}" if self.cand is not None else ""
        return f"deepfm {self.kind} B={self.dense.shape[0]}{n}"


def make_recsys_requests() -> list[RecsysRequest]:
    """8 serve_p99 batches ``recsys_batch(1, r, 512)``, the serve_bulk
    batch ``recsys_batch(0, 0, 262144)``, and one retrieval context
    ``recsys_batch(2, 0, 1)`` against 1,000,000 candidate items of the
    widest categorical field (C1, 7,912,889 ids), drawn with numpy seed 3."""
    vocabs = vocab_sizes(DEEPFM.vocab_scale)

    def host(seed: int, step: int, batch: int):
        b = recsys_batch(seed, step, batch, vocabs=vocabs)
        return torch.from_numpy(b["dense"]), torch.from_numpy(b["sparse"])

    reqs = [RecsysRequest("serve_p99", *host(1, r, P99_BATCH))
            for r in range(P99_REQUESTS)]
    reqs.append(RecsysRequest("serve_bulk", *host(0, 0, BULK_BATCH)))
    c1 = int(recsys.field_offsets(DEEPFM)[DEEPFM.n_dense])
    cand = c1 + np.random.default_rng(3).integers(0, vocabs[0], N_CANDIDATES)
    reqs.append(RecsysRequest("retrieval_cand", *host(2, 0, 1),
                              torch.from_numpy(cand.astype(np.int32))))
    return reqs


def params_mb(params) -> float:
    tensors = [params["table"], params["first_order"], params["bias"],
               *(t for lp in params["mlp"] for t in lp.values())]
    return sum(t.nbytes for t in tensors) / 2 ** 20


def serve(params, offsets, req: RecsysRequest):
    """One request as a user makes it: its features copied to the
    parameters' device, then ``serve_scores`` or ``retrieval_scores``."""
    device = offsets.device
    dense, sparse = req.dense.to(device), req.sparse.to(device)
    if req.cand is None:
        return recsys.serve_scores(params, DEEPFM, dense, sparse, offsets)
    return recsys.retrieval_scores(params, DEEPFM, dense, sparse, offsets,
                                   req.cand.to(device))


def check_recsys(reqs, got, want, positions, want_positions) -> dict:
    """Positions card against CPU: every difference is a bucket flip, one
    bucket apart where ``1000 * sigmoid(x)`` (float64) lies within 1e-3 of
    an integer.  Scores within DEEPFM_TOL on every sample whose positions
    agree (retrieval: all candidates, if its context's agree).  Returns the
    flip counts by request kind."""
    flips = dict.fromkeys((req.kind for req in reqs), 0)
    for req, g, w, pos, wpos in zip(reqs, got, want, positions,
                                    want_positions):
        pos = pos.cpu()
        label = str(req)
        require(g.shape == w.shape and bool(torch.isfinite(g).all()),
                f"{label}: shape or non-finite scores")
        diff = pos != wpos
        require(not bool(diff[:, DEEPFM.n_dense:].any()),
                f"{label}: a categorical position differs")
        rows, cols = torch.nonzero(diff, as_tuple=True)
        x = req.dense[rows, cols].double()
        scaled = 1000.0 / (1.0 + torch.exp(-x))
        require(bool(((pos[rows, cols] - wpos[rows, cols]).abs() == 1).all()
                     and ((scaled - scaled.round()).abs() < 1e-3).all()),
                f"{label}: a position differs away from a bucket boundary")
        flips[req.kind] += int(rows.numel())
        agree = ~diff.any(1)
        g = g.cpu()
        if req.cand is not None:
            if bool(agree.all()):
                require(bool(torch.isclose(g, w, **DEEPFM_TOL).all()),
                        f"{label}: scores differ beyond {DEEPFM_TOL}")
            else:
                print(f"{label}: the context's positions flipped, so its "
                      f"{g.numel()} candidate scores were not compared")
            continue
        require(bool(torch.isclose(g[agree], w[agree], **DEEPFM_TOL).all()),
                f"{label}: scores differ beyond {DEEPFM_TOL}")
    return flips


def profile_call(label: str, fn, warm_ms: float) -> dict:
    """Where one warm request's time goes: device time per kernel from
    ``torch.profiler``, and the device's idle share against the request's
    unprofiled warm latency ``warm_ms``.  A session that lost every
    device event is taken again (:func:`profiled`)."""
    # device-side events only (kernels, copies, fills): the host ops that
    # launched them carry the same time again
    kernels = profiled(fn, bool)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {
        "request": label, "warm_ms": warm_ms,
        "device_ms": device_ms,
        "idle_share": 1 - device_ms / warm_ms if device_ms else None,
        "device_launches": sum(e.count for e in kernels),
        "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                for e in top],
    }


def warm_latency_ms(fn) -> float:
    """Median of 3 warm runs, host clock around the request and a sync."""
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def check_path(label, requests, got, expected, launches, want_launches,
               levels, values, id_to_pos) -> None:
    """One path's results against the CPU run, its root-0 rows against
    the BFS oracle (and its root-0 vertex values against ``values``), and
    its launch counts against the CPU run's levels."""
    for req, r, want in zip(requests, got, expected):
        check_result_shape(r, CAPS, str(req))
        require_equal(r, want, str(req))
        if req.direction == "outbound" and req.root == 0:
            check_root0(r, levels, SPEC, str(req),
                        real_positions(req.engine, r, id_to_pos))
            if req.workload != "reach":
                require(torch.equal(r.vertex_values.cpu(), torch.from_numpy(
                    values[req.workload])),
                    f"{req}: vertex values differ from the path oracle")
    for kernel, n in want_launches.items():
        require(launches[kernel] == n,
                f"{label} path: {kernel} launched {launches[kernel]} times, "
                f"the CPU run's levels call for {n}")
    print(f"{label} path: {len(requests)} requests equal to the CPU run; "
          f"launches {json.dumps(launches)}")


# ---------------------------------------------------------------------------
# batched roots (run_query_batch)
# ---------------------------------------------------------------------------

class Batch(NamedTuple):
    engine: str
    direction: str
    roots: tuple
    workload: str = "reach"

    def __str__(self) -> str:
        label = f"{self.engine} {self.direction} x{len(self.roots)}"
        return label if self.workload == "reach" else \
            f"{label} {self.workload}"


def make_batches(cols: dict, num_vertices: int) -> list[Batch]:
    """Each reach-batch engine outbound over the BATCH_ROOTS roots of
    :func:`batch_roots`; PRecursive inbound and both ways over the same
    roots with the deepest vertex in place of the last random root; and
    PRecursive outbound over a serving bucket of BUCKET_ROOTS (the eight
    and seeded random roots)."""
    eight = tuple(batch_roots(cols, num_vertices))
    back = eight[:-1] + (num_vertices - 1,)
    more = np.random.default_rng(ROOT_SEED + 1).integers(
        0, num_vertices, BUCKET_ROOTS - len(eight)).tolist()
    return ([Batch(engine, "outbound", eight) for engine in BATCH_ENGINES]
            + [Batch("precursive", "inbound", back),
               Batch("precursive", "both", back),
               Batch("precursive", "outbound", eight + tuple(more))])


def make_value_batches(cols: dict, num_vertices: int
                       ) -> tuple[list[Batch], list[Batch]]:
    """The weighted batches over the eight roots of :func:`batch_roots`:
    ``precursive`` outbound under each semiring and shortest_path inbound
    and both ways (the deepest vertex in place of the last random root),
    ``bitmap`` outbound under each semiring and shortest_path and
    aggregate_sum inbound (the aggregate_sum batches run the lane-axis
    ``spmm_segment``); and the value-engine batches: each of the six
    outbound, ``trecursive`` and ``trecursive_rewrite`` inbound and both
    ways."""
    eight = tuple(batch_roots(cols, num_vertices))
    back = eight[:-1] + (num_vertices - 1,)
    sp = "shortest_path"
    weighted = ([Batch("precursive", "outbound", eight, s)
                 for s in SEMIRINGS]
                + [Batch("precursive", d, back, sp)
                   for d in ("inbound", "both")]
                + [Batch("bitmap", "outbound", eight, s) for s in SEMIRINGS]
                + [Batch("bitmap", "inbound", back, s)
                   for s in (sp, "aggregate_sum")])
    value = ([Batch(engine, "outbound", eight)
              for engine in VALUE_ENGINE_NAMES]
             + [Batch(engine, d, back)
                for engine in ("trecursive", "trecursive_rewrite")
                for d in ("inbound", "both")])
    return weighted, value


def result_buffer_mib(ds, b: Batch) -> float | None:
    """The working result a value-engine batch holds: L x (cap_r + cap_f)
    rows of the columns its recursion appends (full 4 W-byte rows on the
    row store, the output columns on ``trecursive``, the id alone on a
    rewrite); None for the positional and dense engines."""
    if b.engine not in VALUE_ENGINE_NAMES:
        return None
    if b.engine.endswith("_rewrite"):
        row = 4
    elif b.engine.startswith("rowstore"):
        row = 4 * sum(int(np.prod(c.shape[1:]))
                      for c in ds.table.columns.values())
    else:
        row = sum(c.element_size() * int(np.prod(c.shape[1:]))
                  for name, c in ds.table.columns.items()
                  if name in query(b.engine).out_cols)
    return len(b.roots) * (CAPS.result + CAPS.frontier) * row / 2 ** 20


def run_batch(ds, b: Batch, levels: list, card: str, id_to_pos=None,
              values=None) -> dict:
    """One ``run_query_batch`` call with the counters zeroed just before
    and read just after: every lane bit-equal to the card's run of its
    root alone, root 0's lane (outbound) equal to the BFS oracle (its ids
    mapped back to positions through ``id_to_pos`` where the recursion
    carried values) and, weighted, to the path oracle ``values``, and
    each per-level kernel called once on each level where some lane calls
    it (a lane's levels from :func:`launch_levels` of its own run), so a
    level is one C call for all lanes; ``late_gather`` once, or, on the
    tuple and row-store engines, once a level of the deepest lane, once
    for the seed blocks and once more for a rewrite's join.  Returns the
    ``batch:`` line's numbers."""
    q = query(b.engine, b.direction, b.workload)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    got = run_query_batch(q, ds, list(b.roots))
    launches = read_launches()
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    lane_levels, one_by_one_ms = [], 0.0
    for i, root in enumerate(b.roots):
        one = run_query(q, ds, root)
        lane = result_lane(got, i)
        label = f"batch {b} lane {i} root {root}"
        require_equal(lane, one, label, "the single-root card run")
        if b.direction == "outbound" and root == 0:
            check_root0(lane, levels, SPEC, label,
                        real_positions(b.engine, lane, id_to_pos)
                        if id_to_pos is not None else None)
            if b.workload != "reach":
                require(torch.equal(lane.vertex_values.cpu(),
                                    torch.from_numpy(values[b.workload])),
                        f"{label}: vertex values differ from the path "
                        f"oracle")
        lane_levels.append(launch_levels(
            Request(b.engine, b.direction, root, b.workload), one,
            SPEC.num_vertices))
        one_by_one_ms += warm_latency_ms(lambda root=root: run_query(
            q, ds, root))
    depths = got.depth.tolist()
    deepest = [i for i, d in enumerate(depths) if d == max(depths)]
    want = {k: len(set().union(*(lv[k] for lv in lane_levels)))
            for k in LEVEL_KERNELS}
    gathers = (max(depths) + 1 + b.engine.endswith("_rewrite")
               if b.engine in VALUE_ENGINE_NAMES else 1)
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0), **want,
                         "late_gather": gathers},
            f"batch {b}: launches {launches}, want {want} and "
            f"{gathers} late_gather")
    warm = warm_latency_ms(lambda: run_query_batch(q, ds, list(b.roots)))
    line = {
        "call": str(b), "lanes": len(b.roots), "levels": max(depths),
        "lane_depths": depths, "launches": launches,
        "deepest_lane_launches": {k: max(len(lane_levels[i][k])
                                         for i in deepest)
                                  for k in LEVEL_KERNELS},
        "summed_lane_launches": {k: sum(len(lv[k]) for lv in lane_levels)
                                 for k in LEVEL_KERNELS},
        "warm_ms": warm, "one_by_one_warm_ms": one_by_one_ms,
        "peak_mib": peak_mib, "count": got.count.tolist(),
        "overflow": got.overflow.tolist(), "card": card}
    reckoned = result_buffer_mib(ds, b)
    if reckoned is not None:
        line["result_buffer_mib"] = reckoned
    return line


def run_weighted_buckets(ds, roots: list, card: str) -> tuple[dict, dict]:
    """``run_query_buckets`` of ``precursive`` shortest_path over the eight
    roots in two buckets of 4: every root bit-equal to its single-root
    card run, ``late_gather`` once a bucket.  Returns the ``weighted
    buckets:`` line and the launches."""
    q = query("precursive", workload="shortest_path")
    size = len(roots) // 2
    buckets = [types.SimpleNamespace(indices=tuple(range(k, k + size)),
                                     roots=tuple(roots[k:k + size]),
                                     caps=CAPS)
               for k in range(0, len(roots), size)]
    reset_launches()
    out = run_query_buckets(q, ds, buckets)
    launches = read_launches()
    require(launches["late_gather"] == len(buckets)
            and launches["frontier_expand"] > 0
            and launches["frontier_pull"] == launches["spmm_segment"]
            == launches["embedding_bag"] == 0,
            f"weighted buckets: launches {launches}")
    for i, root in enumerate(roots):
        require_equal(out[i], run_query(q, ds, root),
                      f"weighted buckets root {root}",
                      "the single-root card run")
    return {"engine": "precursive", "workload": "shortest_path",
            "buckets": len(buckets), "lanes": len(roots),
            "launches": launches,
            "warm_ms": warm_latency_ms(
                lambda: run_query_buckets(q, ds, buckets)),
            "card": card}, launches


def value_batch_phase(ds, ds_paper, cols: dict, levels: list, values: dict,
                      id_to_pos, card: str, by_path: dict) -> None:
    """The weighted batches on ``ds`` and the value-engine batches on
    ``ds_paper`` (:func:`make_value_batches`), each through
    :func:`run_batch` with its counters zeroed just before it, summed
    into the ``batch_values`` path; a profile line for the aggregate_sum
    ``bitmap`` batch and the ``rowstore`` batch; then the weighted
    ``run_query_buckets`` call (``weighted_buckets``)."""
    t0 = time.perf_counter()
    weighted, value = make_value_batches(cols, SPEC.num_vertices)
    by_path["batch_values"] = dict.fromkeys(KERNEL_OPS, 0)
    lines = {}
    for on, batches in ((ds, weighted), (ds_paper, value)):
        for b in batches:
            line = run_batch(on, b, levels, card, id_to_pos, values)
            lines[str(b)] = line
            for name, n in line["launches"].items():
                by_path["batch_values"][name] += n
            print("batch: " + json.dumps(line))
    eight = list(weighted[0].roots)
    for on, b in ((ds, Batch("bitmap", "outbound", tuple(eight),
                             "aggregate_sum")),
                  (ds_paper, Batch("rowstore", "outbound", tuple(eight)))):
        q = query(b.engine, b.direction, b.workload)

        def batch_call(q=q, on=on):
            return run_query_batch(q, on, eight)
        print("profile: " + json.dumps({**profile_call(
            f"batch {b}", batch_call, lines[str(b)]["warm_ms"]),
            "card": card}))
    line, by_path["weighted_buckets"] = run_weighted_buckets(ds, eight, card)
    print("weighted buckets: " + json.dumps(line))
    torch.cuda.empty_cache()
    print(f"weighted and value batches: {len(weighted) + len(value)} "
          f"batches in {time.perf_counter() - t0:.3f} s (host clock)")


# ---------------------------------------------------------------------------
# MS-BFS (run_query_multi) and the bucket executor
# ---------------------------------------------------------------------------

MQ_DEPTH_CAPS = {0: 2, 1: 5, 5: 2, 9: 5}   # lane -> its depth cap
EVICT_RESULT_CAP = 1 << 12     # root 0's lane overflows it, leaf lanes not
BUCKET_SPLIT = 4               # run_query_buckets: four buckets of 8


def mq_query(direction: str = "outbound", caps: EngineCaps | None = None
             ) -> RecursiveQuery:
    return RecursiveQuery("multiquery", MAX_DEPTH, SPEC.payload_cols,
                          caps or CAPS, direction=direction,
                          lanes=BUCKET_ROOTS)


def timed(label: str, fn, card: str) -> dict:
    """Warm ms (host median of 3), then busy ms, launches, idle share and
    the costliest device ops from one ``torch.profiler`` session of
    ``fn``."""
    warm = warm_latency_ms(fn)
    prof = profile_call(label, fn, warm)
    return {**exp_numbers(warm, prof), "top": prof["top"][:5],
            "card": card}


def run_multiquery(ds, ds_cpu, roots: list, direction: str, levels: list,
                   card: str) -> tuple[dict, object, dict]:
    """One ``run_query_multi`` over the serving bucket's roots, with the
    counters zeroed just before and read just after (``late_gather`` once,
    nothing else), every lane the same rows as lane i of the card's
    ``diropt`` batch over the same roots, root 0's lane equal to the BFS
    oracle, and (``ds_cpu`` given) the whole result equal to the port's
    CPU run.  Returns the ``multiquery:`` line, the result and the
    launches."""
    q = mq_query(direction)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    got = run_query_multi(q, ds, roots)
    launches = read_launches()
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0), "late_gather": 1},
            f"multiquery {direction}: launches {launches}, want one "
            f"late_gather")
    dq = query("diropt", direction)
    batch = run_query_batch(dq, ds, roots)
    check_result_shape(result_lane(got, 0), CAPS, f"multiquery {direction}")
    for i, root in enumerate(roots):
        label = f"multiquery {direction} lane {i} root {root}"
        lane = result_lane(got, i)
        require_same_rows(lane, result_lane(batch, i), label,
                          "the diropt batch")
        if direction == "outbound" and root == 0:
            check_root0(lane, levels, SPEC, label)
    cpu_s = None
    if ds_cpu is not None:
        t0 = time.perf_counter()
        require_equal(got, run_query_multi(q, ds_cpu, roots),
                      f"multiquery {direction}")
        cpu_s = time.perf_counter() - t0
    mq = timed(f"multiquery {direction} x{len(roots)}",
               lambda: run_query_multi(q, ds, roots), card)
    lockstep = timed(f"batch diropt {direction} x{len(roots)}",
                     lambda: run_query_batch(dq, ds, roots), card)
    line = {"direction": direction, "lanes": len(roots),
            "levels": int(got.depth.max()),
            "rows": int(got.count.sum()), **mq,
            "busy_ms_per_root": mq["busy_ms"] / len(roots),
            "peak_mib": peak_mib, "cpu_run_s": cpu_s,
            "diropt_batch": {k: lockstep[k] for k in ("warm_ms", "busy_ms",
                                                      "launches",
                                                      "idle_share", "top")},
            "busy_ratio_vs_diropt_batch": mq["busy_ms"] / lockstep["busy_ms"]}
    return line, got, launches


def run_multiquery_caps(ds, roots: list, full) -> dict:
    """``run_query_multi`` with ``lane_limits`` capping the lanes of
    MQ_DEPTH_CAPS: each capped lane equal to ``diropt`` at that
    ``max_depth`` on the card, every other lane to the uncapped run."""
    limits = [MQ_DEPTH_CAPS.get(i, MAX_DEPTH) for i in range(len(roots))]
    reset_launches()
    got = run_query_multi(mq_query(), ds, roots, limits)
    launches = read_launches()
    for i, root in enumerate(roots):
        label = f"multiquery depth caps lane {i} root {root}"
        if limits[i] < MAX_DEPTH:
            want = run_query(RecursiveQuery("diropt", limits[i],
                                            SPEC.payload_cols, CAPS), ds,
                             root)
            require_same_rows(result_lane(got, i), want, label,
                              f"diropt at max_depth {limits[i]}")
        else:
            require_same_rows(result_lane(got, i), result_lane(full, i),
                              label, "the uncapped run")
    print("multiquery depth caps: " + json.dumps(
        {"lane_caps": MQ_DEPTH_CAPS, "lane_depths": got.depth.tolist(),
         "launches": launches}))
    return launches


def run_eviction(ds, roots: list, full) -> dict:
    """``dispatch_buckets`` on one MS-BFS bucket of the roots at result cap
    EVICT_RESULT_CAP, fallback CAPS: exactly the lanes whose rows exceed
    the cap (root 0's among them) are evicted, each then equal to
    ``diropt`` at the fallback caps, and every other lane keeps its
    bucket-caps rows."""
    small = EngineCaps(CAPS.frontier, EVICT_RESULT_CAP)
    over = [c > EVICT_RESULT_CAP for c in full.count.tolist()]
    require(over[0] and not all(over),
            f"eviction: lanes over the cap {over}, want root 0's and not "
            f"all")
    bucket = types.SimpleNamespace(indices=tuple(range(len(roots))),
                                   roots=tuple(roots), caps=small)

    def dispatch(i, b, caps):
        return run_query_multi(mq_query("outbound", caps), ds, list(b.roots))
    before, timings = lane_eviction_count(), []
    reset_launches()
    out = dispatch_buckets([bucket], dispatch, fallback_caps=CAPS,
                           observer=timings.append)
    launches = read_launches()
    evicted = lane_eviction_count() - before
    require(evicted == sum(over) == timings[0].evicted_lanes
            and not timings[0].retried,
            f"eviction: {evicted} lanes evicted, {sum(over)} overflowed")
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0),
                         "late_gather": 1 + evicted},
            f"eviction: launches {launches}")
    for i, root in enumerate(roots):
        caps = CAPS if over[i] else small
        want = run_query(RecursiveQuery("diropt", MAX_DEPTH,
                                        SPEC.payload_cols, caps), ds, root)
        require_same_rows(out[i], want, f"eviction lane {i} root {root}",
                          f"diropt at caps {tuple(caps)}")
    print("multiquery eviction: " + json.dumps(
        {"result_cap": EVICT_RESULT_CAP, "fallback_caps": list(CAPS),
         "evicted_lanes": [i for i, o in enumerate(over) if o],
         "lane_eviction_count_delta": evicted, "launches": launches}))
    return launches


def run_buckets(ds, roots: list, card: str) -> tuple[dict, dict]:
    """``run_query_buckets`` of ``precursive`` over the roots cut into
    BUCKET_SPLIT buckets: every root's result bit-equal to its single-root
    card run, ``late_gather`` once a bucket.  Returns the ``buckets:``
    line (beside the one 32-root batch) and the launches."""
    q = query("precursive")
    size = len(roots) // BUCKET_SPLIT
    buckets = [types.SimpleNamespace(indices=tuple(range(k, k + size)),
                                     roots=tuple(roots[k:k + size]),
                                     caps=CAPS)
               for k in range(0, len(roots), size)]
    reset_launches()
    out = run_query_buckets(q, ds, buckets)
    launches = read_launches()
    require(launches["late_gather"] == len(buckets)
            and launches["frontier_expand"] > 0
            and launches["frontier_pull"] == launches["spmm_segment"]
            == launches["embedding_bag"] == 0,
            f"buckets: launches {launches}")
    for i, root in enumerate(roots):
        require_equal(out[i], run_query(q, ds, root),
                      f"buckets root {root}", "the single-root card run")
    line = {"engine": "precursive", "buckets": len(buckets),
            "lanes": len(roots), "launches": launches,
            **timed(f"buckets precursive {len(buckets)} x{size}",
                    lambda: run_query_buckets(q, ds, buckets), card),
            "one_batch": timed(f"batch precursive x{len(roots)}",
                               lambda: run_query_batch(q, ds, roots),
                               card)}
    return line, launches


def multiquery_phase(ds, cols: dict, levels: list, card: str,
                     by_path: dict) -> None:
    """MS-BFS over the serving bucket on ``ds`` (the card's dataset of
    ``cols``), held against the diropt batch over the same roots and,
    outbound, against the CPU run; then its per-lane depth caps, the
    bucket executor's eviction of its overflowing lanes, and
    ``run_query_buckets``; each call's counters zeroed just before it and
    added to ``by_path`` (``multiquery``, ``buckets``)."""
    t_mq = time.perf_counter()
    ds_cpu = dataset_from_numpy(cols, SPEC.num_vertices, "cpu")
    bucket_roots = list(make_batches(cols, SPEC.num_vertices)[-1].roots)
    by_path["multiquery"] = dict.fromkeys(KERNEL_OPS, 0)
    mq_full = None
    for direction in ("outbound", "inbound", "both"):
        line, got_mq, launches = run_multiquery(
            ds, ds_cpu if direction == "outbound" else None,
            bucket_roots, direction, levels, card)
        print("multiquery: " + json.dumps(line))
        for name, n in launches.items():
            by_path["multiquery"][name] += n
        if direction == "outbound":
            mq_full = got_mq
        del got_mq
    for launches in (run_multiquery_caps(ds, bucket_roots, mq_full),
                     run_eviction(ds, bucket_roots, mq_full)):
        for name, n in launches.items():
            by_path["multiquery"][name] += n
    del mq_full
    line, by_path["buckets"] = run_buckets(ds, bucket_roots, card)
    print("buckets: " + json.dumps(line))
    print(f"multiquery and buckets: {time.perf_counter() - t_mq:.3f} s "
          f"(host clock)")


# ---------------------------------------------------------------------------
# the paper's tuple-based and row-store engines, and Exp 1-3
# ---------------------------------------------------------------------------

def inverse_ids(cols: dict) -> torch.Tensor:
    """The position of each id: the inverse of the table's id column (a
    permutation of the edge positions)."""
    ids = torch.from_numpy(cols["id"]).long()
    out = torch.empty_like(ids)
    out[ids] = torch.arange(ids.shape[0])
    return out


def widest_row_block(r, id_to_pos: torch.Tensor, capacity: int,
                     num_rows: int) -> tuple[torch.Tensor, int]:
    """The block of positions that ``rowstore``'s ``take_rows`` gathers at
    the widest level of a root-0 run, rebuilt from its rows: the level's
    positions in ascending order (as the scan compacts them), padded to
    ``capacity`` with the sentinel ``num_rows``.  Returns (positions on
    the CPU, level)."""
    count = int(r.count)
    depth = r.row_depths[:count].cpu()
    level = int(torch.bincount(depth.long()).argmax())
    pos = real_positions("rowstore", r, id_to_pos)[:count][depth == level]
    out = torch.full((capacity,), num_rows, dtype=torch.int32)
    out[:pos.shape[0]] = pos.sort().values.to(torch.int32)
    return out, level


def exp_entry(ds, engine: str, payload_cols: int, spec: TreeSpec,
              levels: list, id_to_pos: torch.Tensor) -> dict:
    """One engine's root 0 outbound at depth 16 on ``ds``: its rows
    checked against the BFS oracle's ``levels``, then its warm ms (median
    of 3, host clock) and its ``torch.profiler`` busy ms, launches and
    idle share."""
    q = query(engine, payload_cols=payload_cols)
    label = f"{engine} outbound root 0 N={payload_cols}"
    r = run_query(q, ds, 0)
    check_root0(r, levels, spec, label, real_positions(engine, r, id_to_pos))
    warm = warm_latency_ms(lambda: run_query(q, ds, 0))
    return exp_numbers(warm, profile_call(label, lambda: run_query(q, ds, 0),
                                          warm))


def exp_numbers(warm_ms: float, prof: dict) -> dict:
    """An experiment's numbers of one request from its warm ms and its
    :func:`profile_call`."""
    return {"warm_ms": warm_ms, "busy_ms": prof["device_ms"],
            "launches": prof["device_launches"],
            "idle_share": prof["idle_share"]}


def exp_line(name: str, fig: str, engines, payload_cols: int, baseline: str,
             ds, spec: TreeSpec, levels: list, id_to_pos: torch.Tensor,
             card: str, measured: dict) -> dict:
    """One of the paper's experiments on the card: each engine's numbers
    from ``measured`` (keyed by payload columns and engine), measured by
    :func:`exp_entry` where they are not there yet, and its speedup
    against ``baseline`` in warm and in busy ms.  Reports; it gates only
    the rows' correctness."""
    entries = {}
    for e in engines:
        if (payload_cols, e) not in measured:
            measured[payload_cols, e] = exp_entry(ds, e, payload_cols, spec,
                                                  levels, id_to_pos)
        entries[e] = dict(measured[payload_cols, e])
    base = entries[baseline]
    for entry in entries.values():
        entry[f"speedup_vs_{baseline}"] = base["warm_ms"] / entry["warm_ms"]
        entry[f"busy_speedup_vs_{baseline}"] = \
            base["busy_ms"] / entry["busy_ms"]
    return {"exp": name, "paper": fig, "payload_cols": payload_cols,
            "row_bytes": 4 * ds.rows.width, "root": 0, "depth": MAX_DEPTH,
            "caps": list(CAPS), "engines": entries, "card": card}


# ---------------------------------------------------------------------------

def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script drives the port on a CUDA card")
    device_name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # phase 1: the card and the kernels' build
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s for "
          f"{sorted(reports) or 'nothing (already built)'}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # data: the same numpy tree on the card and on the CPU, with the edge
    # weights made as benchmarks/exp_weighted.py makes them
    t0 = time.perf_counter()
    cols = make_edge_table(SPEC)
    cols[WEIGHT_COL] = np.random.default_rng(SPEC.seed + 1).uniform(
        0.5, 2.0, SPEC.num_edges).astype(np.float32)
    ds = dataset_from_numpy(cols, SPEC.num_vertices, DEVICE)
    ds_cpu = dataset_from_numpy(cols, SPEC.num_vertices, "cpu")
    torch.cuda.synchronize()
    table_mb = sum(c.nbytes for c in ds.table.columns.values()) / 2 ** 20
    print(f"data: {SPEC.num_edges} edges, {table_mb:.1f} MiB of columns on "
          f"the card, {time.perf_counter() - t0:.3f} s")
    levels = bfs_reference(cols["from"], cols["to"], 0, MAX_DEPTH,
                           SPEC.num_vertices)
    values = value_oracle(levels, cols, SPEC.num_vertices)
    requests = make_requests(cols, SPEC.num_vertices)
    dense_requests = make_dense_requests(cols, SPEC.num_vertices)
    weighted_requests = make_weighted_requests(SPEC.num_vertices)
    out_cols = query("precursive").out_cols
    forced_plans = {   # (expand_fn, pull_fn) -> the plan, pull forced
        "diropt": lambda expand_fn=None, pull_fn=None: diropt_plan(
            CAPS, MAX_DEPTH, out_cols, pull_fn=pull_fn, **FORCE_PULL),
        "diropt_hybrid": lambda expand_fn=None, pull_fn=None:
            diropt_hybrid_plan(CAPS, MAX_DEPTH, out_cols,
                               expand_fn=expand_fn, pull_fn=pull_fn,
                               **FORCE_PULL)}
    t0 = time.perf_counter()
    expected = run_requests(ds_cpu, requests)
    expected_dense = run_requests(ds_cpu, dense_requests)
    expected_forced = {name: execute(make(), ds_cpu.context(), 0,
                                     SPEC.num_vertices)
                       for name, make in forced_plans.items()}
    t1 = time.perf_counter()
    expected_weighted = run_requests(ds_cpu, weighted_requests)
    print(f"cpu reference: {len(requests) + len(dense_requests)} requests "
          f"and {len(forced_plans)} forced-pull runs in {t1 - t0:.3f} s, "
          f"{len(weighted_requests)} weighted requests in "
          f"{time.perf_counter() - t1:.3f} s (host clock)")
    # the paper's engines on the deployment's table as the paper has it,
    # without the weight column (47 slots a row)
    paper_cols = {k: v for k, v in cols.items() if k != WEIGHT_COL}
    paper_requests = make_paper_requests(SPEC.num_vertices)
    id_to_pos = inverse_ids(cols)
    t0 = time.perf_counter()
    expected_paper = run_requests(
        dataset_from_numpy(paper_cols, SPEC.num_vertices, "cpu"),
        paper_requests)
    print(f"cpu reference: {len(paper_requests)} tuple and row-store "
          f"requests in {time.perf_counter() - t0:.3f} s (host clock)")

    # DeepFM at Criteo width: random weights on the card from a seeded CUDA
    # generator, copied to the CPU for the port's CPU run; TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    params = recsys.init_deepfm(
        DEEPFM, torch.Generator(device=DEVICE).manual_seed(PARAM_SEED),
        DEVICE)
    params_cpu = {k: (v.cpu() if k != "mlp" else
                      [{n: t.cpu() for n, t in lp.items()} for lp in v])
                  for k, v in params.items()}
    offsets_np = recsys.field_offsets(DEEPFM)
    offsets = torch.from_numpy(offsets_np).to(DEVICE)
    offsets_cpu = torch.from_numpy(offsets_np)
    recsys_requests = make_recsys_requests()
    t1 = time.perf_counter()
    expected_recsys = [serve(params_cpu, offsets_cpu, req)
                       for req in recsys_requests]
    expected_positions = [recsys.featurize(DEEPFM, req.dense, req.sparse,
                                           offsets_cpu)
                          for req in recsys_requests]
    print(f"deepfm: {recsys.total_rows(DEEPFM)} x {DEEPFM.embed_dim} "
          f"{DEEPFM.table_dtype} table "
          f"({params['table'].nbytes / 2 ** 20:.1f} MiB), MLP "
          f"{list(DEEPFM.mlp_dims)}, made in {t1 - t0:.3f} s; cpu reference "
          f"of {len(recsys_requests)} requests in "
          f"{time.perf_counter() - t1:.3f} s (host clock)")

    # phase 2: each kernel against its plain version on the card
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    targets, valid, level, emitted = widest_level(expected[0], cols,
                                                  CAPS.frontier)
    print(f"frontier_expand input: level {level} of root 0, "
          f"{int(valid.sum())} targets -> {emitted} edges")
    fe, fe_cases, fe_call = frontier_expand_phase(
        ds, targets, valid, CAPS.frontier, emitted, flush)
    print("frontier_expand cases: " + json.dumps(fe_cases))
    lg, lg_cases = late_gather_phase(ds, expected[0].positions.to(DEVICE),
                                     out_cols, flush)
    print("late_gather cases: " + json.dumps(lg_cases))
    diropt_root0 = expected_dense[DENSE_ENGINES.index("diropt") * 4]
    fp, fp_cases, fp_calls = frontier_pull_phase(
        ds, *pull_input(diropt_root0, cols, SPEC.num_vertices), flush)
    print(f"frontier_pull input: {fp['shape']}")
    print(f"frontier_pull hub input: {fp['hub']['shape']}")
    print("frontier_pull cases: " + json.dumps(fp_cases))
    # the lane axis of both per-level kernels: the batch's lanes at root
    # 0's widest expansion level and at diropt root 0's first pull level
    eight = batch_roots(cols, SPEC.num_vertices)
    lane_t, lane_v, lane_emitted = lane_targets(expected[:BATCH_ROOTS], cols,
                                                level, CAPS.frontier)
    fe_lanes, fe_lane_cases, fe_lane_call = frontier_expand_lane_phase(
        ds, lane_t, lane_v, CAPS.frontier, lane_emitted, flush)
    print("frontier_expand lane cases: " + json.dumps(fe_lane_cases))
    pull_level = pull_input(diropt_root0, cols, SPEC.num_vertices)[2]
    fp_lanes, fp_lane_cases, fp_lane_call = frontier_pull_lane_phase(
        ds, *pull_lane_input(expected[:BATCH_ROOTS], eight, cols,
                             SPEC.num_vertices, pull_level),
        pull_level, flush)
    print("frontier_pull lane cases: " + json.dumps(fp_lane_cases))
    fe["lanes"], fp["lanes"] = fe_lanes, fp_lanes
    bitmap_sum0 = expected_weighted[weighted_requests.index(
        Request("bitmap", "outbound", 0, "aggregate_sum"))]
    sp, sp_cases, sp_calls = spmm_segment_phase(bitmap_sum0, cols,
                                                SPEC.num_vertices, flush)
    print("spmm_segment cases: " + json.dumps(sp_cases))
    print("spmm_segment tile cases: "
          + json.dumps(spmm_tile_cases_on_card()))
    # the lane axis of spmm_segment: the aggregate_sum batch's lanes at
    # root 0's widest dense level
    sum_count = int(bitmap_sum0.count)
    sum_level = int(torch.bincount(bitmap_sum0.row_depths[:sum_count])
                    .argmax())
    sp_lanes, sp_lane_cases, sp_lane_call = spmm_segment_lane_phase(
        ds, *spmm_lane_input(expected[:BATCH_ROOTS], eight, cols,
                             SPEC.num_vertices, sum_level),
        sum_level, flush)
    print("spmm_segment lane cases: " + json.dumps(sp_lane_cases))
    sp["lanes"] = sp_lanes
    bulk = recsys_requests[P99_REQUESTS]
    bulk_pos = recsys.featurize(DEEPFM, bulk.dense.to(DEVICE),
                                bulk.sparse.to(DEVICE), offsets)
    eb, eb_cases, (bag_idx, bag_seg, bag_sums), eb_calls = \
        embedding_bag_phase(params["table"], bulk_pos, flush)
    print("embedding_bag cases: " + json.dumps(eb_cases))
    print("embedding_bag layout cases: "
          + json.dumps(embedding_bag_layout_cases_on_card()))
    lg_deepfm = late_gather_case([params["table"]], bag_idx, flush)
    print("late_gather deepfm case: " + json.dumps(lg_deepfm))
    kernels = {"frontier_expand": fe, "late_gather": lg,
               "frontier_pull": fp, "spmm_segment": sp, "embedding_bag": eb}

    # phase 3: each path at full size; the counters see only that path
    torch.cuda.reset_peak_memory_stats()
    by_path = {}
    paths = (("precursive", requests, expected),
             ("dense", dense_requests, expected_dense),
             ("weighted", weighted_requests, expected_weighted))
    got = {}
    for label, reqs, want in paths:
        reset_launches()
        got[label] = run_requests(ds, reqs)
        by_path[label] = read_launches()
        check_path(label, reqs, got[label], want, by_path[label],
                   expected_launches(reqs, want, SPEC.num_vertices), levels,
                   values, id_to_pos)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    # DeepFM serving, then the embedding_bag op as its users call it
    torch.cuda.reset_peak_memory_stats()
    held_mb = torch.cuda.memory_allocated() / 2 ** 20
    reset_launches()
    got_recsys = [serve(params, offsets, req) for req in recsys_requests]
    by_path["recsys"] = read_launches()
    recsys_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 - held_mb
    positions = [recsys.featurize(DEEPFM, req.dense.to(DEVICE),
                                  req.sparse.to(DEVICE), offsets)
                 for req in recsys_requests]
    flips = check_recsys(recsys_requests, got_recsys, expected_recsys,
                         positions, expected_positions)
    n_serve = sum(1 for req in recsys_requests if req.cand is None)
    require(by_path["recsys"] == {**dict.fromkeys(KERNEL_OPS, 0),
                                  "late_gather": n_serve},
            f"recsys path: launches {by_path['recsys']}, want late_gather "
            f"once per serve_scores call ({n_serve}) and nothing else")
    print(f"recsys path: {len(recsys_requests)} requests equal to the CPU "
          f"run (scores within {DEEPFM_TOL} where positions agree); bucket "
          f"flips {json.dumps(flips)}; launches "
          f"{json.dumps(by_path['recsys'])}; peak device memory "
          f"{recsys_peak_mb:.1f} MiB above the {held_mb:.1f} MiB held "
          f"before the path (the DeepFM parameters "
          f"{params_mb(params):.1f} MiB, the rest earlier phases')")
    reset_launches()
    got_bags = eb_ops.embedding_bag(params["table"], bag_idx, bag_seg,
                                    BULK_BATCH)
    by_path["bags"] = read_launches()
    require(torch.equal(got_bags, bag_sums),
            "bags path: the op differs from phase 2's call")
    require(by_path["bags"] == {**dict.fromkeys(KERNEL_OPS, 0),
                                "embedding_bag": 1},
            f"bags path: launches {by_path['bags']}")
    print(f"bags path: embedding_bag over {bag_idx.shape[0]} positions "
          f"into {BULK_BATCH} bags equal to phase 2; launches "
          f"{json.dumps(by_path['bags'])}")

    # batched roots: each call's counters zeroed just before it and read
    # just after, summed into the batch path
    by_path["batch"] = dict.fromkeys(KERNEL_OPS, 0)
    batch_lines = {}
    for b in make_batches(cols, SPEC.num_vertices):
        line = run_batch(ds, b, levels, card)
        batch_lines[str(b)] = line
        for name, n in line["launches"].items():
            by_path["batch"][name] += n
        print("batch: " + json.dumps(line))

    # the paper's tuple-based and row-store engines: their table and its
    # row table come to the card after the paths above, whose peak memory
    # they leave as it was; the row table is built on the first row-store
    # request
    t_paper = time.perf_counter()
    ds_paper = dataset_from_numpy(paper_cols, SPEC.num_vertices, DEVICE)
    reset_launches()
    got["paper"] = run_requests(ds_paper, paper_requests)
    by_path["paper"] = read_launches()
    check_path("paper", paper_requests, got["paper"], expected_paper,
               by_path["paper"], expected_launches(
                   paper_requests, expected_paper, SPEC.num_vertices),
               levels, values, id_to_pos)
    rows_pos, rows_level = widest_row_block(
        got["paper"][VALUE_ENGINE_NAMES.index("rowstore")], id_to_pos,
        CAPS.frontier, SPEC.num_edges)
    lg["rows_case"] = late_gather_case([ds_paper.rows.data],
                                       rows_pos.to(DEVICE), flush)
    lg["rows_case"]["shape"] += f" level={rows_level} (rowstore root 0)"
    print("late_gather rows case: " + json.dumps({**lg["rows_case"],
                                                  "card": card}))
    paper_s = time.perf_counter() - t_paper

    dense_got = dict(zip(dense_requests, got["dense"]))
    for req, r in dense_got.items():
        if req.engine in PUSH_COUNTERPART:
            twin = req._replace(engine=PUSH_COUNTERPART[req.engine])
            require_same_rows(r, dense_got[twin], str(req))
    root0_pulls = sum(1 for d in dense_got[Request("diropt", "outbound", 0)]
                      .level_dirs.tolist() if d == 1)
    require(root0_pulls >= 2, f"diropt root 0 pulled {root0_pulls} levels")

    # the switch forced to pull on every level, root 0 outbound
    for name, make in forced_plans.items():
        reset_launches()
        r = execute(make(expand_fn=fe_ops.frontier_expand_fused,
                         pull_fn=fp_ops.frontier_pull_fused),
                    ds.context(), 0, SPEC.num_vertices)
        pulls = read_launches()["frontier_pull"]
        label = f"{name} forced pull root 0"
        require_equal(r, expected_forced[name], label)
        require(bool((r.level_dirs[:int(r.depth)] == 1).all()),
                f"{label}: a level was not pulled")
        require(pulls == int(r.depth),
                f"{label}: frontier_pull launched {pulls} times for "
                f"{int(r.depth)} levels")
        require_same_rows(r, dense_got[Request(PUSH_COUNTERPART[name],
                                               "outbound", 0)], label)
        print(f"{label}: {int(r.depth)} pull levels, equal to the CPU run "
              f"and to {PUSH_COUNTERPART[name]}")

    warm = {}
    all_requests = requests + dense_requests + weighted_requests
    for req, r in zip(all_requests, got["precursive"] + got["dense"]
                      + got["weighted"]):
        if req.workload == "reach" and req.engine != "precursive" and \
                (req.direction, req.root) != ("outbound", 0):
            continue
        warm[req] = warm_latency_ms(lambda req=req: run_request(ds, req))
        dirs = ("" if r.level_dirs is None else
                f" level_dirs {r.level_dirs[:int(r.depth)].tolist()}")
        print(f"request {req}: count {int(r.count)} depth {int(r.depth)} "
              f"overflow {bool(r.overflow)} warm latency {warm[req]:.3f} ms "
              f"(median of 3, host clock){dirs}")
    layouts_mb = {d: l.nbytes / 2 ** 20 for d, l in ds.pull_layouts.items()}
    for req, r in zip(paper_requests, got["paper"]):
        warm[req] = warm_latency_ms(lambda req=req: run_request(ds_paper,
                                                                req))
        print(f"request {req}: count {int(r.count)} depth {int(r.depth)} "
              f"overflow {bool(r.overflow)} warm latency {warm[req]:.3f} ms "
              f"(median of 3, host clock)")
    print(f"main path: {len(all_requests)} requests equal to the CPU run; "
          f"peak device memory {peak_mb:.1f} MiB, frontier_pull layouts "
          f"{json.dumps(layouts_mb)} MiB of it")
    # every engine's root 0 (PERF.md's limit reads these), the fused view's
    # widest PRecursive request, the two weighted paths' root 0, and the
    # inbound aggregate_sum whose kernel rows are skewed (vertex 0 owns
    # 83,619 inbound edges)
    measured = {}       # (payload columns, engine) -> Exp 1-3 numbers
    for req in [Request("precursive", "outbound", 0),
                Request("precursive", "both", SPEC.num_vertices - 1),
                *(Request(engine, "outbound", 0) for engine in DENSE_ENGINES),
                Request("precursive", "outbound", 0, "shortest_path"),
                Request("bitmap", "outbound", 0, "aggregate_sum"),
                Request("bitmap", "inbound", SPEC.num_vertices - 1,
                        "aggregate_sum")]:
        prof = profile_call(str(req), lambda req=req: run_request(ds, req),
                            warm[req])
        print("profile: " + json.dumps(prof))
        if req == Request("precursive", "outbound", 0):
            # PRecursive reads no weight, so its Exp 2-3 request is this
            measured[SPEC.payload_cols, req.engine] = exp_numbers(warm[req],
                                                                  prof)

    forced = forced_plans["diropt"](expand_fn=fe_ops.frontier_expand_fused,
                                    pull_fn=fp_ops.frontier_pull_fused)

    def forced_call():
        return execute(forced, ds.context(), 0, SPEC.num_vertices)
    ms = warm_latency_ms(forced_call)
    label = "diropt forced pull root 0"
    print(f"request {label}: warm latency {ms:.3f} ms (median of 3, host "
          f"clock)")
    print("profile: " + json.dumps(profile_call(label, forced_call, ms)))

    one_p99, retrieval = recsys_requests[0], recsys_requests[-1]
    for req in (one_p99, bulk, retrieval):
        def fn(req=req):
            return serve(params, offsets, req)
        ms = warm_latency_ms(fn)
        print(f"request {req}: warm latency {ms:.3f} ms (median of 3, host "
              f"clock, the features' copy to the card included)")
        print("profile: " + json.dumps(profile_call(str(req), fn, ms)))

    def bags_call():
        return eb_ops.embedding_bag(params["table"], bag_idx, bag_seg,
                                    BULK_BATCH)
    ms = warm_latency_ms(bags_call)
    label = f"embedding_bag bags B={BULK_BATCH} I={bag_idx.shape[0]}"
    print(f"request {label}: warm latency {ms:.3f} ms (median of 3, host "
          f"clock, the wrapper's sort included)")
    print("profile: " + json.dumps(profile_call(label, bags_call, ms)))
    for engine in ("precursive", "diropt"):
        b = Batch(engine, "outbound", tuple(eight))

        def batch_call(b=b):
            return run_query_batch(query(b.engine, b.direction), ds,
                                   list(b.roots))
        print("profile: " + json.dumps({**profile_call(
            f"batch {b}", batch_call, batch_lines[str(b)]["warm_ms"]),
            "card": card}))

    t0 = time.perf_counter()
    for req in paper_requests:
        prof = profile_call(str(req), lambda req=req: run_request(ds_paper,
                                                                  req),
                            warm[req])
        print("profile: " + json.dumps({**prof, "card": card}))
        if (req.direction, req.root) == ("outbound", 0):
            measured[SPEC.payload_cols, req.engine] = exp_numbers(warm[req],
                                                                  prof)
    profiles_s = time.perf_counter() - t0

    # the paper's Exp 1-3; Exp 1 on the same tree with no payload column:
    # make_edge_table draws the payload columns last, so that table is
    # this one less them
    spec0 = SPEC._replace(payload_cols=0)
    ds0 = dataset_from_numpy({k: cols[k] for k in ("id", "from", "to",
                                                   "name")},
                             spec0.num_vertices, DEVICE)
    for name, fig, engines, payload, baseline in EXPERIMENTS:
        on = (ds0, spec0, levels, id_to_pos) if payload == 0 \
            else (ds_paper, SPEC, levels, id_to_pos)
        print(f"{name}: " + json.dumps(exp_line(
            name, fig, engines, payload, baseline, *on, card, measured)))
    del ds0
    print(f"paper engines: {paper_s:.3f} s for their path and the rows "
          f"case, {profiles_s:.3f} s for their warm and profile lines, "
          f"{time.perf_counter() - t0 - profiles_s:.3f} s for Exp 1-3 "
          f"(host clock)")

    fe.update(expand_profile(fe_call, flush))
    sp["profile"] = spmm_profile(sp_calls, flush)
    print("spmm_segment profile: " + json.dumps(sp["profile"]))
    eb_profile = bag_profile(eb_calls, flush)
    eb["kernel_device_ms"] = eb_profile["a"]["kernel_device_ms"]
    print("embedding_bag profile: " + json.dumps(
        {case: {"ms": eb_cases[case]["ms"], **p}
         for case, p in eb_profile.items()}))
    fp_profile = pull_profile(fp_calls, flush)
    fp["kernel_device_ms"] = \
        fp_profile["main"]["device_ms_by_kernel"]["frontier_pull_rows"]
    fp["device_launches_per_call"] = \
        fp_profile["main"]["device_launches_per_call"]
    print("frontier_pull profile: " + json.dumps(fp_profile))
    # the lane axis keeps one lane's device launches: 3, and 1 for the
    # pull over the outbound layout, which has no hub tile
    fe_lanes.update(expand_profile(fe_lane_call, flush))
    fp_lanes.update(pull_profile({"lanes": fp_lane_call}, flush)["lanes"])
    print("frontier_expand lanes: " + json.dumps({**fe_lanes,
                                                  "card": card}))
    print("frontier_pull lanes: " + json.dumps({**fp_lanes, "card": card}))
    sp_lanes.update(spmm_profile({"lanes": sp_lane_call}, flush)["lanes"])
    print("spmm_segment lanes: " + json.dumps({**sp_lanes, "card": card}))
    # the weighted and value-engine batches after every earlier profile
    # line, whose numbers their memory stays out of
    value_batch_phase(ds, ds_paper, cols, levels, values, id_to_pos, card,
                      by_path)
    # MS-BFS and the bucket executor last: their host and device memory
    # stay out of every earlier path's numbers
    multiquery_phase(ds_paper, paper_cols, levels, card, by_path)
    del ds_paper
    for name, entry in kernels.items():
        entry["launches"] = sum(n[name] for n in by_path.values())
        entry["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
        require(entry["launches"] > 0, f"{name} was never launched")
    require(by_path["weighted"]["spmm_segment"] > 0,
            "the weighted path never launched spmm_segment")
    require(by_path["batch_values"]["spmm_segment"] > 0,
            "the weighted batches never launched spmm_segment")
    for path, n in by_path.items():
        require((n["embedding_bag"] > 0) == (path == "bags"),
                f"{path} path: embedding_bag launched {n['embedding_bag']} "
                f"times")
    print(f"script: {time.perf_counter() - t_start:.3f} s from the build "
          f"on (host clock)")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
