"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. print the card's name and power limit; build the CUDA kernels with
   ``nvcc`` from ``src/repro_torch/csrc`` and time the build;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (exact equality; ``spmm_segment`` also on two random
   graphs with in-degree > 1 and on the tree's inbound view, whose vertex
   0 owns 83,619 edges, within rtol = atol = 1e-5), and time the kernel,
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
   just after) must show it went through its kernels; warm latencies and
   ``torch.profiler`` lines follow;
4. print one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line last.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.convert import dataset_from_numpy  # noqa: E402
from repro_torch.core.bitmap import (diropt_hybrid_plan,  # noqa: E402
                                     diropt_plan)
from repro_torch.core.csr import csr_degrees, expand_frontier  # noqa: E402
from repro_torch.core.engine import (PUSH_COUNTERPART,  # noqa: E402
                                     EngineCaps, RecursiveQuery, build_plan,
                                     run_query)
from repro_torch.core.operators import execute  # noqa: E402
from repro_torch.data.treegen import (TreeSpec, bfs_reference,  # noqa: E402
                                      make_edge_table)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.frontier_expand import ops as fe_ops  # noqa: E402
from repro_torch.kernels.frontier_expand.frontier_expand import \
    expand_index_cuda  # noqa: E402
from repro_torch.kernels.frontier_pull import ops as fp_ops  # noqa: E402
from repro_torch.kernels.frontier_pull.ref import \
    frontier_pull_ref  # noqa: E402
from repro_torch.kernels.late_gather import ops as lg_ops  # noqa: E402
from repro_torch.kernels.late_gather.ref import late_gather_ref  # noqa: E402
from repro_torch.kernels.spmm_segment import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.spmm_segment.ref import \
    spmm_segment_ref  # noqa: E402

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
DENSE_ENGINES = ("bitmap", "hybrid", "diropt", "diropt_hybrid")
FORCE_PULL = dict(alpha=1e9, beta=1e9)
SEMIRINGS = ("shortest_path", "aggregate_sum", "aggregate_max",
             "aggregate_min", "aggregate_mul")
WEIGHT_COL = "w"
SPMM_TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_semiring.py's


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


def query(engine: str, direction: str = "outbound",
          workload: str = "reach") -> RecursiveQuery:
    return RecursiveQuery(engine, MAX_DEPTH, SPEC.payload_cols, CAPS,
                          direction=direction, workload=workload,
                          weight_col=None if workload == "reach"
                          else WEIGHT_COL)


def run_request(ds, req: Request):
    return run_query(query(req.engine, req.direction, req.workload), ds,
                     req.root)


def run_requests(ds, requests) -> list:
    return [run_request(ds, req) for req in requests]


KERNEL_OPS = {"frontier_expand": fe_ops, "late_gather": lg_ops,
              "frontier_pull": fp_ops, "spmm_segment": spmm_ops}


def reset_launches() -> None:
    for ops in KERNEL_OPS.values():
        ops.LAUNCHES = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: ops.LAUNCHES for name, ops in KERNEL_OPS.items()}


def expected_launches(requests, results, num_vertices: int) -> dict:
    """The launches the card's run of ``requests`` must make, read off the
    CPU run's results: ``frontier_expand`` once per executed level of
    PRecursive (weighted or not) and per sparse (positional) push level of
    the hybrid engines, ``frontier_pull`` once per pull level, both only
    outside the fused ``both`` view (which has no kernel, as in the
    reference); ``spmm_segment`` once per executed level of a ``bitmap``
    aggregate_sum request; ``late_gather`` once per output column per
    request.  A hybrid level is sparse when its frontier block, the rows
    first emitted at that level, is below :func:`hybrid_threshold`."""
    expand = pull = spmm = 0
    for req, r in zip(requests, results):
        engine, depth = req.engine, int(r.depth)
        if req.workload == "aggregate_sum" and engine == "bitmap":
            spmm += depth
        if req.direction == "both":
            continue
        if engine == "precursive":
            expand += depth
            continue
        dirs = (r.level_dirs.tolist() if r.level_dirs is not None
                else [0] * depth)
        widths = torch.bincount(r.row_depths[:int(r.count)].long(),
                                minlength=depth).tolist()
        for d in range(depth):
            if dirs[d] == 1:
                pull += 1
            elif engine in ("hybrid", "diropt_hybrid") and \
                    widths[d] < hybrid_threshold(engine, num_vertices):
                expand += 1
    n_cols = len(query("precursive").out_cols)
    return {"frontier_expand": expand, "late_gather": n_cols * len(requests),
            "frontier_pull": pull, "spmm_segment": spmm}


def hybrid_threshold(engine: str, num_vertices: int) -> int:
    """The frontier size below which the engine's ``HybridStep`` (alone,
    or the push side of its ``DirectionSwitch``) takes its sparse branch,
    read off the plan ``run_query`` builds."""
    step = build_plan(query(engine)).ops[0]
    step = getattr(step, "push", step)
    return max(1, int(num_vertices * step.switch_frac))


def require_equal(a, b, label: str) -> None:
    """Field-for-field, bit-for-bit equality of two BFSResults."""
    for field in ("positions", "count", "depth", "overflow", "row_depths",
                  "level_dirs", "vertex_values"):
        x, y = getattr(a, field), getattr(b, field)
        if x is None or y is None:
            require(x is None and y is None, f"{label}: field {field}")
            continue
        x, y = x.cpu(), y.cpu()
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"{label}: field {field} differs from the CPU run")
    require(a.values.keys() == b.values.keys(), f"{label}: value columns")
    for k in a.values:
        x, y = a.values[k].cpu(), b.values[k].cpu()
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"{label}: column {k} differs from the CPU run")


def require_same_rows(a, b, label: str) -> None:
    """The rows, their order and depths, and the loop accounting of two
    results (a direction-optimizing engine and its push-only twin)."""
    for field in ("positions", "count", "depth", "overflow", "row_depths"):
        require(torch.equal(getattr(a, field), getattr(b, field)),
                f"{label}: field {field} differs from the push-only engine")
    for k in a.values:
        require(torch.equal(a.values[k], b.values[k]),
                f"{label}: column {k} differs from the push-only engine")


def check_result_shape(r, caps: EngineCaps, label: str) -> None:
    require(r.positions.shape == (caps.result,), f"{label}: positions shape")
    for k, v in r.values.items():
        require(v.shape[0] == caps.result, f"{label}: column {k} shape")
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f"{label}: {k} not finite")


def check_root0(r, levels: list, spec: TreeSpec, label: str) -> None:
    """Root 0 reaches the whole tree without overflow, level by level equal
    to the pure-Python BFS oracle's ``levels``."""
    count = int(r.count)
    require(count == spec.num_edges,
            f"{label}: count {count} != {spec.num_edges}")
    require(not bool(r.overflow), f"{label} overflowed")
    pos = r.positions[:count].cpu().numpy()
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

def frontier_expand_phase(ds, targets, valid, capacity, emitted, flush):
    csr = ds.csr
    t, v = targets.to(DEVICE), valid.to(DEVICE)
    got = fe_ops.frontier_expand_fused(csr, t, v, capacity)
    want = expand_frontier(csr, t, v, capacity)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("positions", "total", "overflow")):
        require(torch.equal(g, w), f"frontier_expand: {name} differs")
    require(int(got[1]) == emitted, "frontier_expand: level total")
    err = max_abs_err(got[0], want[0])

    deg = csr_degrees(csr, t, v)
    ends = torch.cumsum(deg, 0, dtype=torch.int32)
    estart = torch.where(deg > 0, csr.indptr[t.clamp(0)], 0)
    live = int(v.sum())
    # targets + valid read once, two indptr entries per live target, the
    # reached perm entries, the (capacity,) output written once
    nbytes = capacity * 5 + live * 8 + min(emitted, capacity) * 4 \
        + capacity * 4
    return {
        "name": "frontier_expand", "route": "cuda",
        "source": "src/repro_torch/csrc/frontier_expand.cu",
        "replaces": "src/repro/kernels/frontier_expand/frontier_expand.py:84",
        "max_abs_err": err,
        "ms": time_ms(lambda: fe_ops.frontier_expand_fused(csr, t, v,
                                                           capacity), flush),
        "kernel_only_ms": time_ms(lambda: expand_index_cuda(
            ends, estart, deg, csr.perm, capacity), flush),
        "plain_ms": time_ms(lambda: expand_frontier(csr, t, v, capacity),
                            flush),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None,
        "shape": f"F={capacity} live={live} emitted={emitted} "
                 f"E={csr.num_edges}",
    }


def late_gather_case(table: torch.Tensor, positions: torch.Tensor, flush):
    got = lg_ops.late_gather(table, positions)
    want = late_gather_ref(table, positions)
    torch.cuda.synchronize()
    require(got.dtype == want.dtype and torch.equal(got, want),
            f"late_gather {table.dtype} {tuple(table.shape)} differs")
    r, w = table.shape
    p = positions.shape[0]
    live = int(((positions >= 0) & (positions < r)).sum())
    elt = table.element_size()
    safe = positions.clamp(0, r - 1)
    return {
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(lambda: lg_ops.late_gather(table, positions), flush),
        "plain_ms": time_ms(lambda: late_gather_ref(table, positions),
                            flush),
        "library_ms": time_ms(lambda: torch.index_select(table, 0, safe),
                              flush),
        # positions read once, live rows read once, every output row
        # written once
        "bound_ms": bound_ms(p * 4 + live * w * elt + p * w * elt),
        "bound_by": "bytes",
        "shape": f"R={r} W={w} P={p} live={live} {str(table.dtype)[6:]}",
    }


def late_gather_phase(ds, positions, flush):
    payload = ds.table.column("column1")
    cases = {
        "f32": late_gather_case(payload, positions, flush),
        "int32": late_gather_case(ds.table.column("id")[:, None], positions,
                                  flush),
        "bf16": late_gather_case(payload.to(torch.bfloat16), positions,
                                 flush),
    }
    entry = {
        "name": "late_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/late_gather.cu",
        "replaces": "src/repro/kernels/late_gather/late_gather.py:34",
        **cases["f32"],
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


def frontier_pull_phase(ds, frontier, visited, level, flush):
    ds.ensure_reverse()
    rcsr = ds.rcsr
    src, dst = ds.table.column("from"), ds.table.column("to")
    f, v = frontier.to(DEVICE), visited.to(DEVICE)
    got = fp_ops.frontier_pull_fused(rcsr, src, dst, f, v)
    want = frontier_pull_ref(rcsr, src, dst, f, v)
    torch.cuda.synchronize()
    require(got.dtype == want.dtype and torch.equal(got, want),
            "frontier_pull differs from its plain version")
    e, nv = rcsr.num_edges, f.shape[0]
    vtx = dst[rcsr.perm].clamp(0, nv - 1)
    nbr = src[rcsr.perm].clamp(0, nv - 1)
    # what this run needs: join_src only at the entries whose vertex is
    # unvisited, and the frontier bytes of their in-neighbors, each once
    open_entries = ~v[vtx]
    pending = int(open_entries.sum())
    needed = int(torch.unique(nbr[open_entries]).numel())
    # perm and join_dst in full, visited once, the needed join_src entries
    # and frontier bytes, the (V,) output written once
    nbytes = e * 4 + e * 4 + nv + pending * 4 + needed + nv
    return {
        "name": "frontier_pull", "route": "cuda",
        "source": "src/repro_torch/csrc/frontier_pull.cu",
        "replaces": "src/repro/kernels/frontier_pull/frontier_pull.py:60",
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(lambda: fp_ops.frontier_pull_fused(rcsr, src, dst, f,
                                                         v), flush),
        "plain_ms": time_ms(lambda: frontier_pull_ref(rcsr, src, dst, f, v),
                            flush),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None,
        "shape": f"E={e} V={nv} level={level} frontier={int(f.sum())} "
                 f"unvisited={int((~v).sum())} open_entries={pending} "
                 f"needed={needed} "
                 f"next={int(got.sum())}",
    }


def spmm_case(x, src, dst, w, num_out: int, check: str, flush) -> dict:
    """``spmm_segment`` against its plain version on the card, ``check``
    ``exact``, ``close`` (SPMM_TOL) or ``scaled`` (within 1e-5 of each
    row's sum of absolute terms, for rows of thousands of edges).  ``ms`` is
    the call the engine makes each level (the kernel on edges already in
    destination order); ``wrapper_ms`` adds the wrapper's stable sort;
    ``library_ms`` is ``torch.sparse.mm`` of the (num_out x N) CSR matrix
    of the live edges' weights, built outside the timed region."""
    n, d = x.shape
    seg = spmm_ops.segments(dst, num_out)
    s_src, s_w = src[seg.order], w[seg.order]
    got = spmm_ops.spmm_segment_sorted(x, s_src, seg.seg, s_w, seg.offsets)
    via_wrapper = spmm_ops.spmm_segment(x, src, dst, w, num_out)
    want = spmm_segment_ref(x, src, dst, w, num_out)
    torch.cuda.synchronize()
    label = f"spmm_segment N={n} E={src.shape[0]} D={d}"
    require(torch.equal(got, via_wrapper), f"{label}: wrapper differs")
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
    return {
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(lambda: spmm_ops.spmm_segment_sorted(
            x, s_src, seg.seg, s_w, seg.offsets), flush),
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
    }


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


def spmm_segment_phase(r, cols: dict, num_vertices: int, flush):
    x, src, dst, w, level = spmm_main_input(r, cols, num_vertices)
    frm = torch.from_numpy(cols["from"])
    x_random = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (num_vertices, 1), dtype=np.float32))
    main = spmm_case(x.to(DEVICE), src.to(DEVICE), dst.to(DEVICE),
                     w.to(DEVICE), num_vertices, "exact", flush)
    main["shape"] += f" level={level}"
    cases = {
        "a": main,
        "b": spmm_case(*spmm_random_input(2, 1 << 20, 1 << 22, 1), 1 << 20,
                       "close", flush),
        "c": spmm_case(*spmm_random_input(3, 1 << 16, 1 << 18, 128),
                       1 << 16, "close", flush),
        # the inbound view: every edge live, grouped by its `from` vertex
        "d": spmm_case(x_random.to(DEVICE), dst.to(DEVICE),
                       frm.to(DEVICE), w.to(DEVICE), num_vertices, "scaled",
                       flush),
    }
    entry = {
        "name": "spmm_segment", "route": "cuda",
        "source": "src/repro_torch/csrc/spmm_segment.cu",
        "replaces": "src/repro/kernels/spmm_segment/spmm_segment.py:43",
        **main,
    }
    return entry, cases


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


def profile_request(ds, req: Request, warm_ms: float) -> dict:
    """Where one warm request's time goes: device time per kernel from
    ``torch.profiler``, and the device's idle share against the request's
    unprofiled warm latency ``warm_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_request(ds, req)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, fills): the host ops that
    # launched them carry the same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {
        "request": str(req), "warm_ms": warm_ms,
        "device_ms": device_ms,
        "idle_share": 1 - device_ms / warm_ms if device_ms else None,
        "device_launches": sum(e.count for e in kernels),
        "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                for e in top],
    }


def warm_latency_ms(ds, req: Request) -> float:
    """Median of 3 warm runs, host clock around the request and a sync."""
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_request(ds, req)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def check_path(label, requests, got, expected, launches, want_launches,
               levels, values) -> None:
    """One path's results against the CPU run, its root-0 rows against
    the BFS oracle (and its root-0 vertex values against ``values``), and
    its launch counts against the CPU run's levels."""
    for req, r, want in zip(requests, got, expected):
        check_result_shape(r, CAPS, str(req))
        require_equal(r, want, str(req))
        if req.direction == "outbound" and req.root == 0:
            check_root0(r, levels, SPEC, str(req))
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

def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script drives the port on a CUDA card")
    device_name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # phase 1: the card and the kernels' build
    print(card_line(), flush=True)
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

    # phase 2: each kernel against its plain version on the card
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    targets, valid, level, emitted = widest_level(expected[0], cols,
                                                  CAPS.frontier)
    print(f"frontier_expand input: level {level} of root 0, "
          f"{int(valid.sum())} targets -> {emitted} edges")
    fe = frontier_expand_phase(ds, targets, valid, CAPS.frontier, emitted,
                               flush)
    lg, lg_cases = late_gather_phase(ds, expected[0].positions.to(DEVICE),
                                     flush)
    print("late_gather cases: " + json.dumps(lg_cases))
    diropt_root0 = expected_dense[DENSE_ENGINES.index("diropt") * 4]
    fp = frontier_pull_phase(ds, *pull_input(diropt_root0, cols,
                                             SPEC.num_vertices), flush)
    print(f"frontier_pull input: {fp['shape']}")
    bitmap_sum0 = expected_weighted[weighted_requests.index(
        Request("bitmap", "outbound", 0, "aggregate_sum"))]
    sp, sp_cases = spmm_segment_phase(bitmap_sum0, cols, SPEC.num_vertices,
                                      flush)
    print("spmm_segment cases: " + json.dumps(sp_cases))
    kernels = {"frontier_expand": fe, "late_gather": lg,
               "frontier_pull": fp, "spmm_segment": sp}

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
                   values)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for name, entry in kernels.items():
        entry["launches"] = sum(n[name] for n in by_path.values())
        entry["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
        require(entry["launches"] > 0, f"{name} was never launched")
    require(by_path["weighted"]["spmm_segment"] > 0,
            "the weighted path never launched spmm_segment")
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
        warm[req] = warm_latency_ms(ds, req)
        dirs = ("" if r.level_dirs is None else
                f" level_dirs {r.level_dirs[:int(r.depth)].tolist()}")
        print(f"request {req}: count {int(r.count)} depth {int(r.depth)} "
              f"overflow {bool(r.overflow)} warm latency {warm[req]:.3f} ms "
              f"(median of 3, host clock){dirs}")
    print(f"main path: {len(all_requests)} requests equal to the CPU run; "
          f"peak device memory {peak_mb:.1f} MiB")
    # every engine's root 0 (PERF.md's limit reads these), the fused view's
    # widest PRecursive request, the two weighted paths' root 0, and the
    # inbound aggregate_sum whose kernel rows are skewed (vertex 0 owns
    # 83,619 inbound edges)
    for req in [Request("precursive", "outbound", 0),
                Request("precursive", "both", SPEC.num_vertices - 1),
                *(Request(engine, "outbound", 0) for engine in DENSE_ENGINES),
                Request("precursive", "outbound", 0, "shortest_path"),
                Request("bitmap", "outbound", 0, "aggregate_sum"),
                Request("bitmap", "inbound", SPEC.num_vertices - 1,
                        "aggregate_sum")]:
        print("profile: " + json.dumps(profile_request(ds, req, warm[req])))

    print(f"script: {time.perf_counter() - t_start:.3f} s from the build "
          f"on (host clock)")
    print(json.dumps({"kernels": [fe, lg, fp, sp]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
