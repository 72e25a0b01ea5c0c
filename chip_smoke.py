"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. print the card's name and power limit; build the CUDA kernels with
   ``nvcc`` from ``src/repro_torch/csrc`` and time the build;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (exact equality), and time the kernel, the plain
   version and, where one exists, a single PyTorch library call;
3. drive the main path at full size: the repo's own deployment
   (``src/repro/configs/posdb_bfs.py``: 2^20-vertex tree of height 16,
   8 payload columns, depth 16, result cap 2^20) with a per-level frontier
   cap of 2^18, through ``run_query`` for 10 requests; every result must
   equal the port's CPU run bit for bit, root 0 must equal the BFS oracle,
   and the kernels' launch counters must show the path went through them;
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

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.convert import dataset_from_numpy  # noqa: E402
from repro_torch.core.csr import csr_degrees, expand_frontier  # noqa: E402
from repro_torch.core.engine import (EngineCaps, RecursiveQuery,  # noqa: E402
                                     run_query)
from repro_torch.data.treegen import (TreeSpec, bfs_reference,  # noqa: E402
                                      make_edge_table)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.frontier_expand import ops as fe_ops  # noqa: E402
from repro_torch.kernels.frontier_expand.frontier_expand import \
    expand_index_cuda  # noqa: E402
from repro_torch.kernels.late_gather import ops as lg_ops  # noqa: E402
from repro_torch.kernels.late_gather.ref import late_gather_ref  # noqa: E402

# the posdb-bfs deployment (src/repro/configs/posdb_bfs.py), on one card:
# frontier_cap is 2^18 instead of the config's per-shard 2^15, because the
# widest level of this tree emits 155,901 edges
SPEC = TreeSpec(num_vertices=1 << 20, height=16, payload_cols=8, seed=0)
MAX_DEPTH = 16
CAPS = EngineCaps(frontier=1 << 18, result=1 << 20)
ROOT_SEED = 1
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
TIMING_REPS = 20


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


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# the requests and their checks
# ---------------------------------------------------------------------------

def make_requests(cols: dict, num_vertices: int) -> list[tuple[str, int]]:
    """Root 0, three depth-1 vertices and four seeded random roots
    outbound; the deepest vertex inbound and both ways."""
    children = cols["to"][cols["from"] == 0][:3]
    rand = np.random.default_rng(ROOT_SEED).integers(0, num_vertices, 4)
    out = [0, *children.tolist(), *rand.tolist()]
    last = num_vertices - 1
    return ([("outbound", int(r)) for r in out]
            + [("inbound", last), ("both", last)])


def run_requests(ds, requests, caps: EngineCaps, payload_cols: int,
                 max_depth: int) -> list:
    results = []
    for direction, root in requests:
        q = RecursiveQuery("precursive", max_depth, payload_cols, caps,
                           direction=direction)
        results.append(run_query(q, ds, root))
    return results


def require_equal(a, b, label: str) -> None:
    """Field-for-field, bit-for-bit equality of two BFSResults."""
    for field in ("positions", "count", "depth", "overflow", "row_depths"):
        x, y = getattr(a, field).cpu(), getattr(b, field).cpu()
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"{label}: field {field} differs from the CPU run")
    require(a.values.keys() == b.values.keys(), f"{label}: value columns")
    for k in a.values:
        x, y = a.values[k].cpu(), b.values[k].cpu()
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"{label}: column {k} differs from the CPU run")


def check_result_shape(r, caps: EngineCaps, label: str) -> None:
    require(r.positions.shape == (caps.result,), f"{label}: positions shape")
    for k, v in r.values.items():
        require(v.shape[0] == caps.result, f"{label}: column {k} shape")
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f"{label}: {k} not finite")


def check_root0(r, cols: dict, spec: TreeSpec, max_depth: int) -> None:
    """Root 0 reaches the whole tree without overflow, level by level equal
    to the pure-Python BFS oracle."""
    count = int(r.count)
    require(count == spec.num_edges,
            f"root 0: count {count} != {spec.num_edges}")
    require(not bool(r.overflow), "root 0 overflowed")
    levels = bfs_reference(cols["from"], cols["to"], 0, max_depth,
                           spec.num_vertices)
    pos = r.positions[:count].cpu().numpy()
    depth = r.row_depths[:count].cpu().numpy()
    for d, want in enumerate(levels):
        require(set(pos[depth == d].tolist()) == want,
                f"root 0: level {d} differs from bfs_reference")
    require(int(depth.max()) + 1 == len([s for s in levels if s]),
            "root 0: extra levels")


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
    t, v = targets.cuda(), valid.cuda()
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


def profile_request(ds, direction: str, root: int, warm_ms: float) -> dict:
    """Where one warm request's time goes: device time per kernel from
    ``torch.profiler``, and the device's idle share against the request's
    unprofiled warm latency ``warm_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q = RecursiveQuery("precursive", MAX_DEPTH, SPEC.payload_cols, CAPS,
                       direction=direction)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_query(q, ds, root)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, fills): the host ops that
    # launched them carry the same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {
        "request": f"{direction} root {root}", "warm_ms": warm_ms,
        "device_ms": device_ms,
        "idle_share": 1 - device_ms / warm_ms if device_ms else None,
        "device_launches": sum(e.count for e in kernels),
        "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                for e in top],
    }


# ---------------------------------------------------------------------------

def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script drives the port on a CUDA card")
    device_name = torch.cuda.get_device_name(0)

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

    # data: the same numpy tree on the card and on the CPU
    t0 = time.perf_counter()
    cols = make_edge_table(SPEC)
    ds = dataset_from_numpy(cols, SPEC.num_vertices, "cuda")
    ds_cpu = dataset_from_numpy(cols, SPEC.num_vertices, "cpu")
    torch.cuda.synchronize()
    table_mb = sum(c.nbytes for c in ds.table.columns.values()) / 2 ** 20
    print(f"data: {SPEC.num_edges} edges, {table_mb:.1f} MiB of columns on "
          f"the card, {time.perf_counter() - t0:.3f} s")
    requests = make_requests(cols, SPEC.num_vertices)
    t0 = time.perf_counter()
    expected = run_requests(ds_cpu, requests, CAPS, SPEC.payload_cols,
                            MAX_DEPTH)
    print(f"cpu reference: {len(requests)} requests in "
          f"{time.perf_counter() - t0:.3f} s (host clock)")

    # phase 2: each kernel against its plain version on the card
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    targets, valid, level, emitted = widest_level(expected[0], cols,
                                                  CAPS.frontier)
    print(f"frontier_expand input: level {level} of root 0, "
          f"{int(valid.sum())} targets -> {emitted} edges")
    fe = frontier_expand_phase(ds, targets, valid, CAPS.frontier, emitted,
                               flush)
    lg, lg_cases = late_gather_phase(ds, expected[0].positions.cuda(), flush)
    print("late_gather cases: " + json.dumps(lg_cases))

    # phase 3: the main path at full size; the counters see only this run
    fe_ops.LAUNCHES = 0
    lg_ops.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    got = run_requests(ds, requests, CAPS, SPEC.payload_cols, MAX_DEPTH)
    torch.cuda.synchronize()
    fe["launches"], lg["launches"] = fe_ops.LAUNCHES, lg_ops.LAUNCHES
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    expand_levels = sum(int(r.depth) for r, (d, _) in zip(got, requests)
                        if d != "both")
    require(fe["launches"] == expand_levels > 0,
            f"frontier_expand launched {fe['launches']} times, expected one "
            f"per executed outbound/inbound level ({expand_levels})")
    n_cols = len(RecursiveQuery("precursive", MAX_DEPTH, SPEC.payload_cols,
                                CAPS).out_cols)
    require(lg["launches"] == n_cols * len(requests),
            f"late_gather launched {lg['launches']} times, expected "
            f"{n_cols} per request")
    for (direction, root), r, want in zip(requests, got, expected):
        label = f"{direction} root {root}"
        check_result_shape(r, CAPS, label)
        require_equal(r, want, label)
    check_root0(got[0], cols, SPEC, MAX_DEPTH)

    warm = {}
    for (direction, root), r in zip(requests, got):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_query(RecursiveQuery("precursive", MAX_DEPTH,
                                     SPEC.payload_cols, CAPS,
                                     direction=direction), ds, root)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        warm[direction, root] = statistics.median(ms)
        print(f"request {direction} root {root}: count {int(r.count)} "
              f"depth {int(r.depth)} overflow {bool(r.overflow)} "
              f"warm latency {warm[direction, root]:.3f} ms "
              f"(median of 3, host clock)")
    print(f"main path: {len(requests)} requests equal to the CPU run; "
          f"peak device memory {peak_mb:.1f} MiB")
    for key in (requests[0], requests[-1]):
        print("profile: " + json.dumps(profile_request(ds, *key, warm[key])))

    print(json.dumps({"kernels": [fe, lg]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
