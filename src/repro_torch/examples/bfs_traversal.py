"""End-to-end driver for the paper's engine on the port (the reference's
``examples/bfs_traversal.py``): the PLANNER answering a SQL ``WITH
RECURSIVE`` query without an engine name (cost-based selection over the
pipelines + EXPLAIN's ranking), the single-device depth sweep, BATCHED
multi-root serving (one call answering many users' roots) and
direction-aware traversal (outbound / inbound / both).

The reference's last section, the distributed positional BFS on 8
devices, waits for the port's multi-device slice (ROADMAP item 11).

    PYTHONPATH=src python -m repro_torch.examples.bfs_traversal [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..convert import dataset_from_numpy
from ..core.engine import (RecursiveQuery, plan_and_run, plan_repr,
                           resolve_device, run_query, run_query_batch)
from ..core.operators import EngineCaps
from ..data.treegen import TreeSpec, make_edge_table
from ..planner import paper_listing, plan
from ._common import device_argument, timed_ms

__all__ = ["SPEC", "CAPS", "DEPTHS", "run", "main"]

SPEC = TreeSpec(num_vertices=262_145, height=40, payload_cols=8, seed=1)
CAPS = EngineCaps(frontier=1 << 16, result=1 << 18)
DEPTHS = (5, 10, 20, 40)
DISTRIBUTED_DEFERRED = ("the distributed PRecursive over an 8-device mesh "
                        "waits for the port's multi-device slice (ROADMAP "
                        "item 11)")


def run(spec: TreeSpec = SPEC, caps: EngineCaps = CAPS,
        depths=DEPTHS, n_roots: int = 16, root_step: int = 1000,
        device=None) -> dict:
    """Every section but the distributed one; returns each section's
    numbers: ``planner`` (ranked labels, the pick, rows, the depth
    column's largest, rows under ``WHERE depth <= 3``), ``sweep`` (depth
    -> rows, overflow, ms), ``batch`` (rows per root, ms), ``directions``
    (direction -> rows, levels, overflow, largest row depth) and
    ``plan``."""
    device = resolve_device(device)
    cols = make_edge_table(spec)
    ds = dataset_from_numpy(cols, spec.num_vertices, device)
    out = {}

    print("=== the planner: SQL in, engine choice out ===")
    sql = paper_listing(2, root=0, depth=10, payload_cols=spec.payload_cols)
    print(sql)
    report = plan(sql, ds, caps=caps)
    print("ranked:", ", ".join(f"{c.label}~{c.cost.est_us:.0f}us"
                               for c in report.ranked[:4]), "...")
    r, ms = timed_ms(lambda: plan_and_run(sql, ds, caps=caps), device)
    depth_col = int(r.values["depth"][:int(r.count)].max())
    print(f"chose {report.best.label}: {ms:7.2f} ms  rows={int(r.count)}  "
          f"depth column 0..{depth_col}")
    filt = plan_and_run(sql + " WHERE depth <= 3", ds, caps=caps)
    print(f"with WHERE depth <= 3 (pushed into the recursion bound): "
          f"rows={int(filt.count)}")
    out["planner"] = {"ranked": [c.label for c in report.ranked],
                      "chose": report.best.label, "rows": int(r.count),
                      "depth_column_max": depth_col, "ms": ms,
                      "where_rows": int(filt.count)}

    print("\n=== single-device PRecursive, depth sweep ===")
    out["sweep"] = {}
    for depth in depths:
        q = RecursiveQuery("precursive", depth, spec.payload_cols, caps)
        r, ms = timed_ms(lambda q=q: run_query(q, ds, 0), device)
        out["sweep"][depth] = {"rows": int(r.count),
                               "overflow": bool(r.overflow), "ms": ms}
        print(f"depth {depth:3d}: {ms:7.2f} ms  rows={int(r.count)} "
              f"overflow={bool(r.overflow)}")

    print(f"\n=== batched multi-root serving (one call, {n_roots} users) "
          "===")
    q = RecursiveQuery("precursive", 10, spec.payload_cols, caps)
    roots = (torch.arange(n_roots, dtype=torch.int32) * root_step).tolist()
    rb, ms = timed_ms(lambda: run_query_batch(q, ds, roots), device)
    out["batch"] = {"roots": roots, "rows": rb.count.tolist(), "ms": ms}
    print(f"{n_roots} roots in one call: {ms:7.2f} ms "
          f"({ms / n_roots:6.2f} ms/root), rows per root: "
          f"{out['batch']['rows']}")

    print("\n=== direction-aware traversal (reverse CSR) ===")
    leaf = int(np.asarray(cols["to"])[-1])
    out["directions"] = {"leaf": leaf}
    for direction in ("outbound", "inbound", "both"):
        qd = RecursiveQuery("precursive", 10, spec.payload_cols, caps,
                            direction=direction)
        r = run_query(qd, ds, leaf)
        n = int(r.count)
        row = {"rows": n, "levels": int(r.depth),
               "overflow": bool(r.overflow),
               "max_row_depth": int(r.row_depths[:n].max()) if n else 0}
        out["directions"][direction] = row
        print(f"{direction:9s} from vertex {leaf}: rows={n:6d} "
              f"levels={row['levels']} overflow={row['overflow']} "
              f"max_row_depth={row['max_row_depth']}")

    print("\n=== the PRecursive plan, derived from the operator pipeline "
          "===")
    out["plan"] = plan_repr("precursive", 10, spec.payload_cols)
    print(out["plan"])

    print("\n=== distributed PRecursive over an 8-device mesh ===")
    print(f"not run: {DISTRIBUTED_DEFERRED}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_argument(ap)
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
