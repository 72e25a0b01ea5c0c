"""End-to-end driver for the paper's engine on the port (the reference's
``examples/bfs_traversal.py``): the PLANNER answering a SQL ``WITH
RECURSIVE`` query without an engine name (cost-based selection over the
pipelines + EXPLAIN's ranking), the single-device depth sweep, BATCHED
multi-root serving (one call answering many users' roots),
direction-aware traversal (outbound / inbound / both) and the
DISTRIBUTED positional BFS (:func:`run_distributed`): 8 gloo ranks with
``--device cpu``, on the card one NCCL rank a card.

    PYTHONPATH=src python -m repro_torch.examples.bfs_traversal [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..convert import dataset_from_numpy
from ..core.distributed_bfs import gather_result, make_distributed_pbfs
from ..core.engine import (RecursiveQuery, plan_and_run, plan_repr,
                           resolve_device, run_query, run_query_batch)
from ..core.operators import EngineCaps
from ..data.treegen import TreeSpec, make_edge_table
from ..distributed.spawn import run_ranks
from ..launch.mesh import make_mesh
from ..planner import paper_listing, plan
from ._common import device_argument, timed_ms

__all__ = ["SPEC", "CAPS", "DEPTHS", "DIST_CAPS", "DIST_DEPTH", "CPU_RANKS",
           "run", "run_distributed", "main"]

SPEC = TreeSpec(num_vertices=262_145, height=40, payload_cols=8, seed=1)
CAPS = EngineCaps(frontier=1 << 16, result=1 << 18)
DEPTHS = (5, 10, 20, 40)
DIST_CAPS = EngineCaps(frontier=1 << 14, result=1 << 15)
DIST_DEPTH = 20
CPU_RANKS = 8                # the reference's 8 placeholder devices
RANK_TIMEOUT_S = 600.0


def run(spec: TreeSpec = SPEC, caps: EngineCaps = CAPS,
        depths=DEPTHS, n_roots: int = 16, root_step: int = 1000,
        device=None) -> dict:
    """Every section but the distributed one (:func:`run_distributed`);
    returns each section's numbers: ``planner`` (ranked labels, the pick,
    rows, the depth column's largest, rows under ``WHERE depth <= 3``),
    ``sweep`` (depth
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

    return out


def _distributed_rank(rank: int, world: int, spec: TreeSpec,
                      caps: EngineCaps, max_depth: int,
                      device_type: str) -> dict:
    """One rank of the distributed section: its rows of the table on its
    device, the one-axis mesh, a warm call from root 0, the timed call,
    then the shards' counts gathered (rank 0's result is the world's)."""
    cols = make_edge_table(spec)
    e_loc = cols["from"].shape[0] // world
    rows = slice(rank * e_loc, (rank + 1) * e_loc)
    device = torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device("cpu")
    src, dst, pay = (torch.from_numpy(np.ascontiguousarray(cols[k][rows]))
                     .to(device) for k in ("from", "to", "column1"))
    mesh = make_mesh((world,), ("data",), device_type=device_type)
    fn = make_distributed_pbfs(mesh, ("data",), spec.num_vertices,
                               caps=caps, max_depth=max_depth,
                               num_payload_cols=spec.payload_cols,
                               device=device)
    out, ms = timed_ms(lambda: fn(src, dst, pay, 0), device)
    counts = gather_result(out, fn.group)[2]
    return {"ms": ms, "counts": counts.tolist()}


def run_distributed(spec: TreeSpec = SPEC, caps: EngineCaps = DIST_CAPS,
                    max_depth: int = DIST_DEPTH, device=None,
                    world_size: int | None = None) -> dict:
    """The reference's last section: PRecursive from root 0 over a
    one-axis mesh of ``world_size`` ranks, the table's rows sharded over
    them, payload ``column1`` materialized shard-locally.  The ranks are
    spawned processes: on the CPU ``CPU_RANKS`` gloo ranks, on the card
    one NCCL rank a card (``torch.cuda.device_count()``).  Returns
    ``world``, ``ms`` (rank 0's warm call, host clock and a sync),
    ``rows`` and the per-shard ``counts``."""
    device = resolve_device(device)
    world = world_size or (torch.cuda.device_count() if device.type ==
                           "cuda" else CPU_RANKS)
    print(f"\n=== distributed PRecursive over a {world}-rank mesh "
          f"({'NCCL' if device.type == 'cuda' else 'gloo'}) ===")
    got = run_ranks(_distributed_rank, world, spec, caps, max_depth,
                    device.type, device_type=device.type,
                    timeout_s=RANK_TIMEOUT_S)[0]
    out = {"world": world, "ms": got["ms"], "rows": sum(got["counts"]),
           "counts": got["counts"]}
    print(f"{max_depth}-hop traversal on {world} shards: {out['ms']:7.2f} "
          f"ms, rows={out['rows']}")
    print("per-shard result counts:", out["counts"])
    print("values materialized shard-locally; only vertex ids crossed the "
          "mesh (one all_gather per level).")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_argument(ap)
    device = ap.parse_args(argv).device
    out = run(device=device)
    out["distributed"] = run_distributed(device=device)
    return out


if __name__ == "__main__":
    main()
