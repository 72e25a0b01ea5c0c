"""Quickstart: the paper's recursive query engines in 60 seconds, on the
port (the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from ..convert import dataset_from_numpy
from ..core.engine import RecursiveQuery, plan_repr, resolve_device, run_query
from ..core.operators import EngineCaps
from ..data.treegen import TreeSpec, make_edge_table
from ..planner import paper_listing, plan
from ._common import device_argument, timed_ms

__all__ = ["SPEC", "ENGINES", "run", "main"]

# a 100k-vertex tree stored as an edge table (id, from, to, name, 4
# payload columns): the paper's §5.1 dataset
SPEC = TreeSpec(num_vertices=100_000, height=50, payload_cols=4, seed=0)
ENGINES = ("precursive", "trecursive", "rowstore", "rowstore_index",
           "bitmap", "hybrid")


def run(spec: TreeSpec = SPEC, depth: int = 10, device=None,
        reps: int = 3) -> dict:
    """Every engine of ENGINES from root 0 to ``depth`` hops, then the
    planner's ranking: ``{"engines": {engine: {"rows", "levels", "ms"}},
    "ranking": [(label, est_us), ...]}``."""
    device = resolve_device(device)
    ds = dataset_from_numpy(make_edge_table(spec), spec.num_vertices, device)
    caps = EngineCaps(frontier=spec.num_vertices, result=spec.num_vertices)

    print(f"Query: all edges within {depth} hops of vertex 0, all "
          "columns.\n")
    print("PRecursive plan (the paper's Fig. 4):")
    print(plan_repr("precursive", depth, spec.payload_cols), "\n")
    out = {"engines": {}}
    for engine in ENGINES:
        q = RecursiveQuery(engine=engine, max_depth=depth,
                           payload_cols=spec.payload_cols, caps=caps)
        r, ms = timed_ms(lambda q=q: run_query(q, ds, 0), device, reps)
        out["engines"][engine] = {"rows": int(r.count),
                                  "levels": int(r.depth), "ms": ms}
        print(f"{engine:16s} {ms:8.2f} ms   rows={int(r.count):6d} "
              f"levels={int(r.depth)}")

    # or skip the engine name entirely: the planner prices every pipeline
    # against the graph's statistics and picks one (see docs/planner.md)
    report = plan(paper_listing(2, root=0, depth=depth,
                                payload_cols=spec.payload_cols),
                  ds, caps=caps)
    out["ranking"] = [(c.label, c.cost.est_us) for c in report.ranked]
    print("\nplanner ranking: "
          + ", ".join(f"{c.label}~{c.cost.est_us:.0f}us"
                      for c in report.ranked[:3]) + ", ...")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_argument(ap)
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
