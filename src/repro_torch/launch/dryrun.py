"""Dry run: count every (arch x shape) cell's step on one H100 without
holding it, the reference's ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell's jitted step against 512
placeholder TPU devices and reads the compiled artifact's cost analysis.
The port builds each cell on the ``meta`` device (``build_cell(...,
device="meta")``: the parameters and inputs are shapes and dtypes, no
memory) and runs one eager step under ``launch.count.CountMode``: the
FLOPs by dtype, the eager bytes and the argument and output bytes of
the step as the card would run it, so a cell that no 80 GB card holds
(deepseek ``train_4k``, phi3.5-moe, stablelm-12b) is reckoned all the
same.  Every published cell runs on ``meta`` (``counted_on``); none
needs a real device to learn a shape.  The terms are
``launch.roofline``'s at the card's published peaks, on one card
(``mesh`` ``one_h100``).

Not ported, waiting for the multi-device slice (ROADMAP item 11): the
multi-pod mesh (``--mesh multi`` raises) and the ``posdb-bfs`` row, which
in the reference lowers the distributed positional BFS.

Usage::

  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results.json
  python -m repro_torch.launch.dryrun --all --family lm,recsys --smoke
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from ..configs.registry import ARCHS, cells, get_config, shapes_for
from . import roofline as rl
from .count import count_call
from .steps import build_cell

__all__ = ["MESH", "BFS_DEFERRED", "run_cell", "main"]

MESH = "one_h100"
BFS_DEFERRED = ("the distributed positional BFS (the reference lowers "
                "make_distributed_pbfs on its mesh) waits for the port's "
                "multi-device slice, ROADMAP item 11")


def _model_flops(cfg, dims: dict) -> float:
    if dims["kind"] == "train":
        return rl.lm_model_flops(cfg, dims["batch"], dims["seq"], train=True)
    seq = 1 if dims["kind"] == "decode" else dims["seq"]
    return rl.lm_model_flops(cfg, dims["batch"], seq, train=False)


def run_cell(arch: str, shape_id: str, attn_window=None,
             verbose: bool = True, probe: bool = True, *,
             smoke: bool = False) -> dict:
    """One cell's row: the roofline row of its counted step, the
    ``model_flops`` and ``useful_flops_ratio`` of an LM cell and, with
    ``probe``, its affine decomposition (``launch.probe``)."""
    if arch == "posdb-bfs":
        raise NotImplementedError(BFS_DEFERRED)
    plan = build_cell(arch, shape_id, smoke=smoke, device="meta",
                      attn_window=attn_window)
    _, count = count_call(plan.fn, *plan.args)
    cfg, family = get_config(arch, smoke=smoke)
    model_flops = None
    if family == "lm":
        model_flops = _model_flops(cfg, shapes_for("lm", smoke)[shape_id])
    result = rl.analyze(count, model_flops=model_flops)
    if probe and family == "lm":
        from .probe import lm_exact_costs
        exact = lm_exact_costs(arch, shape_id, attn_window=attn_window,
                               smoke=smoke, direct=count)
        result["probe"] = {k: v for k, v in exact.items()
                           if k.startswith("probe")}
    result.update({"description": plan.description, "arch": arch,
                   "shape": shape_id, "mesh": MESH,
                   "counted_on": "meta", "count_s": count.count_s})
    if verbose:
        print(f"[{arch} x {shape_id} x {MESH}] count={count.count_s:.2f}s "
              f"flops={result['flops']:.3e} "
              f"bytes={result['hbm_bytes']:.3e} "
              f"compulsory={result['compulsory_bytes']:.3e} "
              f"dominant={result['dominant']} "
              f"frac={result['roofline_frac']:.3f}", flush=True)
        print(f"  memory_analysis: {result['memory_analysis']}", flush=True)
    return result


def _todo(args, ap) -> list:
    fams = set(args.family.split(",")) if args.family else None
    if args.all:
        return [(c.arch, c.shape, c.skip)
                for c in cells(include_bfs=True, smoke=args.smoke)
                if not fams or c.family in fams]
    if not args.arch:
        ap.error("--arch or --all required")
    fam = ARCHS[args.arch][0]
    skips = {c.shape: c.skip for c in cells(include_bfs=True,
                                            smoke=args.smoke)
             if c.arch == args.arch}
    shape_ids = [args.shape] if args.shape else \
        list(shapes_for(fam, args.smoke))
    return [(args.arch, s, None if args.attn_window is not None
             else skips.get(s)) for s in shape_ids]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(ARCHS), default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single",
                    help="single: one H100 (multi waits for item 11)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--family", default=None,
                    help="comma list filter: lm,gnn,recsys,bfs")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the affine trip-count decomposition (LM)")
    ap.add_argument("--attn-window", type=int, default=None,
                    help="enable sliding-window attention (long_500k extra)")
    ap.add_argument("--smoke", action="store_true",
                    help="the SMOKE configs and shapes")
    ap.add_argument("--out", default=None, help="write JSON results here")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise NotImplementedError(f"--mesh {args.mesh}: the multi-pod mesh "
                                  "waits for the port's multi-device "
                                  "slice, ROADMAP item 11")

    results, failures = [], []
    t0 = time.perf_counter()
    for arch, shape_id, skip in _todo(args, ap):
        if arch == "posdb-bfs":
            skip = BFS_DEFERRED
        if skip:
            print(f"[{arch} x {shape_id}] SKIP: {skip}")
            results.append({"arch": arch, "shape": shape_id,
                            "skipped": skip})
        else:
            try:
                results.append(run_cell(arch, shape_id,
                                        attn_window=args.attn_window,
                                        probe=not args.no_probe,
                                        smoke=args.smoke))
            except Exception:                  # report, go on to the next
                traceback.print_exc()
                failures.append((arch, shape_id))
        if args.out:                           # incremental flush
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)
    if args.out:
        print(f"wrote {args.out} ({len(results)} entries)")
    if failures:
        print("FAILURES:", failures)
        return 1
    print(f"dry-run OK: {len(results)} cells in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
