"""Perf hillclimbing driver, the reference's
``src/repro/launch/hillclimb.py``: one cell's roofline terms under config
overrides.

The reference compiles the cell with its scans unrolled on the
single-pod mesh and reads XLA's cost analysis.  The port builds the cell
on the ``meta`` device and counts one eager step
(``launch.count.CountMode``), which sees every layer and chunk as it
runs, so the count is exact without unrolling; ``--probe`` adds the
affine decomposition of ``launch.probe``.  The terms are on one H100 at
its published peaks.  ``--lazy-optimizer shardmap`` (the sharded lazy
update) waits for ROADMAP item 11 and raises.

  python -m repro_torch.launch.hillclimb --cell qwen2-prefill \\
      --set attn_q_block=4096 --set attn_chunk=8192
  python -m repro_torch.launch.hillclimb --cell deepfm-train --lazy-optimizer
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from ..configs.registry import get_config, shapes_for
from . import roofline as rl
from .count import count_call
from .steps import build_lm_cell, build_recsys_cell, make_optimizer

__all__ = ["CELLS", "measure", "main"]

CELLS = {
    "qwen2-prefill": ("qwen2-0.5b", "prefill_32k"),
    "deepseek-train": ("deepseek-v2-lite-16b", "train_4k"),
    "deepfm-train": ("deepfm", "train_batch"),
}


def _coerce(v: str):
    if v in ("None", "none"):
        return None
    if v in ("True", "False"):
        return v == "True"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def _print(out: dict) -> None:
    print(f"[{out['label']}] count={out['count_s']}s  "
          f"compute={out['compute_s']:.4g}s memory={out['memory_s']:.4g}s "
          f"collective={out['collective_s']:.4g}s  "
          f"dominant={out['dominant']} frac={out['roofline_frac']:.4f}")
    print(f"  flops={out['flops']:.4g} {out.get('flops_by_dtype', '')} "
          f"bytes={out['hbm_bytes']:.4g} "
          f"coll_bytes={out['collective_bytes']:.4g}")


def measure(arch, shape, overrides, lazy_optimizer=False, label="variant",
            use_probe=False, *, smoke: bool = False) -> dict:
    """The cell's roofline row under ``overrides`` (config fields),
    counted on ``meta``; ``lazy_optimizer="plain"`` takes DeepFM's lazy
    step."""
    cfg, family = get_config(arch, smoke=smoke)
    dims = shapes_for(family, smoke=smoke)[shape]
    tags = {"label": label,
            "overrides": {k: str(v) for k, v in overrides.items()}}

    if family == "lm" and use_probe:
        from .probe import lm_exact_costs
        t0 = time.perf_counter()
        exact = lm_exact_costs(arch, shape, overrides=overrides, smoke=smoke)
        rf = rl.Roofline(flops=exact["flops"], hbm_bytes=exact["hbm_bytes"],
                         collective_bytes=0.0, chips=1)
        out = {"flops": rf.flops, "hbm_bytes": rf.hbm_bytes,
               "collective_bytes": 0.0, **rf.row(), **tags,
               "probe": {k: v for k, v in exact.items()
                         if k.startswith("probe")},
               "count_s": round(time.perf_counter() - t0, 1),
               "method": "probe"}
        _print(out)
        return out

    if family == "lm":
        cfg = dataclasses.replace(cfg, **overrides)
        plan = build_lm_cell(cfg, dims, "meta")
    elif family == "recsys":
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        plan = build_recsys_cell(cfg, dims, "meta")
        if lazy_optimizer == "shardmap":
            raise NotImplementedError(
                "--lazy-optimizer shardmap: the sharded lazy update waits "
                "for the port's multi-device slice, ROADMAP item 11")
        if lazy_optimizer:
            from ..models.recsys import make_deepfm_train_step_lazy
            plan.fn = make_deepfm_train_step_lazy(cfg, make_optimizer())
    else:
        raise SystemExit(f"hillclimb supports lm/recsys cells, got {family}")

    _, count = count_call(plan.fn, *plan.args)
    out = {**rl.analyze(count), **tags, "lazy_optimizer": lazy_optimizer,
           "count_s": round(count.count_s, 1), "counted_on": "meta"}
    _print(out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS), required=True)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--lazy-optimizer", nargs="?", const="plain",
                    default=False, choices=["plain", "shardmap"])
    ap.add_argument("--probe", action="store_true",
                    help="add the affine decomposition (launch.probe)")
    ap.add_argument("--smoke", action="store_true",
                    help="the SMOKE configs and shapes")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = _coerce(v)
    arch, shape = CELLS[args.cell]
    label = args.label or (",".join(args.set) or
                           ("lazy-opt" if args.lazy_optimizer else
                            "baseline"))
    res = measure(arch, shape, overrides, args.lazy_optimizer, label,
                  use_probe=args.probe, smoke=args.smoke)
    res.update({"arch": arch, "shape": shape})
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        existing.append(res)
        with open(args.out, "w") as f:
            json.dump(existing, f, indent=1, default=str)
    return res


if __name__ == "__main__":
    main()
