"""Serving drivers of the port.  Both modes run on the card unless
``--device cpu`` is given (no card: they raise, they do not fall back to
the CPU).

LM mode — batched prefill + greedy decode with a position-addressed
cache (``models.transformer``), random weights from a seed held in the
config's dtype:

    python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
        --batch 4 --prompt-len 32 --gen 16

Traversal mode — the plan-cached, reach-bucketed graph-query serving path
(:class:`repro_torch.planner.serving.ServingSession`).  Build a graph,
then answer batches of per-user traversal roots, one bucketed dispatch
per reach class, with the plan cache amortizing parse/stats/costing
across requests:

    python -m repro_torch.launch.serve --traversal --vertices 20000 \\
        --height 10 --batch 8 --requests 32 --depth 4

With ``--plan-store PATH`` the session persists its plan + calibration
caches: the first run writes PATH, every later run rehydrates from it and
answers its first request with zero parse/stats/costing work (the
"(rehydrated)" line reports the session counters to prove it).  The store
is the JAX reference's format, so either package's store loads in the
other.

Observability flags: ``--metrics`` prints the session's Prometheus text
exposition on exit (latency histograms, cache hit counters, overflow
retries, calibrator refits); ``--trace PATH`` traces every request (spans
+ per-level traversal events) to JSON lines at PATH; ``--trace-chrome
PATH`` writes the same trace as a Chrome/Perfetto-loadable JSON file.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs.registry import ARCHS, get_config
from ..models import transformer as tfm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, params, prompts: torch.Tensor, gen: int):
    """prompts (B, S) int32 -> greedy tokens (B, gen) int32, on the
    prompts' device.  Returns (tokens, stats): ``prefill_s``,
    ``decode_s`` (host clock, each ending in a synchronize on the card)
    and ``tok_per_s`` = B * gen / decode_s."""
    b, s = prompts.shape
    device = prompts.device
    max_len = s + gen
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = tfm.prefill(params, prompts, cfg, max_len=max_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = []
    t1 = time.perf_counter()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for _ in range(gen):
        out.append(tok)
        logits, cache = tfm.decode_step(params, tok, cache, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    t_decode = time.perf_counter() - t1
    stats = {"prefill_s": t_prefill, "decode_s": t_decode,
             "tok_per_s": b * gen / max(t_decode, 1e-9)}
    return torch.stack(out, dim=1), stats


def serve_lm(args) -> dict:
    """The LM serving run of ``--arch``: seeded random weights and
    prompts, one ``serve_batch``; prints and returns its stats."""
    from ..core.engine import resolve_device

    device = resolve_device(args.device)
    cfg, _ = get_config(args.arch, smoke=args.smoke)
    params = tfm.init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                         device, dtype=getattr(torch, cfg.dtype))
    prompts = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len),
        generator=torch.Generator(device=device).manual_seed(1),
        device=device, dtype=torch.int32)
    toks, stats = serve_batch(cfg, params, prompts, args.gen)
    print(f"generated {tuple(toks.shape)} on {device.type} "
          f"prefill={stats['prefill_s'] * 1e3:.1f}ms "
          f"decode={stats['decode_s'] * 1e3:.1f}ms "
          f"({stats['tok_per_s']:.1f} tok/s)")
    return stats


def serve_traversals(args) -> dict:
    """The graph-traversal serving loop: one ServingSession, ``--requests``
    batches of mixed hub/leaf roots, steady-state latency from the plan
    cache + bucketed dispatch.  Returns the session's counters."""
    from ..convert import dataset_from_numpy
    from ..core.engine import resolve_device
    from ..data.treegen import TreeSpec, make_edge_table
    from ..planner import ServingSession, paper_listing

    device = resolve_device(args.device)
    spec = TreeSpec(num_vertices=args.vertices, height=args.height,
                    payload_cols=0, seed=0)
    ds = dataset_from_numpy(make_edge_table(spec), spec.num_vertices, device)
    sql = paper_listing(1, root=0, depth=args.depth)
    tracer = None
    if args.trace or args.trace_chrome:
        from ..obs import Tracer
        tracer = Tracer(meta={"mode": "traversal-serve",
                              "vertices": args.vertices,
                              "batch": args.batch,
                              "requests": args.requests,
                              "device": device.type})
    rehydrated = (args.plan_store is not None
                  and os.path.exists(args.plan_store))
    session = ServingSession(ds, plan_store=args.plan_store, tracer=tracer,
                             guards=not args.no_guards)
    if rehydrated:
        print(f"(rehydrated) plan store {args.plan_store}: "
              f"{len(session._plans)} plan(s), "
              f"{session.calibrator.count} calibration observation(s)")

    rng = np.random.RandomState(0)
    t_first = t_steady = 0.0
    for i in range(args.requests):
        # every batch mixes the hub root 0 with random (mostly leaf) roots
        roots = [0] + rng.randint(0, args.vertices,
                                  size=args.batch - 1).tolist()
        t0 = time.perf_counter()
        session.submit(sql, roots, deadline_us=args.deadline_us)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if i == 0:
            t_first = dt
        else:
            t_steady += dt
    stats = session.stats
    steady_us = t_steady / max(args.requests - 1, 1) * 1e6
    print(f"traversal serving on {device.type}: {args.requests} requests x "
          f"batch {args.batch}  first={t_first * 1e3:.1f}ms (plans + first "
          f"use) steady={steady_us / 1e3:.2f}ms/req "
          f"({steady_us / args.batch:.0f}us/root)")
    print(f"plan cache: {stats['plan_hits']} hits / "
          f"{stats['plan_misses']} misses over "
          f"{stats['cached_plans']} plan(s), "
          f"{stats['cached_shapes']} query shape(s)")
    print(f"planning paid: {stats['parse_calls']} parse / "
          f"{stats['stats_calls']} stats / {stats['cost_calls']} costing "
          f"pass(es); calibration: {stats['calibration_observations']} "
          f"observation(s), {stats['calibration_refits']} refit(s)")
    print(f"latency: p50={stats['latency_us_p50'] / 1e3:.2f}ms "
          f"p95={stats['latency_us_p95'] / 1e3:.2f}ms "
          f"p99={stats['latency_us_p99'] / 1e3:.2f}ms  "
          f"hit rate {stats['plan_hit_rate']:.2f}, "
          f"{stats['overflow_retries']} overflow retr(ies)")
    print(f"front door: admission {stats['admission_traverse']} traverse / "
          f"{stats['admission_degrade']} degrade / "
          f"{stats['admission_reject']} reject; "
          f"{stats['deadline_skipped_buckets']} deadline-skipped "
          f"bucket(s), {stats['retry_denied']} retry-denied lane(s)")
    if args.plan_store is not None:
        session.save_plan_store()
        print(f"plan store saved to {args.plan_store}")
    if tracer is not None:
        if args.trace:
            tracer.write_jsonl(args.trace)
            print(f"trace written to {args.trace} "
                  f"({len(tracer.records)} record(s))")
        if args.trace_chrome:
            tracer.write_chrome_trace(args.trace_chrome)
            print(f"chrome trace written to {args.trace_chrome}")
    if args.metrics:
        print("-- metrics --")
        print(session.metrics_text(), end="")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve an LM (--arch: batched prefill + greedy decode) "
                    "or graph-traversal queries (--traversal) on the card.")
    ap.add_argument("--traversal", action="store_true",
                    help="serve graph-traversal queries (plan-cached, "
                         "reach-bucketed) instead of an LM")
    ap.add_argument("--arch", choices=[a for a, (f, _) in ARCHS.items()
                                       if f == "lm"],
                    help="LM mode: the architecture to serve, random "
                         "weights from a seed")
    ap.add_argument("--smoke", action="store_true",
                    help="LM mode: the arch's reduced SMOKE config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    ap.add_argument("--batch", type=int, default=4,
                    help="sequences per LM batch, or roots per traversal "
                         "request")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="LM mode: prompt tokens per sequence")
    ap.add_argument("--gen", type=int, default=16,
                    help="LM mode: tokens generated per sequence")
    ap.add_argument("--vertices", type=int, default=20_000)
    ap.add_argument("--height", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--plan-store", default=None, metavar="PATH",
                    help="persist plans + calibration: rehydrate from PATH "
                         "when it exists, save to it on exit")
    ap.add_argument("--metrics", action="store_true",
                    help="print the serving metrics registry in Prometheus "
                         "text format on exit")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="trace every request (spans + per-level events) "
                         "to JSON lines at PATH")
    ap.add_argument("--trace-chrome", default=None, metavar="PATH",
                    help="write the trace as a Chrome/Perfetto-loadable "
                         "JSON file at PATH")
    ap.add_argument("--deadline-us", type=float, default=None,
                    metavar="US",
                    help="per-request deadline budget in microseconds: "
                         "buckets predicted to blow the budget are "
                         "skipped and the answer is explicitly truncated "
                         "(session.last_report names the skipped roots)")
    ap.add_argument("--no-guards", action="store_true",
                    help="disable the admission guard ladder (default: "
                         "every root is priced against the guard budgets "
                         "before dispatch)")
    args = ap.parse_args(argv)

    if args.traversal:
        return serve_traversals(args)
    if args.arch is None:
        ap.error("--arch is required unless --traversal is given")
    return serve_lm(args)


if __name__ == "__main__":
    main()
