"""DeepFM: brief training then batched online scoring + retrieval — the
framework's purest late-materialization workload (ids are positions into
the table; only hit rows are gathered) — on the port (the reference's
``examples/recsys_serve.py``).  On the card the per-field lookup is
``fixed_hot_lookup``, so ``late_gather`` runs and ``embedding_bag`` does
not.

    PYTHONPATH=src python -m repro_torch.examples.recsys_serve
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..configs.base import RecsysConfig
from ..core.engine import resolve_device
from ..data.recsys_stream import recsys_batch, vocab_sizes
from ..models.recsys import (field_offsets, init_deepfm,
                             make_deepfm_train_step, retrieval_scores,
                             serve_scores, total_rows)
from ..optim import AdamW, linear_warmup_cosine
from ._common import device_argument, sync

__all__ = ["run", "main"]

WARMUP_REQUESTS = 3          # dropped from the latency percentiles


def run(train_steps: int, train_batch: int, serve_batch: int,
        serve_requests: int, vocab_scale: float, device=None, *,
        n_candidates: int = 100_000, params: Optional[dict] = None) -> dict:
    """``train_steps`` AdamW steps on ``recsys_batch(0, s, ...)``, then
    ``serve_requests`` scoring requests of ``recsys_batch(1, r, ...)`` and
    one retrieval of ``n_candidates`` positions: ``{"losses", "p50_ms",
    "p99_ms", "retrieval_ms", "top5", "table_rows"}``.  ``params``
    (``None``: drawn from a generator seeded 0) lets a caller replay
    another run's weights."""
    device = resolve_device(device)
    cfg = RecsysConfig(name="deepfm", vocab_scale=vocab_scale)
    vocabs = vocab_sizes(cfg.vocab_scale)
    rows = total_rows(cfg)
    print(f"embedding table: {rows:,} rows x {cfg.embed_dim}")
    if params is None:
        params = init_deepfm(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
    off = torch.from_numpy(field_offsets(cfg)).to(device)
    opt = AdamW(lr=linear_warmup_cosine(1e-3, 10, train_steps))
    state = opt.init(params)
    step = make_deepfm_train_step(cfg, opt)

    def batch_of(seed: int, s: int, b: int) -> dict:
        return {k: torch.from_numpy(v).to(device)
                for k, v in recsys_batch(seed, s, b, vocabs=vocabs).items()}

    losses = []
    for s in range(train_steps):
        batch = batch_of(0, s, train_batch)
        batch["offsets"] = off
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        if s % 10 == 0:
            print(f"train step {s:3d} loss={losses[-1]:.4f}")

    # online scoring with latency percentiles
    lat = []
    for r in range(serve_requests):
        d = recsys_batch(1, r, serve_batch, vocabs=vocabs)
        sync(device)
        t0 = time.perf_counter()
        serve_scores(params, cfg, torch.from_numpy(d["dense"]).to(device),
                     torch.from_numpy(d["sparse"]).to(device), off)
        sync(device)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat[WARMUP_REQUESTS:] or lat)
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    print(f"\nonline scoring B={serve_batch}: p50={p50:.2f}ms "
          f"p99={p99:.2f}ms")

    # retrieval: one query vs n_candidates candidates
    d = batch_of(2, 0, 1)
    cand = torch.arange(n_candidates, dtype=torch.int32, device=device) \
        % rows
    sync(device)
    t0 = time.perf_counter()
    s = retrieval_scores(params, cfg, d["dense"], d["sparse"], off, cand)
    top5 = torch.argsort(s.float().cpu(), stable=True).flip(0)[:5].tolist()
    ms = (time.perf_counter() - t0) * 1e3
    print(f"retrieval {n_candidates} candidates: {ms:.1f}ms, top-5 ids: "
          f"{top5}")
    return {"losses": losses, "p50_ms": p50, "p99_ms": p99,
            "retrieval_ms": ms, "top5": top5, "table_rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-steps", type=int, default=50)
    ap.add_argument("--train-batch", type=int, default=4096)
    ap.add_argument("--serve-batch", type=int, default=512)
    ap.add_argument("--serve-requests", type=int, default=50)
    ap.add_argument("--vocab-scale", type=float, default=0.01,
                    help="1.0 = full 33.8M-row Criteo table")
    device_argument(ap)
    args = ap.parse_args(argv)
    return run(args.train_steps, args.train_batch, args.serve_batch,
               args.serve_requests, args.vocab_scale, args.device)


if __name__ == "__main__":
    main()
