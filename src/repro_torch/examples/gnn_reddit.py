"""GraphSAGE minibatch training with the positional neighbor sampler —
the paper's PRecursive engine applied to GNN data loading — on the port
(the reference's ``examples/gnn_reddit.py``).

Synthetic graph with Reddit-like statistics (default scaled down; --full
for 233k nodes / 115M edges).  Each step draws its seeds and the
sampler's draws from a ``torch.Generator`` seeded with the step (the
reference splits ``PRNGKey(step)``).  No hand-written kernel runs on
this path, as in the reference: the block forward sums each node's
fan-out children through a reshape, and the sampler's and the feature
gathers are ``index_select``s.

    PYTHONPATH=src python -m repro_torch.examples.gnn_reddit --steps 100
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from ..configs.base import GNNConfig
from ..core.csr import build_csr
from ..core.engine import resolve_device
from ..data.graphgen import make_graph
from ..data.sampler import gather_block_features, sample_block
from ..models.gnn import init_gnn, make_gnn_train_step
from ..optim import AdamW, linear_warmup_cosine
from ._common import device_argument, sync

__all__ = ["FANOUT", "sage_config", "run", "main"]

FANOUT = (15, 10)


def sage_config() -> GNNConfig:
    return GNNConfig(name="sage", kind="graphsage", n_layers=2,
                     d_hidden=128, d_feat=64, num_classes=41,
                     sample_sizes=FANOUT)


def run(nodes: int, edges: int, batch: int, steps: int, device=None, *,
        params: Optional[dict] = None,
        sample: Optional[Callable] = None, log_every: int = 20) -> dict:
    """``steps`` AdamW steps of the block GraphSAGE on a seeded R-MAT
    graph (seed 0): ``{"losses", "seconds", "seeds_per_s"}``.  ``params``
    (``None``: drawn from a generator seeded 0) and ``sample(step) ->
    (seeds (B,) int32, draws)`` (``None``: both from a generator seeded
    with the step) let a caller replay another run's weights and
    draws."""
    device = resolve_device(device)
    cfg = sage_config()
    g = make_graph(nodes, edges, cfg.d_feat, num_classes=cfg.num_classes,
                   seed=0)
    csr = build_csr(torch.from_numpy(g.src).to(device), nodes)
    feats = torch.from_numpy(g.feats).to(device)
    labels = torch.from_numpy(g.labels).to(device)
    dst = torch.from_numpy(g.dst).to(device)

    if params is None:
        params = init_gnn(cfg, cfg.d_feat, cfg.num_classes,
                          torch.Generator(device=device).manual_seed(0),
                          device)
    opt = AdamW(lr=linear_warmup_cosine(1e-3, 20, steps))
    state = opt.init(params)
    step = make_gnn_train_step(cfg, opt, block=True)

    losses = []
    sync(device)
    t0 = time.perf_counter()
    for s in range(steps):
        gen, draws = None, None
        if sample is None:
            gen = torch.Generator(device=device).manual_seed(s)
            seeds = torch.randint(0, nodes, (batch,), generator=gen,
                                  device=device, dtype=torch.int32)
        else:
            seeds, draws = sample(s)
            seeds = seeds.to(device)
        layers = sample_block(gen, csr, dst, seeds, FANOUT,
                              draws=draws)                  # positions
        block = {"layer_feats": gather_block_features(feats, layers),
                 "labels": labels.index_select(0, seeds)}  # ONE gather
        params, state, m = step(params, state, block)
        losses.append(float(m["loss"]))
        if s % log_every == 0:
            print(f"step {s:4d} loss={losses[-1]:.4f}")
    sync(device)
    dt = time.perf_counter() - t0
    print(f"\n{steps} steps in {dt:.1f}s ({steps * batch / dt:.0f} "
          "seeds/s); sampler moved only node positions until the final "
          "feature gather.")
    return {"losses": losses, "seconds": dt, "seeds_per_s": steps * batch
            / dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--edges", type=int, default=400_000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--full", action="store_true",
                    help="Reddit-scale: 233k nodes / 115M edges")
    device_argument(ap)
    args = ap.parse_args(argv)
    if args.full:
        args.nodes, args.edges = 232_965, 114_615_892
    return run(args.nodes, args.edges, args.batch, args.steps, args.device)


if __name__ == "__main__":
    main()
