"""End-to-end LM training with checkpoint/restart — a ~13M-param
qwen2-family model for a few hundred steps — on the port (the
reference's ``examples/train_lm.py``; crank --d-model/--layers for the
~100M variant).  The step is ``launch.train``'s: float32 weights and
AdamW state, bf16 compute, each layer recomputed in the backward.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs.base import LMConfig
from ..core.engine import resolve_device
from ..distributed.fault_tolerance import StragglerMonitor
from ..launch.steps import make_optimizer
from ..launch.train import TrainRun
from ..models import transformer as tfm
from ._common import device_argument

__all__ = ["example_config", "run", "main"]


def example_config(d_model: int = 256, layers: int = 4, vocab: int = 8192
                   ) -> LMConfig:
    return LMConfig(name="example-lm", n_layers=layers, d_model=d_model,
                    n_heads=d_model // 64,
                    n_kv_heads=max(1, d_model // 128), d_ff=d_model * 4,
                    vocab=vocab, qkv_bias=True, attn_chunk=64,
                    loss_chunk=64)


def run(steps: int, d_model: int, layers: int, batch: int, seq: int,
        vocab: int, ckpt_dir: str, resume: bool = False, device=None, *,
        params: Optional[dict] = None) -> dict:
    """``steps`` steps of ``launch.train.TrainRun`` on ``lm_batch(0, s,
    ...)`` with checkpoints in ``ckpt_dir`` (resumed from its newest with
    ``resume``): ``{"losses", "params_m", "resumed_at"}``.  ``params``
    (``None``: drawn from a generator seeded 0) lets a caller replay
    another run's weights."""
    device = resolve_device(device)
    cfg = example_config(d_model, layers, vocab)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.n_layers}L x {cfg.d_model}d, vocab {cfg.vocab})")
    opt = make_optimizer()
    if params is None:
        params = tfm.init_lm(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
    run_ = TrainRun(cfg, params, opt.init(params),
                    tfm.make_train_step(cfg, opt))
    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=True)
    resumed_at = None
    if resume:
        like = {"params": run_.params, "opt_state": run_.opt_state}
        step, restored = mgr.restore_latest(like, device)
        if restored is not None:
            run_.params = restored["params"]
            run_.opt_state = restored["opt_state"]
            run_.step = resumed_at = step
            print(f"resumed at step {step}")
    hist = run_.run(steps=steps, batch=batch, seq=seq, seed=0, ckpt=mgr,
                    ckpt_every=50, monitor=StragglerMonitor())
    losses = [h["loss"] for h in hist]
    if losses:
        print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} over "
              f"{len(losses)} steps; checkpoints in {ckpt_dir}")
    return {"losses": losses, "params_m": cfg.param_count() / 1e6,
            "resumed_at": resumed_at}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_lm_ckpt"),
                    help="checkpoint directory (default: repro_lm_ckpt "
                    "in the temporary directory, $TMPDIR where it is set)")
    ap.add_argument("--resume", action="store_true")
    device_argument(ap)
    args = ap.parse_args(argv)
    return run(args.steps, args.d_model, args.layers, args.batch, args.seq,
               args.vocab, args.ckpt_dir, args.resume, args.device)


if __name__ == "__main__":
    main()
