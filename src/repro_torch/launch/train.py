"""Training driver: the LM step loop with atomic checkpoints, exact-resume
data streams and straggler monitoring (the reference's
``src/repro/launch/train.py``, on one device).

Batch ``s`` is ``data.tokens.lm_batch(seed, s, ...)``, bit-equal to the
reference's, so a run restored from a checkpoint replays the stream from
its step exactly.  The step is ``models.transformer.make_train_step``
with ``launch.steps.make_optimizer``'s AdamW; parameters are held in
float32 and the compute runs in the config's dtype.  It runs on the card
unless ``device`` (``--device``) says otherwise.  A checkpoint written on
a mesh and resumed on another (the reference's ``shardings``) waits for
the multi-device slice (ROADMAP item 11).

    python -m repro_torch.launch.train --arch qwen2-0.5b --smoke --steps 50
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs.registry import ARCHS, get_config
from ..core.engine import resolve_device
from ..data.tokens import lm_batch
from ..distributed.fault_tolerance import StragglerMonitor
from ..launch.steps import make_optimizer
from ..models import transformer as tfm

__all__ = ["TrainRun", "build_run", "main"]


@dataclasses.dataclass
class TrainRun:
    """Holds the step function and the state; restartable."""

    cfg: object
    params: dict
    opt_state: dict
    step_fn: object
    step: int = 0

    def run(self, *, steps: int, batch: int, seq: int, seed: int,
            ckpt: CheckpointManager | None, ckpt_every: int = 50,
            log_every: int = 10, monitor: StragglerMonitor | None = None):
        """Steps ``self.step`` .. ``steps - 1``, a checkpoint every
        ``ckpt_every`` steps and one at the end; returns each step's
        metrics as floats."""
        device = self.opt_state["step"].device
        metrics_hist = []
        for s in range(self.step, steps):
            t0 = time.time()
            data = lm_batch(seed, s, batch, seq, self.cfg.vocab)
            data = {k: torch.from_numpy(v).to(device)
                    for k, v in data.items()}
            self.params, self.opt_state, m = self.step_fn(
                self.params, self.opt_state, data)
            m = {k: float(v) for k, v in m.items()}
            dt = time.time() - t0
            if monitor is not None and monitor.record(dt):
                # straggling step: on a cluster the launcher re-dispatches
                # the microbatch to a hot spare; single-process we log it.
                print(f"  [straggler] step {s} took {dt:.2f}s "
                      f"(deadline {monitor.deadline:.2f}s)")
            self.step = s + 1
            metrics_hist.append(m)
            if s % log_every == 0:
                print(f"step {s:5d} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.2f} {dt*1e3:.0f}ms")
            if ckpt is not None and (s + 1) % ckpt_every == 0:
                ckpt.save(s + 1, {"params": self.params,
                                  "opt_state": self.opt_state})
        if ckpt is not None:
            ckpt.save(self.step, {"params": self.params,
                                  "opt_state": self.opt_state})
            ckpt.wait()
        return metrics_hist


def build_run(arch: str, *, smoke: bool, resume_dir: str | None = None,
              device=None) -> TrainRun:
    """``arch``'s config, random float32 weights from a generator seeded 0
    on ``device`` (``None``: the card), AdamW state, and the train step;
    restored from the newest checkpoint in ``resume_dir`` where there is
    one."""
    cfg, family = get_config(arch, smoke=smoke)
    if family != "lm":
        raise SystemExit(f"train.py drives LM archs; use examples/ for "
                         f"{family}")
    device = resolve_device(device)
    opt = make_optimizer()
    params = tfm.init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    opt_state = opt.init(params)
    run = TrainRun(cfg, params, opt_state, tfm.make_train_step(cfg, opt))
    if resume_dir:
        mgr = CheckpointManager(resume_dir)
        like = {"params": params, "opt_state": opt_state}
        step, restored = mgr.restore_latest(like, device)
        if restored is not None:
            run.params = restored["params"]
            run.opt_state = restored["opt_state"]
            run.step = step
            print(f"resumed from step {step}")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train an LM on the synthetic token stream, on the card "
                    "unless --device says otherwise.")
    ap.add_argument("--arch", choices=[a for a, (f, _) in ARCHS.items()
                                       if f == "lm"], required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    args = ap.parse_args(argv)

    ckpt = CheckpointManager(args.ckpt_dir, async_save=True) \
        if args.ckpt_dir else None
    run = build_run(args.arch, smoke=args.smoke,
                    resume_dir=args.ckpt_dir if args.resume else None,
                    device=args.device)
    hist = run.run(steps=args.steps, batch=args.batch, seq=args.seq,
                   seed=args.seed, ckpt=ckpt, ckpt_every=args.ckpt_every,
                   monitor=StragglerMonitor())
    print(f"final loss {hist[-1]['loss']:.4f} over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
