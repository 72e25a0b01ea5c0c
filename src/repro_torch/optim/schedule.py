"""Learning-rate schedules: functions of the step, an int32 tensor, that
return a float32 tensor on its device, computed in float32 as the
reference's ``optim/schedule.py`` computes them."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_decay", "linear_warmup_cosine"]

F32 = torch.float32


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=F32, device=like.device)


def constant(lr: float):
    return lambda step: _f32(lr, step)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step.to(F32), max=total_steps) / total_steps
        c = 0.5 * (1 + torch.cos(math.pi * t))
        return _f32(lr, step) * (final_frac + (1 - final_frac) * c)
    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(1, total_steps - warmup), final_frac)

    def fn(step):
        s = step.to(F32)
        warm = _f32(lr, step) * s / max(1, warmup)
        return torch.where(s < warmup, warm, cos(s - warmup))
    return fn
