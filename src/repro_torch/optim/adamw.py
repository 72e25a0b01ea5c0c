"""AdamW with decoupled weight decay, float32 moments and global-norm
clipping, and SGD with momentum (the reference's ``optim/adamw.py``).

The state follows the parameter tree: ``{"mu", "nu", "step"}`` for AdamW,
``{"vel", "step"}`` for SGD, ``step`` an int32 scalar tensor.  ``update``
returns new tensors and leaves its inputs as they were, as the
reference's pure functions do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .clip import clip_by_global_norm
from .tree import leaves, tree_map, unflatten

__all__ = ["AdamW", "sgd_momentum"]

F32 = torch.float32


def _zeros_f32(tree: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), tree)


def _step0(params: Any) -> torch.Tensor:
    first = leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable          # step -> learning rate
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0

    def init(self, params: Any) -> dict:
        return {"mu": _zeros_f32(params), "nu": _zeros_f32(params),
                "step": _step0(params)}

    def bias_corrections(self, step: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """1 - b1^step and 1 - b2^step as float32 tensors."""
        s = step.to(F32)
        return (1 - torch.pow(torch.tensor(self.b1, dtype=F32,
                                           device=s.device), s),
                1 - torch.pow(torch.tensor(self.b2, dtype=F32,
                                           device=s.device), s))

    def moments(self, g32, mu, nu):
        return (self.b1 * mu + (1 - self.b1) * g32,
                self.b2 * nu + (1 - self.b2) * g32 * g32)

    def update(self, params: Any, grads: Any, state: dict
               ) -> tuple[Any, dict, torch.Tensor]:
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        step = state["step"] + 1
        lr = self.lr(step)
        c1, c2 = self.bias_corrections(step)

        def upd(p, g, mu, nu):
            mu2, nu2 = self.moments(g.to(F32), mu, nu)
            p32 = p.to(F32)
            step_v = (mu2 / c1) / (torch.sqrt(nu2 / c2) + self.eps) \
                + self.weight_decay * p32
            return (p32 - lr * step_v).to(p.dtype), mu2, nu2

        out = [upd(p, g, m, n) for p, g, m, n in zip(
            leaves(params), leaves(grads), leaves(state["mu"]),
            leaves(state["nu"]))]
        new_p = unflatten(params, [o[0] for o in out])
        new_mu = unflatten(params, [o[1] for o in out])
        new_nu = unflatten(params, [o[2] for o in out])
        return new_p, {"mu": new_mu, "nu": new_nu, "step": step}, gnorm


@dataclasses.dataclass(frozen=True)
class sgd_momentum:
    lr: Callable
    momentum: float = 0.9
    max_grad_norm: float = 1.0

    def init(self, params: Any) -> dict:
        return {"vel": _zeros_f32(params), "step": _step0(params)}

    def update(self, params: Any, grads: Any, state: dict
               ) -> tuple[Any, dict, torch.Tensor]:
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        step = state["step"] + 1
        lr = self.lr(step)

        def upd(p, g, v):
            v2 = self.momentum * v + g.to(F32)
            return (p.to(F32) - lr * v2).to(p.dtype), v2

        out = [upd(p, g, v) for p, g, v in zip(
            leaves(params), leaves(grads), leaves(state["vel"]))]
        return (unflatten(params, [o[0] for o in out]),
                {"vel": unflatten(params, [o[1] for o in out]),
                 "step": step}, gnorm)
