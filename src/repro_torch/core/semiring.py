"""The semiring value plane: pluggable (⊕, ⊗) algebra for traversal.

A traversal can carry one float32 value per vertex: edges ⊗-propagate the
value along the traversed edge, and conflicts at a target vertex resolve
with the semiring's ⊕-combine.  BFS is the boolean special case
(``reach``, whose ⊕ is :func:`or_combine`), weighted SSSP is (min, +), and
path aggregation (bill-of-materials explosion) is (sum|min|max|mul, ×).

========================  =====  =====  ==========  ==========  =========
name                      ⊕      ⊗      identity    seed        improving
========================  =====  =====  ==========  ==========  =========
``reach``                 or     —      False       True        —
``shortest_path``         min    +      +inf        0.0         yes
``aggregate_sum``         sum    ×      0.0         1.0         no
``aggregate_max``         max    ×      -inf        1.0         no
``aggregate_min``         min    ×      +inf        1.0         no
``aggregate_mul``         mul    ×      1.0         1.0         no
========================  =====  =====  ==========  ==========  =========

``improving`` marks label-correcting semirings: the next frontier is the
set of vertices whose value strictly improved this round, and the fixed
point is value stabilization.  Walk semirings (the aggregates) re-expand
every vertex that received a value this level and are depth-bounded.

The scatters follow the reference's ``.at[idx]`` with ``mode="drop"`` for
indices >= 0: an index outside [0, n) goes to a spare slot that is sliced
off (torch on CUDA asserts where JAX drops).  A negative index is dropped
too, where a JAX index would count it from the end once; no caller passes
one (every engine caller clips its indices or routes a dropped lane to n).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

__all__ = ["Semiring", "SEMIRINGS", "WORKLOADS", "get_semiring",
           "or_combine", "scatter_combine", "elem_combine", "propagate"]


@dataclasses.dataclass(frozen=True)
class Semiring:
    """One (⊕, ⊗) pair plus the constants the operators need.

    ``combine``    ⊕ name: ``min`` | ``max`` | ``add`` | ``mul``.
    ``propagate``  ⊗ name: ``plus`` | ``mul`` (applied as value ⊗ weight).
    ``identity``   ⊕-identity; the initial per-vertex value.
    ``seed_value`` the root's value (the ⊗-identity: 0 for +, 1 for ×).
    ``improving``  label-correcting: frontier = strictly improved vertices.
    """
    name: str
    combine: str
    propagate: str
    identity: float
    seed_value: float
    improving: bool


SEMIRINGS: Dict[str, Semiring] = {
    s.name: s for s in (
        Semiring("shortest_path", "min", "plus", float("inf"), 0.0, True),
        Semiring("aggregate_sum", "add", "mul", 0.0, 1.0, False),
        Semiring("aggregate_max", "max", "mul", float("-inf"), 1.0, False),
        Semiring("aggregate_min", "min", "mul", float("inf"), 1.0, False),
        Semiring("aggregate_mul", "mul", "mul", 1.0, 1.0, False),
    )
}

# Every workload a query can carry.  ``reach`` has no Semiring entry: the
# boolean pipelines never consult the registry, so asking for it is a bug.
WORKLOADS: Tuple[str, ...] = ("reach", *SEMIRINGS)

# ⊕ name -> the scatter_reduce_ reduction
_SCATTER_REDUCE = {"min": "amin", "max": "amax", "add": "sum",
                   "mul": "prod"}


def get_semiring(name: str) -> Semiring:
    try:
        return SEMIRINGS[name]
    except KeyError:
        raise ValueError(
            f"unknown semiring {name!r}; known: {sorted(SEMIRINGS)}"
        ) from None


def _drop_slots(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 scatter indices into an (n + 1,) array: an index outside
    [0, n) goes to the spare slot ``n``."""
    return torch.where((idx >= 0) & (idx < n), idx, n).long()


def or_combine(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor
               ) -> torch.Tensor:
    """Boolean scatter-or: ``arr[idx[i]] |= vals[i]``, spelled as the
    scatter-max it is in the reference.  ``scatter_reduce`` takes no bool, so
    the max runs on int32.  ``arr`` is not modified.  An ``(L, n)`` ``arr``
    scatters each lane's row of ``vals`` into its own row, at ``idx`` of
    the same shape or at one ``(m,)`` index shared by every lane."""
    n = arr.shape[-1]
    ext = torch.zeros(arr.shape[:-1] + (n + 1,), dtype=torch.int32,
                      device=arr.device)
    ext[..., :n] = arr
    ext.scatter_reduce_(-1, _drop_slots(idx, n).expand(vals.shape),
                        vals.to(torch.int32), "amax")
    return ext[..., :n].bool()


def scatter_combine(sr: Semiring, arr: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """⊕-scatter ``vals`` into ``arr`` at ``idx`` (the dense combine), with
    ``arr``'s own values included.  ``arr`` is not modified.  An ``(L,
    n)`` ``arr`` scatters each lane's row of ``vals`` into its own row
    (its own spare slot included), at ``idx`` of the same shape or at one
    ``(m,)`` index shared by every lane.  On CUDA the sum and product
    scatters use atomics: with several values per index their order, and
    so the last bits, can change from run to run."""
    if sr.combine not in _SCATTER_REDUCE:
        raise ValueError(f"unknown combine {sr.combine!r}")
    n = arr.shape[-1]
    ext = torch.cat([arr, arr.new_full(arr.shape[:-1] + (1,), sr.identity)],
                    -1)
    ext.scatter_reduce_(-1, _drop_slots(idx, n).expand(vals.shape),
                        vals.to(arr.dtype), _SCATTER_REDUCE[sr.combine],
                        include_self=True)
    return ext[..., :n]


def elem_combine(sr: Semiring, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Elementwise ⊕ of two value planes."""
    if sr.combine == "min":
        return torch.minimum(a, b)
    if sr.combine == "max":
        return torch.maximum(a, b)
    if sr.combine == "add":
        return a + b
    if sr.combine == "mul":
        return a * b
    raise ValueError(f"unknown combine {sr.combine!r}")


def propagate(sr: Semiring, vals: torch.Tensor, weights: torch.Tensor
              ) -> torch.Tensor:
    """⊗: carry ``vals`` across edges with per-edge ``weights``."""
    if sr.propagate == "plus":
        return vals + weights
    if sr.propagate == "mul":
        return vals * weights
    raise ValueError(f"unknown propagate {sr.propagate!r}")
