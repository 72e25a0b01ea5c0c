"""Counting a step's work in eager PyTorch: the port's counterpart of the
reference's ``compiled.cost_analysis()`` (FLOPs, ``bytes accessed``) and
of ``memory_analysis()``'s argument and output sizes.

:class:`CountMode` is a ``TorchDispatchMode``: every op dispatched while
it is on is counted once, as it runs, on whatever device its tensors lie
on (``meta`` included, where nothing is computed or held).

- **FLOPs** come from ``torch.utils.flop_counter``'s registered formulas
  (the matmuls, convolutions and attention ops), kept by dtype: a
  float32 product counts as ``"tf32"`` where
  ``torch.backends.cuda.matmul.allow_tf32`` is on at count time, else as
  ``"float32"``.  Elementwise FLOPs are not counted; XLA counts them,
  so on an LM forward the count sits below the reference's
  ``cost_analysis()["flops"]`` (``tests/test_torch_roofline.py``).
- **Bytes** are each op's tensor inputs and outputs, numel times element
  size; views, allocations without a write and metadata ops count zero.
  This is the eager traffic: every intermediate goes through device
  memory once written and once per read.
- **Kernels.**  Inside a kernel's public call (``kernels/accounting.py``)
  the mode charges that kernel's declared ``work`` once and counts none
  of the ops inside, so a step counts the same on ``meta``, on the CPU
  and on the card, whether the kernel, its plain version or its meta
  branch ran.
- **Arguments and outputs.**  :func:`count_call` records the bytes of the
  distinct tensors of a call's arguments and of its outputs.  The
  compulsory traffic of a step is their sum: each argument read once,
  each output written once.

The peak of live bytes is not tracked: on the card,
``torch.cuda.max_memory_allocated`` measures it.  Collective bytes are
not counted on one device (ROADMAP item 11).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels.accounting import COUNTERS, Work

__all__ = ["Count", "CountMode", "count_call", "flop_dtype", "tensor_bytes"]

aten = torch.ops.aten

# ops that move no tensor bytes: allocations that write nothing, and
# metadata and a scalar's host read (views are found by their schema,
# ``OpOverload.is_view``)
_FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh,
         aten.sym_size, aten.sym_stride, aten.sym_numel,
         aten.sym_storage_offset, aten.is_same_size, aten.set_,
         aten.resize_, aten._local_scalar_dense}


def flop_dtype(dtype: torch.dtype) -> str:
    """The key a product in ``dtype`` counts under: the dtype's name, and
    ``"tf32"`` for float32 where TF32 matmuls are allowed."""
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return str(dtype).removeprefix("torch.")


def tensor_bytes(tree: Any) -> int:
    """Bytes of the distinct tensors among ``tree``'s leaves."""
    seen = {id(t): t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}
    return sum(t.numel() * t.element_size() for t in seen.values())


@dataclasses.dataclass
class Count:
    """One counted call: FLOPs by dtype key, the eager bytes, the
    argument and output bytes, the kernels' charges and the ops that moved
    bytes (a kernel's public call not among them)."""

    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)
    ops: int = 0
    count_s: float = 0.0

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def compulsory_bytes(self) -> float:
        return self.argument_bytes + self.output_bytes

    def row(self) -> dict:
        return {"flops": self.flops,
                "flops_by_dtype": dict(sorted(self.flops_by_dtype.items())),
                "hbm_bytes": self.hbm_bytes,
                "compulsory_bytes": self.compulsory_bytes,
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())},
                "ops": self.ops}


class CountMode(TorchDispatchMode):
    """Counts the ops dispatched while it is on into :attr:`count`."""

    def __init__(self):
        super().__init__()
        self.count = Count()
        self._flops = collections.defaultdict(float)
        self._depth = 0            # > 0 inside a kernel's public call

    def __enter__(self):
        COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        COUNTERS.remove(self)
        self.count.flops_by_dtype = dict(self._flops)
        return super().__exit__(*exc)

    def kernel_call(self, name: str, work: Callable[..., Work],
                    fn: Callable, args: tuple, kwargs: dict):
        """Run one kernel's public call, charging its ``work`` once where
        no other kernel's call encloses it."""
        if self._depth:
            return fn(*args, **kwargs)
        w = work(*args, **kwargs)
        entry = self.count.kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        entry["calls"] += 1
        entry["flops"] += w.flops
        entry["bytes"] += w.bytes
        if w.flops:
            self._flops["float32"] += w.flops
        self.count.hbm_bytes += w.bytes
        self._depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._depth -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            first = next(t for t in tree_leaves((args, kwargs))
                         if isinstance(t, torch.Tensor))
            self._flops[flop_dtype(first.dtype)] += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and packet not in _FREE:
            self.count.ops += 1
            self.count.hbm_bytes += sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


def count_call(fn: Callable, *args, **kwargs) -> tuple[Any, Count]:
    """``fn(*args, **kwargs)`` under a :class:`CountMode`: its output and
    its :class:`Count`, with the argument and output bytes and the host
    seconds the counted call took."""
    mode = CountMode()
    t0 = time.perf_counter()
    with mode:
        out = fn(*args, **kwargs)
    count = mode.count
    count.count_s = time.perf_counter() - t0
    count.argument_bytes = float(tensor_bytes((args, kwargs)))
    count.output_bytes = float(tensor_bytes(out))
    return out, count
