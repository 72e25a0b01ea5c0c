"""A kernel's declared work, and how a counter hears of it.

Each kernel's ``ops.py`` has a ``work(...)`` that gives the FLOPs and
bytes of one public call from its arguments' shapes and dtypes alone:
bytes are the inputs read once and the outputs written once, as
``chip_smoke.py`` reckons each kernel's bound, with every data-dependent
count (live positions, distinct rows, reached edges) taken at the most
the shapes allow.  So the number is the same whether the kernel, the
plain version or the meta branch runs.

The public calls are wrapped by :func:`charged`.  While no counter
listens, the wrapper only calls through.  While one does
(``launch.count.CountMode`` appends itself to :data:`COUNTERS`), the
call is reported to the innermost counter as one call of the kernel,
which charges its ``work`` and counts none of the ops inside it; a
kernel called inside another's public call is part of the outer one.

:func:`on_meta` is each wrapper's test for its shape-only branch: every
one of the call's tensors, optional ones and those inside a ``CSRIndex``
or ``PullLayout`` too, on the ``meta`` device.  A call with a CUDA tensor
never takes it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

__all__ = ["Work", "COUNTERS", "charged", "on_meta"]


@dataclasses.dataclass(frozen=True)
class Work:
    """One kernel call's work: ``flops``, float32 operations off the
    tensor cores (every kernel here sums in float32 on the CUDA cores),
    and ``bytes`` moved."""

    flops: float = 0.0
    bytes: float = 0.0


# the counters listening in this process, innermost last
COUNTERS: list = []


def charged(name: str, work: Callable[..., Work]):
    """Decorator of a kernel's public call: where a counter listens, the
    call goes through the innermost counter's ``kernel_call(name, work,
    fn, args, kwargs)``; ``work`` takes the call's own arguments."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not COUNTERS:
                return fn(*args, **kwargs)
            return COUNTERS[-1].kernel_call(name, work, fn, args, kwargs)
        return call
    return wrap


def _tensors(objs):
    for o in objs:
        if isinstance(o, torch.Tensor):
            yield o
        elif isinstance(o, (tuple, list)):
            yield from _tensors(o)


def on_meta(*args) -> bool:
    """True where ``args`` (tensors, ``None``, and tuples or lists of
    them) hold a tensor and every tensor they hold lies on the ``meta``
    device."""
    tensors = list(_tensors(args))
    return bool(tensors) and all(t.device.type == "meta" for t in tensors)
