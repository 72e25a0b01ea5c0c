"""Fault-injection seam: named points the bucket executor consults.

A tiny registry of NAMED injection points that the engine consults at the
exact places real faults would land.  Like the tracer seam, the disabled
path is one module-attribute read plus a truthiness check on an empty
dict: nothing is paid when no fault is armed, and this module stays a
LEAF (no :mod:`repro_torch.core` imports), preserving the obs package's
import contract.

Armed faults are CONSUMED: ``inject(point, value, times=n)`` fires on the
next ``n`` consults and then disarms itself (``times=None`` keeps firing
until :func:`clear`).  The injected *value* is point-specific:

* ``"bucket_overflow"``   — truthy: the executor treats the bucket's
  dispatch as overflowed, forcing the retry/eviction path.
* ``"straggler_sleep"``   — float seconds: the executor sleeps that long
  inside one bucket's timed interval, manufacturing a straggler.
* ``"plan_store_corrupt"``— truthy: a plan store's load truncates the
  bytes it just read before parsing, simulating a torn write.
* ``"calibrator_poison"`` — float (may be NaN/inf): replaces one measured
  per-bucket latency before it reaches a cost-model calibrator.

The last two are consulted by the planner and serving layers, which come
to the port with later slices; the registry names them already, so a
fault armed by name means the same thing in both packages.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["FAULT_POINTS", "inject", "clear", "consume", "armed",
           "injected"]

FAULT_POINTS = ("bucket_overflow", "straggler_sleep", "plan_store_corrupt",
                "calibrator_poison")

# point -> [value, remaining_fires or None]; consumers guard on the dict's
# truthiness first, so the common (nothing armed) case costs one attribute
# read — same budget as the disabled tracer
_ACTIVE: Dict[str, List[Any]] = {}


def inject(point: str, value: Any = True, *,
           times: Optional[int] = 1) -> None:
    """Arm ``point`` to fire ``times`` consults (``None`` = until cleared)."""
    if point not in FAULT_POINTS:
        raise ValueError(f"unknown fault point {point!r}; known: "
                         f"{FAULT_POINTS}")
    _ACTIVE[point] = [value, times]


def clear(point: Optional[str] = None) -> None:
    """Disarm one point, or every point when ``point`` is None."""
    if point is None:
        _ACTIVE.clear()
    else:
        _ACTIVE.pop(point, None)


def armed() -> bool:
    """True iff ANY fault is armed (the cheap outer guard consumers use)."""
    return bool(_ACTIVE)


def consume(point: str) -> Any:
    """The armed value for ``point`` (None if unarmed), decrementing its
    remaining fire count — a fault armed with ``times=1`` fires exactly
    once."""
    slot = _ACTIVE.get(point)
    if slot is None:
        return None
    value, remaining = slot
    if remaining is not None:
        remaining -= 1
        if remaining <= 0:
            del _ACTIVE[point]
        else:
            slot[1] = remaining
    return value


@contextlib.contextmanager
def injected(point: str, value: Any = True, *,
             times: Optional[int] = None) -> Iterator[None]:
    """Scope an armed fault to a ``with`` block (always disarmed on exit —
    chaos tests cannot leak faults into later tests)."""
    inject(point, value, times=times)
    try:
        yield
    finally:
        clear(point)
