"""What the examples share: the device's clock and a warm timing."""
from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["sync", "timed_ms", "device_argument"]


def sync(device: torch.device) -> None:
    """Wait for the card's queue where ``device`` is the card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn: Callable, device: torch.device, reps: int = 1):
    """``fn()`` once to warm up, then ``reps`` runs: (the last result,
    the mean ms a run, host clock around a synchronized run)."""
    out = fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3 / reps


def device_argument(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
