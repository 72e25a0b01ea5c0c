"""Ranks on one host: the default process group of this process, and
:func:`run_ranks`, which runs a function on ``W`` spawned ranks.

The rendezvous is a file store in a fresh temporary directory, so no TCP
port is picked and several runs may share a host.  The backend follows the
tensors: gloo for CPU ranks; for ranks on the card ``cpu:gloo,cuda:nccl``,
NCCL for CUDA tensors and gloo for CPU ones, rank ``r`` on ``cuda:r``.
NCCL runs one rank a card, so on a host with one card the world size on
the card is 1; a run of several ranks on one card is refused, not
simulated.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

__all__ = ["BACKENDS", "init_default_group", "run_ranks"]

BACKENDS = {"cpu": "gloo", "cuda": "cpu:gloo,cuda:nccl"}


def init_default_group(rank: int, world_size: int, store_path: str,
                       device_type: str = "cpu",
                       timeout_s: float = 120.0) -> None:
    """Initialise this process's default group as ``rank`` of
    ``world_size`` over the file store at ``store_path`` (a path no run
    has used), with a collective timeout of ``timeout_s``."""
    import torch
    import torch.distributed as dist
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}: one of "
                         f"{sorted(BACKENDS)}")
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(f"NCCL runs one rank a card: world size "
                             f"{world_size} on {cards} card(s)")
        torch.cuda.set_device(rank)
    dist.init_process_group(
        BACKENDS[device_type], init_method=f"file://{store_path}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(fn, rank, world_size, store_path, device_type, timeout_s,
               args, results) -> None:
    import torch
    import torch.distributed as dist
    # CPU ranks share the host's cores: one rank's threads on each of its
    # own, not every rank's on all of them
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world_size))
    try:
        init_default_group(rank, world_size, store_path, device_type,
                           timeout_s)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run_ranks(fn, world_size: int, *args, device_type: str = "cpu",
              timeout_s: float = 120.0) -> list:
    """``fn(rank, world_size, *args)`` on ``world_size`` ranks, each a
    spawned process with the default group initialised
    (:func:`init_default_group`) and destroyed after ``fn``, and with the
    host's cores split among the ranks' threads; returns the
    ranks' results in rank order.  ``fn`` and ``args`` are pickled (``fn``
    by its import path), and so are the results.  Raises if a rank fails,
    dies, or the ranks take longer than ``timeout_s`` in all; every
    process is ended before this returns or raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, store, device_type,
                               timeout_s, args, results))
             for r in range(world_size)]
    outs: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(outs) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world_size} ranks: "
                                   f"{world_size - len(outs)} gave no result "
                                   f"within {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in outs]
                if dead and results.empty():
                    raise RuntimeError(f"rank(s) {dead} of {world_size} "
                                       "died without a result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{out}")
            outs[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.pid is None:           # never started
                continue
            if p.is_alive():
                p.terminate()
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [outs[r] for r in range(world_size)]
