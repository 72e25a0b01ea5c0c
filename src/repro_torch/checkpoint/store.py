"""Checkpoint store: atomic, step-indexed, optionally written by a thread
(the reference's ``src/repro/checkpoint/store.py``).

The format is the reference's, so a checkpoint written by either package
restores in the other: one ``.npz`` per checkpoint, each leaf under its
path in the tree (dict keys, a list index written ``#i``, joined with
``/``).  A write goes to a temporary file that ``os.replace`` publishes,
so a half-written checkpoint is never picked up.

``restore_checkpoint(..., device=)`` puts every leaf on one device; the
reference's ``shardings`` (a checkpoint written on one mesh resumed on
another) wait for the port's multi-device slice.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..optim.tree import paths, unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager"]

_SEP = "/"


def _key(path: tuple) -> str:
    return _SEP.join(f"#{p}" if isinstance(p, int) else str(p)
                     for p in path)


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a numpy array of its own (a bfloat16 tensor as float32:
    numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy().copy()
    return np.array(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_key(path): _host(leaf) for path, leaf in paths(tree)}


def _write(path: str, flat: dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)                            # atomic publish


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    _write(path, _flatten(tree))
    return path


def restore_checkpoint(path: str, like: Any,
                       device: Optional[torch.device | str] = None) -> Any:
    """The checkpoint at ``path`` in the structure of ``like``: each leaf a
    tensor of ``like``'s leaf's dtype on ``device``, or, when ``device``
    is None, on the device of ``like``'s leaf (the CPU where that leaf is
    not a tensor, keeping the saved dtype).  Raises KeyError for a leaf
    the checkpoint lacks."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    keyed = [(_key(path), leaf) for path, leaf in paths(like)]
    missing = [k for k, _ in keyed if k not in flat]
    if missing:
        raise KeyError(f"checkpoint missing leaf {missing[0]!r}")

    def put(key: str, like_leaf: Any) -> torch.Tensor:
        t = torch.from_numpy(flat[key])
        if isinstance(like_leaf, torch.Tensor):
            return t.to(device=device or like_leaf.device,
                        dtype=like_leaf.dtype)
        return t.to(device or "cpu")

    return unflatten(like, [put(k, leaf) for k, leaf in keyed])


class CheckpointManager:
    """Step-indexed manager: rotation (the ``keep`` newest), the latest
    step, and an optional writer thread.  ``save`` copies the tree to the
    host before the thread starts, so the caller may change or free its
    tensors as soon as ``save`` returns."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def _existing(self) -> list[tuple[int, str]]:
        out = []
        for f in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d{8})\.npz", f)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, f)))
        return sorted(out)

    def latest_step(self) -> int | None:
        ex = self._existing()
        return ex[-1][0] if ex else None

    def save(self, step: int, tree: Any) -> None:
        flat_host = _flatten(tree)

        def write():
            _write(os.path.join(self.directory, f"ckpt_{step:08d}.npz"),
                   flat_host)
            self._gc()

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: Any,
                       device: Optional[torch.device | str] = None):
        """``(step, tree)`` of the newest checkpoint, or ``(None, None)``
        where there is none."""
        self.wait()
        ex = self._existing()
        if not ex:
            return None, None
        step, path = ex[-1]
        return step, restore_checkpoint(path, like, device)

    def _gc(self) -> None:
        ex = self._existing()
        for _, path in ex[:-self.keep] if self.keep else []:
            try:
                os.remove(path)
            except OSError:
                pass
