"""Synthetic LM token pipeline.

The port of ``src/repro/data/tokens.py``.  Stateless and seeded: batch
``i`` is a pure function of (seed, step), so a restarted job resumes the
stream exactly by replaying (seed, step).  :func:`lm_batch` makes the
same numpy calls in the same order as the reference, so it gives the
same tokens bit for bit; :func:`lm_batch_on_device` draws uniform tokens
on the device from a ``torch.Generator`` (the reference draws them from a
JAX PRNG key, so the two give other numbers).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["lm_batch", "lm_batch_on_device"]


def lm_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int
             ) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.PCG64DXSM([seed, step]))
    # Zipfian-ish token draw (realistic skew, cheap to generate)
    z = rng.zipf(1.3, size=(batch, seq_len + 1))
    tok = (z % vocab).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def lm_batch_on_device(generator: torch.Generator, batch: int, seq_len: int,
                       vocab: int) -> dict[str, torch.Tensor]:
    """(batch, seq_len) int32 tokens and labels, uniform in [0, vocab), on
    the generator's device."""
    tok = torch.randint(0, vocab, (batch, seq_len + 1), generator=generator,
                        device=generator.device, dtype=torch.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
