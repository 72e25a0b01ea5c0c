"""Criteo-like synthetic stream for the DeepFM architecture.

A copy of the reference's ``src/repro/data/recsys_stream.py``: the same
numpy calls in the same order, so the same seed gives the same arrays.
39 fields (13 numeric + 26 categorical with heavy-tailed vocabularies);
categorical ids are positions into the embedding table.
"""
from __future__ import annotations

import numpy as np

__all__ = ["N_DENSE", "N_SPARSE", "CRITEO_VOCABS", "vocab_sizes",
           "recsys_batch"]

N_DENSE = 13
N_SPARSE = 26

# Published Criteo-1TB per-field cardinalities (rounded), heavy-tailed.
CRITEO_VOCABS = [
    7912889, 33823, 17139, 7339, 20046, 4, 7105, 1382, 63, 5554114,
    582469, 245828, 11, 2209, 10667, 104, 4, 968, 15, 8165896,
    2675940, 7156453, 302516, 12022, 97, 35,
]


def vocab_sizes(scale: float = 1.0) -> list[int]:
    return [max(4, int(v * scale)) for v in CRITEO_VOCABS]


def recsys_batch(seed: int, step: int, batch: int,
                 vocabs: list[int] | None = None) -> dict[str, np.ndarray]:
    """``dense`` (B, 13) float32, ``sparse`` (B, 26) int32 per-field ids,
    ``label`` (B,) float32."""
    vocabs = vocabs or vocab_sizes()
    rng = np.random.default_rng(np.random.PCG64DXSM([seed, step, 7]))
    dense = rng.standard_normal((batch, N_DENSE)).astype(np.float32)
    sparse = np.stack(
        [(rng.zipf(1.2, batch) % v).astype(np.int32) for v in vocabs], axis=1)
    label = (rng.random(batch) < 0.25).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "label": label}
