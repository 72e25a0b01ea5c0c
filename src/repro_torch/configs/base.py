"""Configuration dataclasses, copied from the reference's
``src/repro/configs/base.py`` (the port keeps its own copy)."""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 10
    mlp_dims: Sequence[int] = (400, 400, 400)
    vocab_scale: float = 1.0             # scales the Criteo vocabularies
    dtype: str = "float32"
    table_dtype: str = "float32"         # or "bfloat16"


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: Literal["gatedgcn", "graphsage", "egnn", "gat"]
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    d_feat: int = 128
    num_classes: int = 16
    sample_sizes: Sequence[int] = ()     # graphsage fanouts
    aggregator: str = "mean"
    dtype: str = "float32"
