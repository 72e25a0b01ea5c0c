"""DeepFM over one shared embedding table, serving only.

The port of ``src/repro/models/recsys.py``'s forward and serving
functions.  All 39 fields (13 bucketized numeric + 26 categorical) share a
single concatenated table with static per-field offsets, so ids + offsets
are positions into that table.  The table lookup of
:func:`deepfm_forward` goes through ``fixed_hot_lookup``, so through the
``late_gather`` kernel on the card; the first-order lookup, the MLP and
retrieval's gathers stay plain PyTorch, as they are plain ``jnp`` in the
reference.  Parameters are a plain dictionary shaped as the reference's
pytree: ``table`` (R, D), ``first_order`` (R,), ``bias`` (), ``mlp`` a
list of ``{"w": (a, b), "b": (b,)}``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import RecsysConfig
from ..core.engine import resolve_device
from ..data.recsys_stream import vocab_sizes
from ..kernels.embedding_bag.ops import fixed_hot_lookup

__all__ = ["N_BUCKETS_DENSE", "field_vocabs", "field_offsets", "total_rows",
           "init_deepfm", "featurize", "deepfm_forward", "bce_loss",
           "serve_scores", "retrieval_scores"]

Params = Dict[str, Any]

N_BUCKETS_DENSE = 1000


def field_vocabs(cfg: RecsysConfig) -> list[int]:
    return [N_BUCKETS_DENSE] * cfg.n_dense + vocab_sizes(cfg.vocab_scale)


def field_offsets(cfg: RecsysConfig) -> np.ndarray:
    v = field_vocabs(cfg)
    return np.concatenate([[0], np.cumsum(v)[:-1]]).astype(np.int32)


def total_rows(cfg: RecsysConfig) -> int:
    """Table rows padded to a multiple of 512, as the reference pads them
    for row-wise sharding."""
    raw = int(sum(field_vocabs(cfg)))
    return -(-raw // 512) * 512


def init_deepfm(cfg: RecsysConfig, generator: torch.Generator,
                device=None) -> Params:
    """Parameters with the reference's shapes and scales: table and
    first-order weights N(0, 0.01^2) in ``cfg.table_dtype``, MLP weights
    He-normal, biases zero, drawn from ``generator`` (which must live on
    ``device``; ``None``: the card)."""
    device = resolve_device(device)
    rows = total_rows(cfg)
    nf = cfg.n_dense + cfg.n_sparse
    tdt = getattr(torch, cfg.table_dtype)

    def normal(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    table = (normal(rows, cfg.embed_dim) * 0.01).to(tdt)
    first_order = (normal(rows) * 0.01).to(tdt)
    dims = (nf * cfg.embed_dim, *cfg.mlp_dims, 1)
    mlp = [{"w": normal(a, b) * (2.0 / a) ** 0.5,
            "b": torch.zeros((b,), dtype=torch.float32, device=device)}
           for a, b in zip(dims[:-1], dims[1:])]
    return {"table": table, "first_order": first_order,
            "bias": torch.zeros((), dtype=torch.float32, device=device),
            "mlp": mlp}


def featurize(cfg: RecsysConfig, dense: torch.Tensor, sparse: torch.Tensor,
              offsets: torch.Tensor) -> torch.Tensor:
    """-> (B, 39) int32 positions into the shared table.  A numeric value
    lands in bucket ``int(sigmoid(x) * 1000)``, the reference's formula;
    where ``1000 * sigmoid(x)`` lies within a rounding of an integer, two
    float implementations of the sigmoid may pick neighbouring buckets."""
    buckets = (torch.sigmoid(dense) * N_BUCKETS_DENSE).to(torch.int32)
    buckets = buckets.clamp(0, N_BUCKETS_DENSE - 1)
    ids = torch.cat([buckets, sparse.to(torch.int32)], dim=1)
    return ids + offsets.to(torch.int32)[None, :]


def deepfm_forward(params: Params, cfg: RecsysConfig, dense: torch.Tensor,
                   sparse: torch.Tensor, offsets: torch.Tensor
                   ) -> torch.Tensor:
    """-> (B,) float32 logits."""
    b = dense.shape[0]
    pos = featurize(cfg, dense, sparse, offsets)              # (B, 39)
    emb = fixed_hot_lookup(params["table"], pos).to(torch.float32)
    fo = params["first_order"].index_select(0, pos.reshape(-1))
    fo = fo.reshape(pos.shape).to(torch.float32).sum(dim=1)   # (B,)
    # FM second order: ½[(Σv)² − Σv²] summed over the embedding dim
    s = emb.sum(dim=1)
    fm2 = 0.5 * ((s * s).sum(-1) - (emb * emb).sum((-1, -2)))
    h = emb.reshape(b, -1)
    for i, lp in enumerate(params["mlp"]):
        h = h @ lp["w"] + lp["b"]
        if i < len(params["mlp"]) - 1:
            h = torch.relu(h)
    return params["bias"] + fo + fm2 + h[:, 0]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def serve_scores(params: Params, cfg: RecsysConfig, dense, sparse,
                 offsets) -> torch.Tensor:
    """(B,) click probabilities."""
    return torch.sigmoid(deepfm_forward(params, cfg, dense, sparse, offsets))


def retrieval_scores(params: Params, cfg: RecsysConfig, dense, sparse,
                     offsets, cand_ids: torch.Tensor) -> torch.Tensor:
    """Score ONE query context against ``C`` candidate positions: the
    context folds to a single FM vector, the candidates are scored with one
    dot against their embedding rows; in the table's dtype, as the
    reference computes it."""
    pos = featurize(cfg, dense, sparse, offsets)              # (1, 39)
    table = params["table"]
    u = table.index_select(0, pos[0]).sum(dim=0)              # (D,)
    cand = table.index_select(0, cand_ids)                    # (C, D)
    cand_fo = params["first_order"].index_select(0, cand_ids)
    return cand @ u + cand_fo                                  # (C,)
