"""DeepFM over one shared embedding table: serving and training.

The port of ``src/repro/models/recsys.py``.  All 39 fields (13 bucketized numeric + 26 categorical) share a
single concatenated table with static per-field offsets, so ids + offsets
are positions into that table.  The table lookup of
:func:`deepfm_forward` goes through ``fixed_hot_lookup``, so through the
``late_gather`` kernel on the card; the first-order lookup, the MLP and
retrieval's gathers stay plain PyTorch, as they are plain ``jnp`` in the
reference.  Parameters are a plain dictionary shaped as the reference's
pytree: ``table`` (R, D), ``first_order`` (R,), ``bias`` (), ``mlp`` a
list of ``{"w": (a, b), "b": (b,)}``.

Training: :func:`make_deepfm_train_step` differentiates the whole forward
(the table's gradient through ``late_gather``'s backward, a scatter-add
into the rows the batch touched, dense over the table) and takes one
dense optimizer step; :func:`make_deepfm_train_step_lazy` updates only
the touched rows of the table, the first-order weights and their
moments, after summing the gradients of repeated positions
(:func:`_dedup_positions`).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import RecsysConfig
from ..core.engine import resolve_device
from ..data.recsys_stream import vocab_sizes
from ..kernels.embedding_bag.ops import fixed_hot_lookup
from ..optim.tree import leaves, make_train_step, unflatten, value_and_grad

__all__ = ["N_BUCKETS_DENSE", "field_vocabs", "field_offsets", "total_rows",
           "init_deepfm", "featurize", "deepfm_forward", "bce_loss",
           "deepfm_loss_fn", "make_deepfm_train_step", "make_deepfm_train_step_lazy",
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


def deepfm_loss_fn(cfg: RecsysConfig):
    """``loss(params, batch)``: the logistic loss of :func:`deepfm_forward`
    over ``batch`` = dense, sparse, label, offsets."""
    def loss_fn(params, batch):
        logits = deepfm_forward(params, cfg, batch["dense"], batch["sparse"],
                                batch["offsets"])
        return bce_loss(logits, batch["label"])
    return loss_fn


def make_deepfm_train_step(cfg: RecsysConfig, optimizer):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})``: :func:`deepfm_loss_fn`'s gradient in every parameter
    (the table's dense, zero where no position of the batch lands) and one
    ``optimizer.update``."""
    return make_train_step(deepfm_loss_fn(cfg), optimizer)


def _dedup_positions(pos_flat: torch.Tensor, grads_flat: torch.Tensor,
                     num_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum the values of repeated positions (sort the positions, then
    segment-sum): ``(unique_pos (N,) int32, agg (N, ...))`` for N =
    ``pos_flat``'s length, the unique positions ascending and padded past
    their count with the sentinel ``num_rows``, ``agg`` zero there."""
    n = pos_flat.shape[0]
    ps, order = torch.sort(pos_flat, stable=True)
    gs = grads_flat.index_select(0, order)
    first = torch.ones_like(ps, dtype=torch.bool)
    first[1:] = ps[1:] != ps[:-1]
    seg = torch.cumsum(first.to(torch.int32), 0) - 1            # (n,)
    agg = gs.new_zeros((n,) + tuple(gs.shape[1:])).index_add_(0, seg, gs)
    upos = torch.full((n,), num_rows, dtype=torch.int32, device=ps.device)
    upos[seg.long()] = ps.to(torch.int32)
    return upos, agg


def make_deepfm_train_step_lazy(cfg: RecsysConfig, opt, mesh=None):
    """A step with the same signature as :func:`make_deepfm_train_step`
    whose table and first-order weights, and their moments, change only
    at the rows the batch touches: the positions are gathered once
    (``fixed_hot_lookup``, so ``late_gather`` on the card), the loss is
    differentiated with respect to the gathered rows, repeated positions'
    gradients are summed (:func:`_dedup_positions`) and each touched row
    takes ``opt``'s AdamW arithmetic; its weight decay is lazy (touched
    rows only).  The MLP and bias take the dense update.  Nothing is
    clipped, as in the reference.  Returns new tensors: the untouched rows
    are copies of the old ones.  ``mesh`` (the reference's sharded update)
    is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded lazy update waits for the port's multi-device "
            "slice (ROADMAP item 11)")
    f32 = torch.float32

    def loss_from_rows(small, emb_rows, fo_rows, batch):
        b = batch["dense"].shape[0]
        fo = fo_rows.sum(dim=1)
        s = emb_rows.sum(dim=1)
        fm2 = 0.5 * ((s * s).sum(-1) - (emb_rows * emb_rows).sum((-1, -2)))
        h = emb_rows.reshape(b, -1)
        for i, lp in enumerate(small["mlp"]):
            h = h @ lp["w"] + lp["b"]
            if i < len(small["mlp"]) - 1:
                h = torch.relu(h)
        logits = small["bias"] + fo + fm2 + h[:, 0]
        return bce_loss(logits, batch["label"])

    def step(params, opt_state, batch):
        rows_n = params["table"].shape[0]
        pos = featurize(cfg, batch["dense"], batch["sparse"],
                        batch["offsets"])                    # (B, F)
        with torch.no_grad():
            emb_rows = fixed_hot_lookup(params["table"], pos).to(f32)
            fo_rows = params["first_order"].index_select(
                0, pos.reshape(-1)).reshape(pos.shape).to(f32)
        small = {"mlp": params["mlp"], "bias": params["bias"]}
        loss, (g_small, g_emb, g_fo) = value_and_grad(
            lambda t: loss_from_rows(t[0], t[1], t[2], batch),
            [small, emb_rows, fo_rows])

        stp = opt_state["step"] + 1
        lr = opt.lr(stp)
        c1, c2 = opt.bias_corrections(stp)

        def adam(p, g32, mu, nu):
            mu2, nu2 = opt.moments(g32, mu, nu)
            upd = (mu2 / c1) / (torch.sqrt(nu2 / c2) + opt.eps) \
                + opt.weight_decay * p.to(f32)
            return (p.to(f32) - lr * upd).to(p.dtype), mu2, nu2

        def lazy_update(name, grads):
            flat = grads.reshape((pos.numel(),) + tuple(grads.shape[2:]))
            upos, agg = _dedup_positions(pos.reshape(-1), flat, rows_n)
            safe = torch.clamp(upos, max=rows_n - 1).long()
            old = (params[name], opt_state["mu"][name],
                   opt_state["nu"][name])
            p_rows, mu_rows, nu_rows = (t.index_select(0, safe) for t in old)
            new = adam(p_rows, agg, mu_rows, nu_rows)
            # where the reference's ``.at[upos].set(..., mode="drop")``
            # drops the sentinel slots (all after the ascending live
            # ones), they write slot 0's row again with slot 0's value
            # (its old one where no slot is live): the same bits whichever
            # write lands last, and no shape depends on the data, so the
            # step also runs on ``meta``
            live = upos < rows_n
            rows = torch.where(live, upos.long(), safe[:1])

            def write(t, v, was):
                keep = live.view((-1,) + (1,) * (v.dim() - 1))
                fill = torch.where(keep[:1], v[:1], was[:1])
                return t.clone().index_copy_(0, rows,
                                             torch.where(keep, v, fill))
            return tuple(write(t, v, was) for t, v, was in
                         zip(old, new, (p_rows, mu_rows, nu_rows)))

        new_table, mu_t, nu_t = lazy_update("table", g_emb)
        new_fo, mu_f, nu_f = lazy_update("first_order", g_fo)
        out = [adam(p, g.to(f32), mu, nu) for p, g, mu, nu in zip(
            leaves(small), leaves(g_small),
            leaves({"mlp": opt_state["mu"]["mlp"],
                    "bias": opt_state["mu"]["bias"]}),
            leaves({"mlp": opt_state["nu"]["mlp"],
                    "bias": opt_state["nu"]["bias"]}))]
        new_small, mu_small, nu_small = (
            unflatten(small, [o[k] for o in out]) for k in range(3))
        new_params = {"table": new_table, "first_order": new_fo,
                      "mlp": new_small["mlp"], "bias": new_small["bias"]}
        new_state = {
            "mu": {"table": mu_t, "first_order": mu_f,
                   "mlp": mu_small["mlp"], "bias": mu_small["bias"]},
            "nu": {"table": nu_t, "first_order": nu_f,
                   "mlp": nu_small["mlp"], "bias": nu_small["bias"]},
            "step": stp}
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in
                               leaves([g_small, g_emb, g_fo])))
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}

    return step


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
