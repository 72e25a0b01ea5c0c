"""GNN zoo: GatedGCN, GraphSAGE, EGNN, GAT, on positional message passing,
with the train step.

The port of ``src/repro/models/gnn.py``.  An edge list is a
join index (positions into the node table), aggregation is a positional
join, and node features are gathered only where touched.  GraphSAGE's
full-graph mean aggregation goes through the ``spmm_segment`` kernel on
the card (:func:`sage_layer`); every other aggregation is a plain
``index_add_`` (the reference's ``jax.ops.segment_sum``), every dense
layer a ``torch.matmul``, and nothing here calls ``embedding_bag``.
Every forward is differentiable: ``spmm_segment``'s gradient is the same
kernel over the edges grouped by source, which :func:`sort_edges` groups
once a forward when the features need a gradient.

All four architectures share one interface:
``init_gnn(cfg, d_feat, num_classes, generator)`` / ``gnn_forward(params,
cfg, graph)`` where ``graph`` = dict(src, dst, feats[, coords]) of
tensors on one device, every ``src``/``dst`` in [0, N).  Sampled
minibatches (GraphSAGE fan-out blocks) use :func:`sage_block_forward`.
Parameters are a nested dict/list of tensors with the reference's keys, so
``convert.gnn_params_from_numpy`` carries the reference's ``init_gnn``
tree across.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import GNNConfig
from ..core.engine import resolve_device
from ..kernels.spmm_segment.ops import (Grouping, segments,
                                        spmm_segment_sorted,
                                        transpose_grouping)
from ..optim.tree import make_train_step

__all__ = ["segment_softmax", "init_gatedgcn_layer", "gatedgcn_layer",
           "init_sage_layer", "SortedEdges", "sort_edges", "sage_layer",
           "init_egnn_layer", "egnn_layer", "init_gat_layer", "gat_layer",
           "init_gnn", "gnn_forward", "sage_block_forward", "node_xent",
           "make_gnn_train_step"]

Params = Dict[str, Any]


def _normal(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


def _dense(g: torch.Generator, din: int, dout: int, device) -> Params:
    return {"w": _normal(g, (din, dout), device) * (2.0 / din) ** 0.5,
            "b": torch.zeros((dout,), dtype=torch.float32, device=device)}


def _apply_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _mlp(g: torch.Generator, dims, device) -> list:
    return [_dense(g, a, b, device) for a, b in zip(dims[:-1], dims[1:])]


def _apply_mlp(ps: list, x: torch.Tensor, act=F.silu,
               final_act: bool = False) -> torch.Tensor:
    for i, p in enumerate(ps):
        x = _apply_dense(p, x)
        if i < len(ps) - 1 or final_act:
            x = act(x)
    return x


def _segment_sum(data: torch.Tensor, seg: torch.Tensor, num: int
                 ) -> torch.Tensor:
    return data.new_zeros((num,) + tuple(data.shape[1:])).index_add_(
        0, seg, data)


def _in_degree(dst: torch.Tensor, num: int, like: torch.Tensor
               ) -> torch.Tensor:
    """(num,) edges a row, at least 1, in ``like``'s dtype."""
    deg = _segment_sum(like.new_ones((dst.shape[0],)), dst, num)
    return torch.clamp(deg, min=1.0)


def segment_softmax(scores: torch.Tensor, seg: torch.Tensor, num: int
                    ) -> torch.Tensor:
    """Softmax of ``scores`` (E,) or (E, H) within each segment of ``seg``
    (E,): an (E, H) input is H independent softmaxes.  An empty segment's
    maximum is ``-inf``, which is then taken as 0, as the reference takes
    JAX's ``segment_max`` of an empty segment."""
    idx = seg.long().view((-1,) + (1,) * (scores.dim() - 1)) \
        .expand_as(scores)
    smax = scores.new_full((num,) + tuple(scores.shape[1:]), -math.inf) \
        .scatter_reduce(0, idx, scores, "amax", include_self=False)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    e = torch.exp(scores - smax.index_select(0, seg))
    den = _segment_sum(e, seg, num)
    return e / torch.clamp(den.index_select(0, seg), min=1e-12)


def _rms_scale(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """x * gain / (||x|| / sqrt(d) + 1e-6), row by row."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x * gain / (norm / math.sqrt(x.shape[-1]) + 1e-6)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def init_gatedgcn_layer(g: torch.Generator, d: int, device) -> Params:
    p = {k: _dense(g, d, d, device) for k in ("A", "B", "C", "U", "V")}
    p["ln_h"] = torch.ones((d,), dtype=torch.float32, device=device)
    p["ln_e"] = torch.ones((d,), dtype=torch.float32, device=device)
    return p


def gatedgcn_layer(p: Params, h, e, src, dst, n: int):
    """Bresson & Laurent gated graph conv with edge features + residuals."""
    eh = _apply_dense(p["A"], h).index_select(0, src) \
        + _apply_dense(p["B"], h).index_select(0, dst) \
        + _apply_dense(p["C"], e)
    eta = torch.sigmoid(eh)                                   # (E, d)
    vh = _apply_dense(p["V"], h)
    num = _segment_sum(eta * vh.index_select(0, src), dst, n)
    den = _segment_sum(eta, dst, n)
    agg = num / (den + 1e-6)
    h2 = _apply_dense(p["U"], h) + agg
    h2 = h + torch.relu(_rms_scale(h2, p["ln_h"]))
    e2 = e + torch.relu(_rms_scale(eh, p["ln_e"]))
    return h2, e2


def init_sage_layer(g: torch.Generator, din: int, dout: int, device
                    ) -> Params:
    return {"self": _dense(g, din, dout, device),
            "nbr": _dense(g, din, dout, device)}


class SortedEdges(NamedTuple):
    """A graph's edges grouped by destination once, for every
    :func:`sage_layer` of a forward pass, and by source when the
    aggregation's gradient is needed."""

    src: torch.Tensor       # (E,) sources in destination order
    seg: torch.Tensor       # (E,) destinations, sorted
    offsets: torch.Tensor   # (n + 1,) int32 row starts
    ones: torch.Tensor      # (E,) float32 weights
    deg: torch.Tensor       # (n,) float32 in-degree, at least 1
    transposed: Optional[Grouping] = None   # the backward's edges


def sort_edges(src: torch.Tensor, dst: torch.Tensor, n: int,
               transpose: bool = False) -> SortedEdges:
    """One stable sort of the edges by destination (``spmm_segment``'s
    :func:`segments`) and, with ``transpose``, one by source
    (``transpose_grouping``)."""
    s = segments(dst, n)
    deg = torch.clamp(s.offsets.diff().to(torch.float32), min=1.0)
    by_dst = src.index_select(0, s.order)
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    t = transpose_grouping(by_dst, s.seg, ones, n) if transpose else None
    return SortedEdges(by_dst, s.seg, s.offsets, ones, deg, t)


def sage_layer(p: Params, h, src, dst, n: int,
               edges: Optional[SortedEdges] = None) -> torch.Tensor:
    """Mean aggregation through ``spmm_segment`` on the edges sorted by
    destination: ``edges`` from :func:`sort_edges` (sorted once for a
    whole forward pass), or sorted here when None, as the
    ``spmm_segment`` wrapper sorts them on every call."""
    if edges is None:
        edges = sort_edges(src, dst, n)
    total = spmm_segment_sorted(h, edges.src, edges.seg, edges.ones,
                                edges.offsets, transposed=edges.transposed)
    mean = total / edges.deg[:, None]
    return torch.relu(_apply_dense(p["self"], h)
                      + _apply_dense(p["nbr"], mean))


def init_egnn_layer(g: torch.Generator, d: int, device) -> Params:
    return {"phi_e": _mlp(g, (2 * d + 1, d, d), device),
            "phi_x": _mlp(g, (d, d, 1), device),
            "phi_h": _mlp(g, (2 * d, d, d), device)}


def egnn_layer(p: Params, h, x, src, dst, n: int):
    """E(n)-equivariant layer (Satorras et al.): scalar messages from
    invariant distances; coordinate updates along edge vectors."""
    dx = x.index_select(0, src) - x.index_select(0, dst)
    d2 = torch.sum(dx * dx, dim=-1, keepdim=True)
    m = _apply_mlp(p["phi_e"], torch.cat([h.index_select(0, src),
                                          h.index_select(0, dst), d2], -1),
                   final_act=True)
    coef = torch.tanh(_apply_mlp(p["phi_x"], m))             # bounded update
    xup = _segment_sum(dx * coef, dst, n) / _in_degree(dst, n, x)[:, None]
    magg = _segment_sum(m, dst, n)
    h2 = h + _apply_mlp(p["phi_h"], torch.cat([h, magg], -1))
    return h2, x + xup


def init_gat_layer(g: torch.Generator, din: int, dout: int, heads: int,
                   device) -> Params:
    return {"w": _normal(g, (din, heads, dout), device) * (2.0 / din) ** 0.5,
            "a_src": _normal(g, (heads, dout), device) * 0.1,
            "a_dst": _normal(g, (heads, dout), device) * 0.1}


def gat_layer(p: Params, h, src, dst, n: int, concat: bool = True):
    """SDDMM edge scores -> segment softmax -> weighted aggregation; the
    heads' softmaxes in one call (the reference loops over them)."""
    z = torch.einsum("nd,dhk->nhk", h, p["w"])                # (N, H, K)
    s_src = torch.einsum("nhk,hk->nh", z, p["a_src"])
    s_dst = torch.einsum("nhk,hk->nh", z, p["a_dst"])
    scores = F.leaky_relu(s_src.index_select(0, src)
                          + s_dst.index_select(0, dst), 0.2)  # (E, H)
    alpha = segment_softmax(scores, dst, n)                   # (E, H)
    msg = z.index_select(0, src) * alpha[..., None]
    agg = _segment_sum(msg, dst, n)                           # (N, H, K)
    if concat:
        return F.elu(agg.reshape(n, -1))
    return agg.mean(dim=1)


# ---------------------------------------------------------------------------
# full models
# ---------------------------------------------------------------------------

def init_gnn(cfg: GNNConfig, d_feat: int, num_classes: int,
             generator: torch.Generator, device=None) -> Params:
    """Parameters with the reference's tree, shapes and scales (dense
    weights He-normal, biases zero, GAT's attention vectors N(0, 0.01)),
    drawn from ``generator``, which must live on ``device`` (``None``: the
    card)."""
    device = resolve_device(device)
    g = generator
    d = cfg.d_hidden
    p: Params = {"embed_in": _dense(g, d_feat, d, device)}
    if cfg.kind == "gatedgcn":
        p["edge_in"] = _dense(g, 1, d, device)
        p["layers"] = [init_gatedgcn_layer(g, d, device)
                       for _ in range(cfg.n_layers)]
    elif cfg.kind == "graphsage":
        p["layers"] = [init_sage_layer(g, d, d, device)
                       for _ in range(cfg.n_layers)]
    elif cfg.kind == "egnn":
        p["layers"] = [init_egnn_layer(g, d, device)
                       for _ in range(cfg.n_layers)]
    elif cfg.kind == "gat":
        heads = cfg.n_heads
        p["layers"] = [init_gat_layer(g, d if i == 0 else d * heads, d,
                                      heads, device)
                       for i in range(cfg.n_layers - 1)]
        p["layers"].append(init_gat_layer(
            g, d * heads if cfg.n_layers > 1 else d, d, heads, device))
    else:
        raise ValueError(cfg.kind)
    width = d * cfg.n_heads if cfg.kind == "gat" else d
    p["head"] = _dense(g, width, num_classes, device)
    return p


def gnn_forward(params: Params, cfg: GNNConfig,
                graph: Dict[str, torch.Tensor]) -> torch.Tensor:
    """graph: src, dst (E,) int32; feats (N, F); [coords (N, 3)].
    Returns per-node logits (N, num_classes).  GraphSAGE sorts the edges
    by destination once (:func:`sort_edges`), and by source when the
    features need a gradient, and runs ``spmm_segment`` on them in each
    layer."""
    src, dst = graph["src"], graph["dst"]
    n = graph["feats"].shape[0]
    h = _apply_dense(params["embed_in"], graph["feats"])
    if cfg.kind == "gatedgcn":
        e = _apply_dense(params["edge_in"],
                         h.new_ones((src.shape[0], 1)))
        for lp in params["layers"]:
            h, e = gatedgcn_layer(lp, h, e, src, dst, n)
    elif cfg.kind == "graphsage":
        edges = sort_edges(src, dst, n, transpose=torch.is_grad_enabled()
                           and h.requires_grad)
        for lp in params["layers"]:
            h = sage_layer(lp, h, src, dst, n, edges)
    elif cfg.kind == "egnn":
        x = graph["coords"]
        for lp in params["layers"]:
            h, x = egnn_layer(lp, h, x, src, dst, n)
    elif cfg.kind == "gat":
        for lp in params["layers"]:
            h = gat_layer(lp, h, src, dst, n, concat=True)
    else:
        raise ValueError(cfg.kind)
    return _apply_dense(params["head"], h)


# ---------------------------------------------------------------------------
# sampled-block forward (GraphSAGE minibatch; the paper's PRecursive applied
# to neighbor sampling)
# ---------------------------------------------------------------------------

def sage_block_forward(params: Params, cfg: GNNConfig,
                       block: Dict[str, Any]) -> torch.Tensor:
    """block: ``layer_feats`` = [h_L ... h_0], the sampled layers' node
    features deepest first (``data.sampler.gather_block_features``).
    Layer l averages the fan-out children of each layer-(l-1) node: the
    f children of parent i are rows i * f ... i * f + f - 1, so the
    reference's segment sum is a sum over a reshape here."""
    hs = [_apply_dense(params["embed_in"], f) for f in block["layer_feats"]]
    # hs[0] = deepest (largest) layer ... hs[-1] = seeds
    for lp in params["layers"]:
        nxt = []
        for depth in range(len(hs) - 1):
            child, parent = hs[depth], hs[depth + 1]   # (N * f, d), (N, d)
            n_par = parent.shape[0]
            f = child.shape[0] // n_par
            mean = child.reshape(n_par, f, -1).sum(dim=1) / f
            nxt.append(torch.relu(_apply_dense(lp["self"], parent)
                                  + _apply_dense(lp["nbr"], mean)))
        hs = nxt
    return _apply_dense(params["head"], hs[-1])


def node_xent(logits: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy of the nodes' logits against their labels, over
    the nodes ``mask`` weighs when given."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    per = lse - gold
    if mask is not None:
        return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return per.mean()


def make_gnn_train_step(cfg: GNNConfig, optimizer, *, block: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})``: the node cross-entropy of :func:`gnn_forward` on
    ``batch`` (src, dst, feats, labels[, mask, coords]), or with
    ``block`` of :func:`sage_block_forward` (layer_feats, labels), its
    gradient by autograd, and one ``optimizer.update``."""
    def loss_fn(params, batch):
        if block:
            logits = sage_block_forward(params, cfg, batch)
            return node_xent(logits, batch["labels"])
        logits = gnn_forward(params, cfg, batch)
        return node_xent(logits, batch["labels"], batch.get("mask"))

    return make_train_step(loss_fn, optimizer)
