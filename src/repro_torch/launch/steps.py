"""Cell builder: (arch x shape) -> a train or serve step with its inputs,
the reference's ``src/repro/launch/steps.py`` for the LM, GNN and recsys
families.

``build_cell(arch, shape)`` returns a :class:`CellPlan`: ``fn(*args)``
runs one step (a train step returns ``(params, opt_state, {"loss",
"grad_norm", ...})``, a serve step its scores or logits), and ``loss``,
for a GNN or recsys train cell, is the loss ``fn`` differentiates, of
``(params, *args[2:])``.  The inputs are real tensors on one device (the
card unless ``device`` says otherwise), made from the reference's seeds:
an LM cell's tokens are the reference's ``_concretize`` draw (integers
in {0, 1} from ``np.random.default_rng(0)``, a dict's entries in sorted
key order) and a decode cell's cache is zeros at length seq - 1; the
graphs come from ``data.graphgen`` with seeds 3 (full graph, molecule; 5
and 7 for the molecule labels' and EGNN's coordinates' generators) and 4
(the minibatch cell's graph; 9 for its coordinates), the recsys batches
from ``recsys_batch(0, 0, B)``.  Those generators are numpy and
bit-equal to the reference's, so a port cell holds the reference cell's
data; the weights come from ``torch.Generator``s seeded 0, which draw
other numbers than the reference's JAX keys (``convert`` carries the
reference's across).

``device="meta"`` is the counterpart of the reference's
``concrete=False``: the parameters are drawn with no generator and every
input is an empty meta tensor of the reference's ShapeDtypeStruct (no
host data is made), so ``launch.count`` reckons a full-size step that no
card could hold.  The reference pads graph dims only for a mesh, so the
one-device cells keep the published sizes.  There is no mesh: the
shardings come with ROADMAP item 11.  The ``posdb-bfs`` arch has no cell,
as in the reference: its deployment runs through
``repro_torch.core.engine``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import GNNConfig, LMConfig, RecsysConfig
from ..configs.registry import CELL_FAMILIES, get_config, shapes_for
from ..core.csr import CSRIndex, build_csr
from ..core.engine import resolve_device
from ..data.graphgen import make_graph, make_molecule_batch
from ..data.recsys_stream import recsys_batch, vocab_sizes
from ..data.sampler import gather_block_features, sample_block
from ..models import gnn as gnn_mod
from ..models import recsys as recsys_mod
from ..models import transformer as tfm
from ..optim import AdamW, linear_warmup_cosine
from ..optim.tree import make_train_step

__all__ = ["CellPlan", "make_optimizer", "build_lm_cell", "build_gnn_cell",
           "build_recsys_cell", "build_cell"]

F32, I32 = torch.float32, torch.int32


@dataclasses.dataclass
class CellPlan:
    fn: Callable                 # one step: fn(*args)
    args: tuple                  # its inputs, tensors on one device
    description: str = ""
    loss: Optional[Callable] = None   # a train cell's loss(params, *args[2:])


def make_optimizer() -> AdamW:
    return AdamW(lr=linear_warmup_cosine(3e-4, 200, 10_000))


def _on_meta(device) -> bool:
    return torch.device(device).type == "meta"


def _generator(device, seed: int = 0) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded ``seed``; none on ``meta``, where
    nothing is drawn."""
    if _on_meta(device):
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _empty(specs: dict, device) -> dict:
    """name -> (shape, dtype): empty tensors, the stand-ins of a meta
    cell."""
    return {k: torch.empty(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in specs.items()}


def _concrete_ints(shapes: dict, device) -> dict:
    """The reference's ``_concretize`` of int32 stand-ins of ``shapes``
    (name -> shape): integers in {0, 1} from one
    ``np.random.default_rng(0)``, drawn in sorted name order (JAX's leaf
    order of a dict); empty int32 tensors on ``meta``."""
    if _on_meta(device):
        return _empty({k: (v, I32) for k, v in shapes.items()}, device)
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, 2, shapes[k]).astype(
        np.int32)).to(device) for k in sorted(shapes)}


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def build_lm_cell(cfg: LMConfig, dims: dict, device) -> CellPlan:
    """The LM cell of ``dims``' kind: ``train`` (``make_train_step`` with
    AdamW over a (batch, seq) batch of tokens and labels), ``prefill``
    (``prefill`` of (batch, seq) tokens into a cache of seq positions) or
    ``decode`` (one ``decode_step`` of (batch,) tokens against a zero
    cache of seq positions at length seq - 1)."""
    kind, seq, batch = dims["kind"], dims["seq"], dims["batch"]
    params = tfm.init_lm(cfg, _generator(device), device)
    if kind == "train":
        opt = make_optimizer()
        data = _concrete_ints({"tokens": (batch, seq),
                               "labels": (batch, seq)}, device)
        return CellPlan(tfm.make_train_step(cfg, opt),
                        (params, opt.init(params), data),
                        f"train_step {batch}x{seq}")
    if kind == "prefill":
        def prefill(params, tokens):
            return tfm.prefill(params, tokens, cfg)
        tokens = _concrete_ints({"tokens": (batch, seq)}, device)["tokens"]
        return CellPlan(prefill, (params, tokens),
                        f"prefill {batch}x{seq}")
    if kind == "decode":
        def decode(params, tokens, cache):
            return tfm.decode_step(params, tokens, cache, cfg)
        # the cache arrives filled to seq - 1; one new token is decoded
        cache = tfm.init_cache(cfg, batch, seq, device=device)._replace(
            length=seq - 1)
        tokens = _concrete_ints({"tokens": (batch,)}, device)["tokens"]
        return CellPlan(decode, (params, tokens, cache),
                        f"serve_step(decode) {batch}xKV{seq}")
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_loss_graph(cfg: GNNConfig, pooled: bool) -> Callable:
    """The node cross-entropy of ``gnn_forward``, or, ``pooled`` (the
    molecule batches), of each graph's mean logits against its label."""
    def loss_fn(params, batch):
        logits = gnn_mod.gnn_forward(params, cfg, batch)
        if pooled:                       # molecule: graph-level head
            seg = batch["graph_of_node"]
            ngraph = batch["labels"].shape[0]
            pool = logits.new_zeros((ngraph, logits.shape[1])) \
                .index_add_(0, seg, logits)
            cnt = logits.new_zeros((ngraph,)).index_add_(
                0, seg, logits.new_ones((logits.shape[0],)))
            pooled_logits = pool / torch.clamp(cnt, min=1.0)[:, None]
            return gnn_mod.node_xent(pooled_logits, batch["labels"])
        return gnn_mod.node_xent(logits, batch["labels"], batch.get("mask"))
    return loss_fn


def _graph_specs(dims: dict, cfg: GNNConfig, kind: str, d_feat: int
                 ) -> dict:
    """The reference's ShapeDtypeStructs of a full-graph or molecule
    batch (name -> (shape, dtype)), unpadded as with no mesh."""
    if kind == "molecule":
        v = dims["batch"] * dims["n_nodes"]
        e, nlab = dims["batch"] * dims["n_edges"], dims["batch"]
    else:
        v, e, nlab = dims["n_nodes"], dims["n_edges"], dims["n_nodes"]
    specs = {"src": ((e,), I32), "dst": ((e,), I32),
             "feats": ((v, d_feat), F32), "labels": ((nlab,), I32)}
    if kind == "full_graph":
        specs["mask"] = ((v,), F32)
    else:
        specs["graph_of_node"] = ((v,), I32)
    if cfg.kind == "egnn":
        specs["coords"] = ((v, 3), F32)
    return specs


def _concrete_graph(dims: dict, cfg: GNNConfig, kind: str, d_feat: int,
                    n_classes: int, device) -> dict:
    if _on_meta(device):
        return _empty(_graph_specs(dims, cfg, kind, d_feat), device)
    if kind == "molecule":
        g = make_molecule_batch(dims["batch"], dims["n_nodes"],
                                dims["n_edges"], d_feat, seed=3)
        host = {"src": g.src, "dst": g.dst, "feats": g.feats,
                "labels": g.labels,
                "graph_of_node": np.repeat(np.arange(dims["batch"],
                                                     dtype=np.int32),
                                           dims["n_nodes"])}
    else:
        g = make_graph(dims["n_nodes"], dims["n_edges"], d_feat,
                       num_classes=n_classes, seed=3)
        host = {"src": g.src, "dst": g.dst, "feats": g.feats,
                "labels": g.labels,
                "mask": np.ones((g.num_vertices,), np.float32)}
    if cfg.kind == "egnn":
        rng = np.random.default_rng(7)
        host["coords"] = rng.standard_normal(
            (host["feats"].shape[0], 3)).astype(np.float32)
    return _tensors(host, device)


def build_gnn_cell(cfg: GNNConfig, dims: dict, device) -> CellPlan:
    kind = dims["kind"]
    opt = make_optimizer()
    d_feat, n_classes = dims["d_feat"], dims["n_classes"]
    params = gnn_mod.init_gnn(cfg, d_feat, n_classes, _generator(device),
                              device)
    if kind in ("full_graph", "molecule"):
        loss_fn = _gnn_loss_graph(cfg, pooled=kind == "molecule")
        batch = _concrete_graph(dims, cfg, kind, d_feat, n_classes, device)
        v, e = batch["feats"].shape[0], batch["src"].shape[0]
        return CellPlan(make_train_step(loss_fn, opt),
                        (params, opt.init(params), batch),
                        f"{kind} train_step V={v} E={e}", loss_fn)
    if kind == "minibatch":
        return _build_minibatch_cell(cfg, dims, opt, params, device)
    raise ValueError(kind)


def _build_minibatch_cell(cfg: GNNConfig, dims: dict, opt, params,
                          device) -> CellPlan:
    """Sampler + train step over the whole graph: ``sample_block`` (the
    paper's positional BFS) draws from a ``torch.Generator`` on the seeds'
    device seeded with ``seed_scalar`` (from none on ``meta``), or takes
    the caller's ``draws`` (``data.sampler.sample_block``'s)."""
    v, e = dims["n_nodes"], dims["n_edges"]
    bsz, fanout = dims["batch_nodes"], tuple(dims["fanout"])
    is_sage = cfg.kind == "graphsage"
    sage_cfg = dataclasses.replace(cfg, sample_sizes=fanout) if is_sage \
        else cfg

    def loss_fn(params, graph, seeds, seed_scalar, draws=None):
        csr = CSRIndex(graph["indptr"], graph["perm"])
        gen = None if draws is not None or _on_meta(seeds.device) else \
            _generator(seeds.device, int(seed_scalar))
        layers = sample_block(gen, csr, graph["dst"], seeds, fanout,
                              draws=draws)
        labels = graph["labels"].index_select(0, seeds)
        if is_sage:
            block = {"layer_feats": gather_block_features(graph["feats"],
                                                          layers),
                     "labels": labels}
            logits = gnn_mod.sage_block_forward(params, sage_cfg, block)
            return gnn_mod.node_xent(logits, labels)
        # generic arch: the sampled subgraph, each node's f children linked
        # to it, features by one gather
        nodes = torch.cat(layers)
        offs = np.cumsum([0] + [int(layer.shape[0])
                                for layer in layers]).tolist()
        srcs, dsts = [], []
        for li, f in enumerate(fanout):
            n_par = offs[li + 1] - offs[li]
            srcs.append(offs[li + 1] + torch.arange(n_par * f, dtype=I32,
                                                    device=seeds.device))
            dsts.append(offs[li] + torch.arange(
                n_par, dtype=I32, device=seeds.device).repeat_interleave(f))
        sub = {"src": torch.cat(srcs), "dst": torch.cat(dsts),
               "feats": graph["feats"].index_select(0, nodes)}
        if cfg.kind == "egnn":
            sub["coords"] = graph["coords"].index_select(0, nodes)
        logits = gnn_mod.gnn_forward(params, cfg, sub)
        return gnn_mod.node_xent(logits[:bsz], labels)

    if _on_meta(device):
        specs = {"indptr": ((v + 1,), I32), "perm": ((e,), I32),
                 "dst": ((e,), I32), "feats": ((v, dims["d_feat"]), F32),
                 "labels": ((v,), I32)}
        if cfg.kind == "egnn":
            specs["coords"] = ((v, 3), F32)
        args = (params, opt.init(params), _empty(specs, device),
                torch.empty((bsz,), dtype=I32, device=device),
                torch.empty((), dtype=I32, device=device))
        return CellPlan(make_train_step(loss_fn, opt), args,
                        f"sampled train_step B={bsz} fanout={fanout} over "
                        f"V={v} E={e}", loss_fn)
    g = make_graph(v, e, dims["d_feat"], num_classes=dims["n_classes"],
                   seed=4)
    csr = build_csr(torch.from_numpy(g.src).to(device), v)
    graph = {"indptr": csr.indptr, "perm": csr.perm,
             **_tensors({"dst": g.dst, "feats": g.feats, "labels": g.labels},
                        device)}
    if cfg.kind == "egnn":
        rng = np.random.default_rng(9)
        graph["coords"] = torch.from_numpy(
            rng.standard_normal((v, 3)).astype(np.float32)).to(device)
    args = (params, opt.init(params), graph,
            torch.arange(bsz, dtype=I32, device=device),
            torch.tensor(0, dtype=I32, device=device))
    return CellPlan(make_train_step(loss_fn, opt), args,
                    f"sampled train_step B={bsz} fanout={fanout} over "
                    f"V={v} E={e}", loss_fn)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

def build_recsys_cell(cfg: RecsysConfig, dims: dict, device) -> CellPlan:
    kind = dims["kind"]
    opt = make_optimizer()
    params = recsys_mod.init_deepfm(cfg, _generator(device), device)
    offsets = torch.from_numpy(recsys_mod.field_offsets(cfg)).to(device)

    def concrete_batch(b: int) -> dict:
        if _on_meta(device):
            return _empty({"dense": ((b, cfg.n_dense), F32),
                           "sparse": ((b, cfg.n_sparse), I32),
                           "label": ((b,), F32),
                           "offsets": (tuple(offsets.shape), I32)}, device)
        out = _tensors(recsys_batch(0, 0, b,
                                    vocabs=vocab_sizes(cfg.vocab_scale)),
                       device)
        out["offsets"] = offsets
        return out

    if kind == "train":
        b = dims["batch"]
        return CellPlan(recsys_mod.make_deepfm_train_step(cfg, opt),
                        (params, opt.init(params), concrete_batch(b)),
                        f"train_step B={b}", recsys_mod.deepfm_loss_fn(cfg))

    if kind == "serve":
        b = dims["batch"]

        def serve(params, batch):
            return recsys_mod.serve_scores(params, cfg, batch["dense"],
                                           batch["sparse"], batch["offsets"])
        return CellPlan(serve, (params, concrete_batch(b)),
                        f"serve_scores B={b}")

    if kind == "retrieval":
        nc = dims["n_candidates"]

        def retrieve(params, batch, cand_ids):
            return recsys_mod.retrieval_scores(
                params, cfg, batch["dense"], batch["sparse"],
                batch["offsets"], cand_ids)
        cand = torch.empty((nc,), dtype=I32, device=device) \
            if _on_meta(device) else \
            torch.arange(nc, dtype=I32, device=device) % 1000
        return CellPlan(retrieve, (params, concrete_batch(1), cand),
                        f"retrieval_scores C={nc}")
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_id: str, *, smoke: bool = False,
               device=None, attn_window: int | None = None) -> CellPlan:
    """The cell ``arch`` x ``shape_id`` with concrete inputs on ``device``
    (``None``: the card, raising where CUDA is unavailable; ``"meta"``:
    empty stand-ins of the reference's shapes and dtypes);
    ``attn_window`` sets an LM config's sliding window.  The
    ``posdb-bfs`` arch raises ``ValueError``, as the reference's
    does."""
    cfg, family = get_config(arch, smoke=smoke)
    if family not in CELL_FAMILIES:
        raise ValueError(f"{arch!r} ({family}) has no cell: its deployment "
                         "runs through repro_torch.core.engine")
    device = resolve_device(device)
    dims = shapes_for(family, smoke=smoke)[shape_id]
    if family == "lm":
        if attn_window is not None:
            cfg = dataclasses.replace(cfg, attn_window=attn_window)
        return build_lm_cell(cfg, dims, device)
    if family == "gnn":
        return build_gnn_cell(cfg, dims, device)
    return build_recsys_cell(cfg, dims, device)
