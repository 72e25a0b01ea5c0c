"""Architecture and shape registry of the models the port serves and
trains: the five language models, the four GNN architectures, DeepFM and
the paper's own BFS deployment (``posdb-bfs``), with their published
input shapes and the reduced shapes of the CPU tests (the reference's
``src/repro/configs/registry.py``, its own copy).  ``cells`` enumerates
every (arch x shape) cell with its skip reason, as the reference's does;
``launch.steps.build_cell`` builds the LM, GNN and recsys cells (the BFS
deployment is driven through ``repro_torch.core.engine``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Iterator

ARCHS: dict[str, tuple[str, str]] = {
    # arch id                  family    config module
    "deepseek-v2-lite-16b":   ("lm",
                               "repro_torch.configs.deepseek_v2_lite_16b"),
    "phi3.5-moe-42b":         ("lm", "repro_torch.configs.phi35_moe_42b"),
    "qwen2-0.5b":             ("lm", "repro_torch.configs.qwen2_0_5b"),
    "stablelm-1.6b":          ("lm", "repro_torch.configs.stablelm_1_6b"),
    "stablelm-12b":           ("lm", "repro_torch.configs.stablelm_12b"),
    "gatedgcn":               ("gnn", "repro_torch.configs.gatedgcn"),
    "graphsage-reddit":       ("gnn", "repro_torch.configs.graphsage_reddit"),
    "egnn":                   ("gnn", "repro_torch.configs.egnn"),
    "gat-cora":               ("gnn", "repro_torch.configs.gat_cora"),
    "deepfm":                 ("recsys", "repro_torch.configs.deepfm"),
    "posdb-bfs":              ("bfs", "repro_torch.configs.posdb_bfs"),
}

# the families whose cells ``launch.steps.build_cell`` builds
CELL_FAMILIES = ("lm", "gnn", "recsys")

LM_SHAPES: dict[str, dict[str, Any]] = {
    "train_4k":    dict(kind="train",   seq=4096,   batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,  batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,  batch=128),
    "long_500k":   dict(kind="decode",  seq=524288, batch=1),
}

GNN_SHAPES: dict[str, dict[str, Any]] = {
    "full_graph_sm": dict(kind="full_graph", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg":  dict(kind="minibatch", n_nodes=232965,
                          n_edges=114615892, batch_nodes=1024,
                          fanout=(15, 10), d_feat=602, n_classes=41),
    "ogb_products":  dict(kind="full_graph", n_nodes=2449029,
                          n_edges=61859140, d_feat=100, n_classes=47),
    "molecule":      dict(kind="molecule", n_nodes=30, n_edges=64,
                          batch=128, d_feat=16, n_classes=2),
}

RECSYS_SHAPES: dict[str, dict[str, Any]] = {
    "train_batch":    dict(kind="train", batch=65536),
    "serve_p99":      dict(kind="serve", batch=512),
    "serve_bulk":     dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}

BFS_SHAPES: dict[str, dict[str, Any]] = {
    "traverse_1m": dict(kind="bfs"),
}

# reduced dims for per-cell smoke tests (same code path, CPU-sized)
SMOKE_LM_SHAPES = {
    "train_4k":    dict(kind="train",   seq=32,  batch=2),
    "prefill_32k": dict(kind="prefill", seq=32,  batch=2),
    "decode_32k":  dict(kind="decode",  seq=32,  batch=2),
    "long_500k":   dict(kind="decode",  seq=64,  batch=1),
}
SMOKE_GNN_SHAPES = {
    "full_graph_sm": dict(kind="full_graph", n_nodes=120, n_edges=480,
                          d_feat=24, n_classes=5),
    "minibatch_lg":  dict(kind="minibatch", n_nodes=500, n_edges=4000,
                          batch_nodes=16, fanout=(4, 3), d_feat=24,
                          n_classes=5),
    "ogb_products":  dict(kind="full_graph", n_nodes=300, n_edges=1500,
                          d_feat=24, n_classes=5),
    "molecule":      dict(kind="molecule", n_nodes=12, n_edges=30, batch=8,
                          d_feat=8, n_classes=2),
}
SMOKE_RECSYS_SHAPES = {
    "train_batch":    dict(kind="train", batch=64),
    "serve_p99":      dict(kind="serve", batch=16),
    "serve_bulk":     dict(kind="serve", batch=128),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=512),
}


def get_config(arch: str, smoke: bool = False):
    """``(config, family)`` of ``arch``: its module's ``SMOKE`` when
    ``smoke``, else its ``CONFIG``."""
    family, mod_name = ARCHS[arch]
    mod = importlib.import_module(mod_name)
    return (mod.SMOKE if smoke else mod.CONFIG), family


def shapes_for(family: str, smoke: bool = False) -> dict[str, dict]:
    """The shapes of a family ("lm", "gnn", "recsys" or "bfs"), published
    or smoke (the BFS shape has no smoke cut)."""
    if family == "lm":
        return SMOKE_LM_SHAPES if smoke else LM_SHAPES
    if family == "gnn":
        return SMOKE_GNN_SHAPES if smoke else GNN_SHAPES
    if family == "recsys":
        return SMOKE_RECSYS_SHAPES if smoke else RECSYS_SHAPES
    if family == "bfs":
        return BFS_SHAPES
    raise ValueError(f"no family {family!r}")


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    family: str
    dims: dict
    skip: str | None = None           # why the cell is skipped, if it is


# the reference's reason for skipping the published long_500k cell of an
# arch with full attention
LONG_500K_SKIP = ("pure full-attention arch: 512k-KV decode cell reserved "
                  "for sub-quadratic attention (DESIGN.md §4); run with "
                  "--attn-window for the documented extra")


def cells(include_bfs: bool = False, smoke: bool = False) -> Iterator[Cell]:
    """Every (arch x shape) cell in the reference's order, the BFS
    deployment's only with ``include_bfs``; the published ``long_500k``
    cell of an arch with no attention window carries the reference's
    skip reason."""
    for arch, (family, _) in ARCHS.items():
        if family == "bfs" and not include_bfs:
            continue
        cfg, _ = get_config(arch, smoke)
        for shape_id, dims in shapes_for(family, smoke).items():
            skip = None
            if family == "lm" and shape_id == "long_500k" and not smoke \
                    and getattr(cfg, "attn_window", None) is None:
                skip = LONG_500K_SKIP
            yield Cell(arch=arch, shape=shape_id, family=family,
                       dims=dict(dims), skip=skip)
