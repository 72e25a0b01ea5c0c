"""Synthetic graph generators for the GNN architectures.

A copy of the reference generator: the same numpy calls in the same order,
so the same seed gives the same arrays bit for bit.  The graphs have the
published datasets' node and edge counts and a power-law degree
distribution (R-MAT); the arrays stay numpy, and a caller moves them to
its device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["GraphData", "rmat_edges", "make_graph", "make_molecule_batch"]


class GraphData(NamedTuple):
    src: np.ndarray          # (E,) int32
    dst: np.ndarray          # (E,) int32
    feats: np.ndarray        # (V, F) float32
    labels: np.ndarray       # (V,) int32
    num_vertices: int
    num_classes: int


def rmat_edges(num_vertices: int, num_edges: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT power-law generator (Chakrabarti et al.), vectorized."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(2, num_vertices))))
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(num_edges)
        src = src * 2 + (r >= a + b)
        dst = dst * 2 + (((r >= a) & (r < a + b)) | (r >= a + b + c))
    src = (src % num_vertices).astype(np.int32)
    dst = (dst % num_vertices).astype(np.int32)
    return src, dst


def make_graph(num_vertices: int, num_edges: int, d_feat: int,
               num_classes: int = 16, seed: int = 0,
               undirected: bool = True) -> GraphData:
    """An R-MAT graph with standard-normal features and uniform labels;
    ``undirected`` draws half the edges and adds each one reversed."""
    src, dst = rmat_edges(num_vertices, num_edges // (2 if undirected else 1),
                          seed)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    rng = np.random.default_rng(seed + 1)
    feats = rng.standard_normal((num_vertices, d_feat)).astype(np.float32)
    labels = rng.integers(0, num_classes, num_vertices).astype(np.int32)
    return GraphData(src, dst, feats, labels, num_vertices, num_classes)


def make_molecule_batch(batch: int, nodes_per_graph: int,
                        edges_per_graph: int, d_feat: int, seed: int = 0
                        ) -> GraphData:
    """Batched small graphs (the `molecule` shape): their disjoint union,
    graph g's nodes at [g * nodes_per_graph, (g + 1) * nodes_per_graph)."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for g in range(batch):
        s = rng.integers(0, nodes_per_graph, edges_per_graph)
        d = rng.integers(0, nodes_per_graph, edges_per_graph)
        srcs.append(s + g * nodes_per_graph)
        dsts.append(d + g * nodes_per_graph)
    v = batch * nodes_per_graph
    feats = rng.standard_normal((v, d_feat)).astype(np.float32)
    labels = rng.integers(0, 2, batch).astype(np.int32)
    return GraphData(np.concatenate(srcs).astype(np.int32),
                     np.concatenate(dsts).astype(np.int32),
                     feats, labels, v, 2)
