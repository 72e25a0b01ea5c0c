"""Neighbour sampler: the paper's PRecursive engine applied to GraphSAGE.

The fan-out sampler is a capacity-bounded BFS over positions: each hop
expands node *positions* through the CSR index (uniformly subsampling each
vertex's CSR range to the fan-out, with replacement), and only at the end
are features materialized for the sampled nodes, one ``index_select`` a
layer: the engine's late materialization.

The port of ``src/repro/data/sampler.py``.  The draws come from a
``torch.Generator`` (the reference splits a JAX key each hop), or from the
caller as ``draws``; everything after the draw is the reference's
arithmetic, so the same draws give the same layers bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.csr import CSRIndex

__all__ = ["DRAW_HIGH", "sample_block", "gather_block_features"]

DRAW_HIGH = 1 << 30       # draws are uniform integers in [0, DRAW_HIGH)


def sample_block(generator: Optional[torch.Generator], csr: CSRIndex,
                 dst_of_edge: torch.Tensor, seeds: torch.Tensor,
                 fanouts: Sequence[int],
                 draws: Optional[Sequence[torch.Tensor]] = None
                 ) -> list[torch.Tensor]:
    """seeds (B,) int32 -> the per-hop node ids [seeds, hop1, hop2, ...]
    (hop l has B * prod(fanouts[:l]) entries, each node's f children
    consecutive).  Node v's j-th child is ``dst_of_edge[perm[indptr[v] +
    r % deg(v)]]`` for its draw r; a vertex with no edge samples itself.
    ``draws[l]`` is hop l's (n_l, f_l) int32 draws in [0, DRAW_HIGH); when
    ``draws`` is None they come from ``torch.randint`` with ``generator``,
    which must live on the tensors' device."""
    if draws is not None and len(draws) != len(fanouts):
        raise ValueError(f"{len(fanouts)} hops but {len(draws)} draws")
    layers = [seeds]
    cur = seeds
    last_edge = csr.num_edges - 1
    for li, f in enumerate(fanouts):
        n = cur.shape[0]
        if draws is None:
            r = torch.randint(0, DRAW_HIGH, (n, f), generator=generator,
                              device=cur.device, dtype=torch.int32)
        else:
            r = draws[li].to(device=cur.device, dtype=torch.int32)
            if tuple(r.shape) != (n, f):
                raise ValueError(f"hop {li}: draws of shape "
                                 f"{tuple(r.shape)}, want {(n, f)}")
        v = cur.clamp(0, csr.num_vertices - 1).long()
        start = csr.indptr.index_select(0, v)                    # (n,)
        deg = csr.indptr.index_select(0, v + 1) - start
        off = r % torch.clamp(deg, min=1)[:, None]
        pos = torch.clamp(start[:, None] + off, max=last_edge)
        epos = csr.perm.index_select(0, pos.reshape(-1).long())
        nbr = dst_of_edge.index_select(0, epos.long()).reshape(n, f)
        # isolated vertices sample themselves (self-loop fallback)
        nbr = torch.where((deg > 0)[:, None], nbr, cur[:, None])
        cur = nbr.reshape(-1)
        layers.append(cur)
    return layers


def gather_block_features(feats: torch.Tensor,
                          layers: Sequence[torch.Tensor]
                          ) -> list[torch.Tensor]:
    """The ONE late materialization: features for every sampled layer,
    deepest first (what ``models.gnn.sage_block_forward`` consumes)."""
    return [feats.index_select(0, layer) for layer in reversed(layers)]
