"""Plain PyTorch version of the BFS frontier expansion — the PRecursive hot
loop.  It is the engine's own vectorized expansion
(:func:`repro_torch.core.csr.expand_frontier`), re-exported so the kernel is
held against exactly what the engine computes without the kernel.

:func:`expand_case` makes the seeded inputs that split the kernel's tiles
(2,048 targets a scan block, 256 output slots an expansion block), and
:func:`expand_lanes_case` stacks each as the lanes of one batched call,
shared by the CPU parity tests, the card tests and ``chip_smoke.py``.
The plain version takes the lane axis as the engine's expansion does."""
from __future__ import annotations

import numpy as np

from ...core.csr import CSRIndex, expand_frontier

# The cases of :func:`expand_case`.  The JAX reference's plain version
# raises at F = 0 and E = 0 (a gather from an empty array), so the parity
# tests against it take EXPAND_CASES without those two.
EXPAND_CASES = ("f2047", "f2048", "f2049", "f4097", "zero_run", "hub",
                "edge_total", "edge_cut", "cut", "out_of_range", "f1", "f0",
                "e0")


def frontier_expand_ref(csr: CSRIndex, targets, valid, capacity: int):
    return expand_frontier(csr, targets, valid, capacity)


def expand_case(case: str):
    """Seeded host inputs of one expansion: (src (E,) int32, V, targets
    (F,) int32, valid (F,) bool, capacity).  A graph of V = 6,000 and
    E = 12,000 random edges (about one vertex in seven has no out-edge),
    and targets in [-1, V) of which four in five are valid, except:

    - ``f2047`` .. ``f4097``: F at and beside the scan tile; F = 2048 with
      capacity equal to the total, F = 2049 cut 100 short of it;
    - ``zero_run``: F = 6,000 with slots [1900, 4200) of zero degree (a
      whole scan tile among them), invalid, -1 or out-degree 0;
    - ``hub``: vertex 7 owns 2,000 more edges and sits at slot 1,500, so
      its range spans eight output tiles;
    - ``edge_total`` / ``edge_cut``: a total of exactly 1,024 (an output
      tile edge) under capacity 1,280, or cut at 768;
    - ``cut``: capacity 1,000, below the total and no tile multiple;
    - ``out_of_range``: valid targets -7, -1, V and V + 3 among the rest;
    - ``f1``: one target, the vertex of highest degree; ``f0``: none;
    - ``e0``: a graph with no edges."""
    if case not in EXPAND_CASES:
        raise ValueError(f"unknown case {case!r}; have {EXPAND_CASES}")
    rng = np.random.default_rng(EXPAND_CASES.index(case) + 40)
    v, e = 6000, 0 if case == "e0" else 12000
    src = rng.integers(0, v, e).astype(np.int32)
    if case == "hub":
        src = np.concatenate([src, np.full(2000, 7, np.int32)])
        rng.shuffle(src)
    deg = np.bincount(src, minlength=v)
    f = {"f2047": 2047, "f2048": 2048, "f2049": 2049, "f4097": 4097,
         "zero_run": 6000, "f1": 1, "f0": 0}.get(case, 3000)
    targets = rng.integers(-1, v, f).astype(np.int32)
    valid = rng.random(f) < 0.8
    capacity = {"f2047": 4000, "f4097": 8192, "cut": 1000}.get(case, 0)
    if case == "zero_run":
        run = slice(1900, 4200)
        n = run.stop - run.start
        leaves = np.flatnonzero(deg == 0).astype(np.int32)
        targets[run] = np.where(rng.random(n) < 0.5, -1,
                                rng.choice(leaves, n))
        valid[run] = rng.random(n) < 0.7
    elif case == "hub":
        targets[1500], valid[1500] = 7, True
    elif case in ("edge_total", "edge_cut"):
        # live targets up to a running total of 1,024, topped up with
        # degree-1 vertices, the rest invalid
        live = rng.choice(np.flatnonzero(deg > 0), f).astype(np.int32)
        upto = int(np.searchsorted(np.cumsum(deg[live]), 1024, "right"))
        short = 1024 - int(deg[live[:upto]].sum())
        ones = rng.choice(np.flatnonzero(deg == 1), short).astype(np.int32)
        targets = np.concatenate([live[:upto], ones,
                                  np.full(f - upto - short, -1, np.int32)])
        valid = np.arange(f) < upto + short
        capacity = 1280 if case == "edge_total" else 768
    elif case == "out_of_range":
        idx = rng.choice(f, 4, replace=False)
        targets[idx], valid[idx] = (-7, -1, v, v + 3), True
    elif case == "f1":
        targets[0], valid[0] = int(np.argmax(deg)), True
    live = valid & (targets >= 0) & (targets < v)
    total = int(deg[np.where(live, targets, 0)][live].sum())
    if case == "f2048":
        capacity = total
    elif case == "f2049":
        capacity = total - 100
    elif not capacity:
        capacity = total + 300
    return src, v, targets, valid, capacity


def expand_lanes_case(case: str):
    """:func:`expand_case` stacked as four lanes of one call over its
    graph: (src, V, targets (4, F), valid (4, F), capacity).  Lane 0 is
    the case; lane 1 has no valid target (an empty lane beside, in the
    ``hub`` case, the hub's); lane 2 is lane 0 reversed (another scan
    over the same total, so the same overflow); lane 3 keeps every other
    valid target of lane 0."""
    src, v, targets, valid, capacity = expand_case(case)
    keep = valid.copy()
    keep[np.flatnonzero(valid)[::2]] = False
    return (src, v, np.stack([targets, targets, targets[::-1], targets]),
            np.stack([valid, np.zeros_like(valid), valid[::-1], keep]),
            capacity)
