"""Plain PyTorch version of the fused gather-scale-segment-sum (SpMM).

It is also the engine's CPU combine wherever a caller plugs the kernel
wrapper in: gather, then scale, then one ``index_add_``;
:func:`spmm_segment_lanes_ref` is the lane axis, a loop of it.

:func:`spmm_tile_case` makes the seeded inputs that cut the card kernel's
tiles of ``P`` edges (``tile_plan``) in every way its design can go wrong,
shared by the CPU parity tests, the card tests and ``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import torch

from .spmm_segment import SHORT_ROW, tile_plan


def spmm_segment_ref(x: torch.Tensor, src: torch.Tensor, seg: torch.Tensor,
                     weights: torch.Tensor, num_out: int) -> torch.Tensor:
    """out[v] = sum_{e: seg[e]=v} weights[e] * x[src[e]].

    ``x`` (N, D) features; ``src``/``seg`` (E,) int32 (``seg`` is the
    destination, in any order); ``weights`` (E,).  A ``src`` outside
    [0, N) is padding and contributes zero (callers pad with N); a ``seg``
    outside [0, num_out) is dropped.  Rows with no edge are zero."""
    n, d = x.shape
    live = (src >= 0) & (src < n)
    rows = x[src.clamp(0, n - 1).long()]
    rows = torch.where(live[:, None], rows, 0.0) * weights[:, None]
    slot = torch.where((seg >= 0) & (seg < num_out), seg, num_out).long()
    out = x.new_zeros((num_out + 1, d)).index_add_(0, slot, rows)
    return out[:num_out]


def spmm_segment_lanes_ref(x: torch.Tensor, src: torch.Tensor,
                           seg: torch.Tensor, weights: torch.Tensor,
                           num_out: int, mask: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The lane axis: lane l of (L, N, D) ``x`` through
    :func:`spmm_segment_ref` over the shared edges, with the sources that
    lane l of the optional (L, N) bool ``mask`` masks off padded to N.
    Returns (L, num_out, D)."""
    lanes, n, d = x.shape
    out = []
    for lane in range(lanes):
        s = src
        if mask is not None:
            s = torch.where(mask[lane][src.clamp(0, n - 1).long()], src, n)
        out.append(spmm_segment_ref(x[lane], s, seg, weights, num_out))
    if not out:
        return x.new_zeros((0, num_out, d))
    return torch.stack(out)


# The cases of :func:`spmm_tile_case`.
SPMM_CASES = ("medium_h", "hub_h1", "hub_kp_minus", "hub_kp", "hub_kp_plus",
              "hub_on_start", "hub_mid_tile", "adjacent_hubs",
              "hub_first_row", "hub_last_row", "dropped", "padded_hub",
              "medium_s1", "all_medium", "e_lt_p", "e0", "empty_out",
              "hub_many_tiles")
_ROWS, _NODES, _HUB = 600, 700, 40


def spmm_tile_case(case: str, dim: int):
    """Seeded host inputs of one call at row width ``dim``: (x (N, dim)
    float32, src (E,) int32, dst (E,) int32, w (E,) float32, num_out), the
    edges in random order.  600 rows of 0-3 edges over N = 700 sources
    (one source in nine is the padding N), signed weights, except, with P
    and H = 2P from ``tile_plan`` at ``dim`` and row 40 the hub unless
    named:

    - ``medium_h`` / ``hub_h1``: a row of exactly H edges (the longest
      medium row) / of H + 1 (the shortest hub), starting mid-tile;
    - ``hub_kp_minus`` / ``hub_kp`` / ``hub_kp_plus``: a hub of 5P - 1,
      5P or 5P + 1 edges starting on a tile start (the last tile one
      short, exact, or a tile start on the hub's last edge);
    - ``hub_on_start`` / ``hub_mid_tile``: a hub of 3P + 17 starting on a
      tile start / P / 2 + 3 past one (its prefix owns no tile start);
    - ``hub_many_tiles``: a hub of 40P + 3 edges starting P / 4 past a
      tile start: 40 partials, more than 4 a fixup slot at D >= 17 (8
      slots), so a slot adds several of them, 4 at a time;
    - ``adjacent_hubs``: rows 40 and 41, 2P + 100 and 3P + 7 edges, the
      first starting mid-tile;
    - ``hub_first_row`` / ``hub_last_row``: row 0 of 3P + 5 edges / the
      last row, sized so that E % P == 1 (a tile start on the last edge);
    - ``dropped``: 2P + 11 edges with dst < 0 and 3P + 5 with
      dst >= num_out, hubs at row 0 (2P + 50) and row 300 (3P);
    - ``padded_hub``: a hub of 3P + 3 edges whose sources are all N;
    - ``medium_s1``: one row of S + 1 = 33 edges; ``all_medium``: rows
      250-529 of 33-96 edges each (whole blocks of medium rows);
    - ``e_lt_p``: 60 rows, one of S + 5 edges, E < P; ``e0``: 40 rows and
      no edge; ``empty_out``: no row, 50 edges all dropped.

    The row before a hub that must start at a given place takes the
    filler edges (fewer than P, so it stays short or medium)."""
    if case not in SPMM_CASES:
        raise ValueError(f"unknown case {case!r}; have {SPMM_CASES}")
    p, h, _ = tile_plan(0, dim)
    rng = np.random.default_rng(SPMM_CASES.index(case) * 1000 + dim)
    num_out = {"e_lt_p": 60, "e0": 40, "empty_out": 0}.get(case, _ROWS)
    deg = rng.integers(0, 4, num_out)
    lead = trail = 0

    def place(row: int, size: int, at: int | None = None) -> None:
        """Row ``row`` gets ``size`` edges; with ``at``, its first edge
        lies ``at`` past a tile start."""
        deg[row] = size
        if at is not None:
            need = (at - lead - int(deg[:row].sum())) % p
            deg[row - 1] += need

    if case == "medium_h":
        place(_HUB, h, p // 2 + 1)
    elif case == "hub_h1":
        place(_HUB, h + 1, p // 2 + 1)
    elif case in ("hub_kp_minus", "hub_kp", "hub_kp_plus"):
        place(_HUB, 5 * p + ("hub_kp_minus", "hub_kp",
                             "hub_kp_plus").index(case) - 1, 0)
    elif case == "hub_on_start":
        place(_HUB, 3 * p + 17, 0)
    elif case == "hub_mid_tile":
        place(_HUB, 3 * p + 17, p // 2 + 3)
    elif case == "hub_many_tiles":
        place(_HUB, 40 * p + 3, p // 4)
    elif case == "adjacent_hubs":
        place(_HUB, 2 * p + 100, p // 3)
        place(_HUB + 1, 3 * p + 7)
    elif case == "hub_first_row":
        place(0, 3 * p + 5)
    elif case == "hub_last_row":
        start = int(deg[:-1].sum())
        place(num_out - 1, h + 1 + (1 - (start + h + 1)) % p)
    elif case == "dropped":
        lead, trail = 2 * p + 11, 3 * p + 5
        place(0, 2 * p + 50)
        place(300, 3 * p)
    elif case == "padded_hub":
        place(_HUB, 3 * p + 3)
    elif case == "medium_s1":
        place(9, SHORT_ROW + 1)
    elif case == "all_medium":
        deg[250:530] = rng.integers(SHORT_ROW + 1, 3 * SHORT_ROW + 1, 280)
    elif case == "e_lt_p":
        place(7, SHORT_ROW + 5)
    elif case == "e0":
        deg[:] = 0
    elif case == "empty_out":
        trail = 50

    rows = np.repeat(np.arange(num_out, dtype=np.int32), deg)
    dst = np.concatenate([
        rng.integers(-9, 0, lead), rows,
        rng.integers(num_out, num_out + 10, trail)]).astype(np.int32)
    e = dst.shape[0]
    src = rng.integers(0, _NODES, e).astype(np.int32)
    src[rng.random(e) < 1 / 9] = _NODES
    if case == "padded_hub":
        src[dst == _HUB] = _NODES
    w = rng.standard_normal(e).astype(np.float32)
    order = rng.permutation(e)
    x = rng.standard_normal((_NODES, dim)).astype(np.float32)
    return x, src[order], dst[order], w[order], num_out
