"""Plain PyTorch version of EmbeddingBag (ragged gather + weighted segment
sum): the correctness oracle of the CUDA kernel, and what runs on CPU
tensors.

:func:`bag_layout_case` makes the seeded inputs that take the card
kernel through every layout of ``bag_layout`` (vector width, lanes, bags
a warp, accumulators, slices) and cut its batches of K entries, shared by
the CPU parity tests, the card tests and ``chip_smoke.py``."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..late_gather.ref import require_rows
from .embedding_bag import bag_layout

COMBINERS = ("sum", "mean")


def check_combiner(combiner: str) -> None:
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got "
                         f"{combiner!r}")


def _bag_sizes(indices: torch.Tensor, segment_ids: torch.Tensor,
              num_bags: int, num_rows: int) -> torch.Tensor:
    """(num_bags,) float32 count of the entries with ``indices < num_rows``
    per bag, at least 1: the divisor of the ``mean`` combiner."""
    slot = torch.where((segment_ids >= 0) & (segment_ids < num_bags),
                       segment_ids, num_bags).long()
    ones = (indices < num_rows).to(torch.float32)
    sizes = ones.new_zeros((num_bags + 1,)).index_add_(0, slot, ones)
    return sizes[:num_bags].clamp(min=1.0)


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      segment_ids: torch.Tensor, num_bags: int,
                      weights: Optional[torch.Tensor] = None,
                      *, combiner: str = "sum") -> torch.Tensor:
    """out[b] = sum_{i: seg[i]=b} w[i] * table[idx[i]], summed in float32.

    table (R, D); indices/segment_ids (I,) int32 in any order; weights
    (I,) or None (all ones).  An index >= R is padding and contributes
    zero; a negative index in [-R, 0) counts from the end once (row
    R + idx), as a JAX index does; one below -R contributes zero.  A
    segment id outside [0, num_bags) is dropped; a bag with no entry is
    zero.  ``combiner="mean"`` divides each bag by its count of indices
    < R, at least 1.  An empty table (R = 0) raises IndexError unless
    I = 0, as the reference's ``jnp.take`` does."""
    check_combiner(combiner)
    r, d = table.shape
    require_rows(r, indices.shape[0])
    idx = indices.long()
    idx = torch.where(idx < 0, idx + r, idx)
    live = (idx >= 0) & (idx < r)
    rows = table.index_select(0, idx.clamp(0, r - 1)).to(torch.float32)
    rows = torch.where(live[:, None], rows, 0.0)
    if weights is not None:
        rows = rows * weights.to(torch.float32)[:, None]
    slot = torch.where((segment_ids >= 0) & (segment_ids < num_bags),
                       segment_ids, num_bags).long()
    out = rows.new_zeros((num_bags + 1, d)).index_add_(0, slot, rows)
    out = out[:num_bags]
    if combiner == "mean":
        out = out / _bag_sizes(indices, segment_ids, num_bags, r)[:, None]
    return out.to(table.dtype)


def bag_cases(case: str):
    """Seeded inputs of the kernel's card checks, on the host: (smoke)
    R = 40, D = 10, 70 indices into 9 bags; (b) R = 2^16, D = 16, 2^14
    indices into 2,048 bags (benchmarks/kernels_bench.py's shape); (c)
    R = 2^16, D = 128, 2^18 indices into 8,192 bags.  Weighted, unsorted;
    indices in [-R, 17R/16) (some negative, some padding), segment ids in
    [-8, B + 8) with bags 1000-1015 left empty (smoke: [-1, B + 1), bag 4
    empty).  Returns [table, indices, segment_ids, weights, num_bags]."""
    r, d, n, b = {"smoke": (40, 10, 70, 9), "b": (1 << 16, 16, 1 << 14, 2048),
                  "c": (1 << 16, 128, 1 << 18, 8192)}[case]
    rng = np.random.default_rng(("smoke", "b", "c").index(case) + 20)
    tab = rng.standard_normal((r, d), dtype=np.float32)
    idx = rng.integers(-r, r + r // 16, n).astype(np.int32)
    pad = 1 if case == "smoke" else 8
    seg = rng.integers(-pad, b + pad, n).astype(np.int32)
    empty = (4, 5) if case == "smoke" else (1000, 1016)
    seg = np.where((seg >= empty[0]) & (seg < empty[1]), empty[1], seg)
    w = rng.uniform(-1.0, 2.0, n).astype(np.float32)
    return [torch.from_numpy(a) for a in (tab, idx, seg, w)] + [b]


# The cases of :func:`bag_layout_case`: "d<D>" a table of width D, its
# base aligned as torch allocates it; "_offset" the same table as a
# contiguous view one float past an aligned base, where only scalar loads
# are legal.  D = 516 lies above the column-split cap (128 units).
BAG_LAYOUT_CASES = ("d1", "d2", "d3", "d4", "d10", "d16", "d17", "d32",
                    "d33", "d128", "d130", "d200", "d300", "d516",
                    "d16_offset", "d200_offset")
_LAYOUT_ROWS, _LAYOUT_BAGS, _HUB_ENTRIES = 64, 48, 3000


def bag_layout_case(case: str, clean: bool = False):
    """Seeded host inputs of one call: (table (R, D) float32, indices (I,)
    int32, segment_ids (I,) int32, weights (I,) float32, num_bags, offset),
    numpy arrays, the entries in random order; ``offset`` says to place
    the table at a storage offset (:func:`layout_table`).  R = 64 rows,
    48 bags, with K the kernel's batch at this layout: bags 0 and 47
    empty; bags 1-6 of 1, K - 1, K, K + 1, 39 and 3,000 entries; the rest
    of 0 to 2K.  Indices in [-R - 4, R + 4): some wrap, some are padding
    (>= R), some lie below -R; 20 more entries have segment ids outside
    [0, 48) and are dropped.  ``clean`` keeps indices in [0, R + 4) and
    drops no entry: the Pallas kernel's contract."""
    if case not in BAG_LAYOUT_CASES:
        raise ValueError(f"unknown case {case!r}; have {BAG_LAYOUT_CASES}")
    d = int(case[1:].split("_")[0])
    offset = case.endswith("_offset")
    k = bag_layout(d, 4 if offset else 0).batch
    rng = np.random.default_rng(BAG_LAYOUT_CASES.index(case) * 10 + clean)
    r, b = _LAYOUT_ROWS, _LAYOUT_BAGS
    sizes = rng.integers(0, 2 * k + 1, b)
    sizes[[0, b - 1]] = 0
    sizes[1:7] = (1, k - 1, k, k + 1, 39, _HUB_ENTRIES)
    seg = np.repeat(np.arange(b), sizes)
    if not clean:
        dropped = rng.integers(b, b + 4, 20)
        dropped[::2] -= b + 4                 # half below 0
        seg = np.concatenate([seg, dropped])
    n = seg.shape[0]
    idx = rng.integers(0 if clean else -r - 4, r + 4, n)
    order = rng.permutation(n)
    tab = rng.standard_normal((r, d), dtype=np.float32)
    w = rng.uniform(-1.0, 2.0, n).astype(np.float32)
    return (tab, idx[order].astype(np.int32), seg[order].astype(np.int32),
            w[order], b, offset)


def layout_table(tab: np.ndarray, offset: bool, device="cpu"
                 ) -> torch.Tensor:
    """``tab`` on ``device``; with ``offset``, as a contiguous view one
    float past the base of its storage."""
    t = torch.from_numpy(tab).to(device)
    if not offset:
        return t
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    return flat[1:].view(t.shape).copy_(t)
