"""Launcher of the CUDA EmbeddingBag (``csrc/embedding_bag.cu``), the port
of the Pallas ``embedding_bag_pallas`` kernel together with its wrapper's
empty-bag padding and ``mean`` division.

:func:`bag_layout` is the host side of the kernel's layout: the vector
width, the lanes across a row, the bags a warp and the entries whose rows
a lane group loads at once, chosen per call from D and the table's
alignment."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .. import _build

_INT32_MAX = 2 ** 31 - 1
MAX_CHUNKS = 4      # kMaxChunks of the .cu: a warp covers 128 units of a
#                     row at most; a wider row is cut into slices


class BagLayout(NamedTuple):
    vec: int        # floats a lane loads at once: 4, 2 or 1
    lanes: int      # lanes across a row, or a slice of it
    bags_per_warp: int
    chunks: int     # accumulators a lane: units lane, lane + 32, ...
    slices: int     # warps across one bag's row (each walks the bag)
    batch: int      # K: entries whose rows a group loads before adding


def bag_layout(dim: int, table_ptr: int) -> BagLayout:
    """The kernel's layout for rows of ``dim`` float32 at address
    ``table_ptr``: float4 where D % 4 == 0 and the table is 16-byte
    aligned, float2 where D % 2 == 0 and it is 8-byte aligned, else
    float; U = D / vec units a row.  U <= 32: U lanes, floor(32 / U) bags
    a warp.  Up to 128 units: 32 lanes with ceil(U / 32) accumulators
    each.  Wider: slices of 128 units, a warp each.  K = 8 with one
    accumulator a lane, else 4."""
    if dim % 4 == 0 and table_ptr % 16 == 0:
        vec = 4
    elif dim % 2 == 0 and table_ptr % 8 == 0:
        vec = 2
    else:
        vec = 1
    units = dim // vec
    if units <= 32:
        lanes, chunks, slices = max(units, 1), 1, 1
    elif units <= 32 * MAX_CHUNKS:
        lanes, chunks, slices = 32, -(-units // 32), 1
    else:
        lanes, chunks = 32, MAX_CHUNKS
        slices = -(-units // (32 * MAX_CHUNKS))
    return BagLayout(vec, lanes, 32 // lanes, chunks, slices,
                     8 if chunks == 1 else 4)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    lib.embedding_bag_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 7
        + [ctypes.c_void_p])
    lib.embedding_bag_launch.restype = ctypes.c_int
    lib.embedding_bag_error_string.argtypes = [ctypes.c_int]
    lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       weights: Optional[torch.Tensor],
                       offsets: torch.Tensor, *, mean: bool = False
                       ) -> torch.Tensor:
    """(R, D) float32 ``table``; bag-sorted (I,) int32 ``indices`` and
    float32 ``weights`` (None: all ones); (num_bags + 1,) int32 ``offsets``
    (bag b sums the entries ``offsets[b]:offsets[b + 1]``), all on one CUDA
    device -> (num_bags, D) float32; ``mean`` divides each bag by its count
    of indices < R, at least 1.  Launches one kernel, laid out by
    :func:`bag_layout`, on the current stream and does not synchronize; no
    launch when the output is empty."""
    device = table.device
    arrays = {"table": (table, torch.float32, 2),
              "indices": (indices, torch.int32, 1),
              "offsets": (offsets, torch.int32, 1)}
    if weights is not None:
        arrays["weights"] = (weights, torch.float32, 1)
    for name, (a, dtype, ndim) in arrays.items():
        if a.device.type != "cuda" or a.device != device:
            raise ValueError(f"embedding_bag_cuda needs every input on one "
                             f"CUDA device; {name} is on {a.device}")
        if a.dtype != dtype or a.dim() != ndim or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                             f"tensor, got {a.dtype} {tuple(a.shape)}")
    (r, d), n = table.shape, indices.shape[0]
    num_bags = offsets.shape[0] - 1
    if num_bags < 0 or (weights is not None and weights.shape[0] != n):
        raise ValueError(f"offsets must be non-empty and weights as long as "
                         f"indices, got {offsets.shape[0]} offsets, {n} "
                         f"indices and "
                         f"{None if weights is None else weights.shape[0]} "
                         f"weights")
    if max(r, n, d) > _INT32_MAX:
        raise ValueError(f"embedding_bag_cuda takes R, I and D below 2^31, "
                         f"got {r}, {n} and {d}")
    out = torch.empty((num_bags, d), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    layout = bag_layout(d, table.data_ptr())
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.embedding_bag_launch(
            table.data_ptr(), indices.data_ptr(),
            None if weights is None else weights.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), num_bags, r, d, layout.vec,
            layout.lanes, layout.bags_per_warp, layout.chunks, layout.slices,
            layout.batch, int(mean), stream)
    if err:
        raise RuntimeError("embedding_bag launch failed: "
                           f"{lib.embedding_bag_error_string(err).decode()}")
    return out
