"""Launcher of the CUDA EmbeddingBag (``csrc/embedding_bag.cu``), the port
of the Pallas ``embedding_bag_pallas`` kernel together with its wrapper's
empty-bag padding and ``mean`` division."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build

_INT32_MAX = 2 ** 31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    lib.embedding_bag_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]
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
    of indices < R, at least 1.  Launches on the current stream and does
    not synchronize; no launch when the output is empty."""
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
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.embedding_bag_launch(
            table.data_ptr(), indices.data_ptr(),
            None if weights is None else weights.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), num_bags, r, d, int(mean),
            stream)
    if err:
        raise RuntimeError("embedding_bag launch failed: "
                           f"{lib.embedding_bag_error_string(err).decode()}")
    return out
