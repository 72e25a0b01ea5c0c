"""Launcher of the CUDA bottom-up pull step (``csrc/frontier_pull.cu``),
the port of the Pallas ``pull_contrib_pallas`` kernel fused with the
gathers and the segment-OR its wrapper runs around it."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_INT32_MAX = 2 ** 31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontier_pull")
    lib.frontier_pull_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
    lib.frontier_pull_launch.restype = ctypes.c_int
    lib.frontier_pull_error_string.argtypes = [ctypes.c_int]
    lib.frontier_pull_error_string.restype = ctypes.c_char_p
    return lib


def frontier_pull_cuda(perm: torch.Tensor, join_src: torch.Tensor,
                       join_dst: torch.Tensor, frontier: torch.Tensor,
                       visited: torch.Tensor) -> torch.Tensor:
    """(E,) int32 reverse-CSR ``perm`` and join columns, (V,) uint8
    frontier / visited bitmaps, all on one CUDA device -> (V,) uint8 next
    frontier: 1 at every unvisited vertex with an in-neighbor in the
    frontier.  ``perm`` must be non-empty.  Launches on the current stream
    and does not synchronize."""
    device = perm.device
    arrays = {"perm": (perm, torch.int32), "join_src": (join_src, torch.int32),
              "join_dst": (join_dst, torch.int32),
              "frontier": (frontier, torch.uint8),
              "visited": (visited, torch.uint8)}
    for name, (a, dtype) in arrays.items():
        if a.device.type != "cuda" or a.device != device:
            raise ValueError(f"frontier_pull_cuda needs every input on one "
                             f"CUDA device; {name} is on {a.device}")
        if a.dtype != dtype or a.dim() != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor, got {a.dtype} {tuple(a.shape)}")
    e, nv = perm.shape[0], frontier.shape[0]
    if not (join_src.shape[0] == join_dst.shape[0] == e > 0):
        raise ValueError("perm, join_src and join_dst must share one "
                         f"non-zero length, got {e}, {join_src.shape[0]}, "
                         f"{join_dst.shape[0]}")
    if visited.shape[0] != nv or not 0 < nv <= _INT32_MAX or e > _INT32_MAX:
        raise ValueError(f"frontier and visited must share one length in "
                         f"[1, 2^31), got {nv} and {visited.shape[0]}")
    out = torch.empty((nv,), dtype=torch.uint8, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.frontier_pull_launch(
            perm.data_ptr(), join_src.data_ptr(), join_dst.data_ptr(),
            frontier.data_ptr(), visited.data_ptr(), out.data_ptr(), e, nv,
            stream)
    if err:
        raise RuntimeError("frontier_pull launch failed: "
                           f"{lib.frontier_pull_error_string(err).decode()}")
    return out
