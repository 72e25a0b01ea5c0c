"""Launcher of the CUDA segment SpMM (``csrc/spmm_segment.cu``), the port
of the Pallas ``spmm_segment_pallas`` kernel together with its wrapper's
zero-fill of rows that have no edge: two kernels (rows with the hub
tiles, hub fixup) issued by one C call.

:func:`tile_plan` is the host side of the kernels' split of long rows: the
tile of ``P`` edges and the hub threshold ``H`` for a row width ``D``, and
the number of tile starts, which sizes the scratch."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

_INT32_MAX = 2 ** 31 - 1
SHORT_ROW = 32      # kShortRow of the .cu: rows of at most S edges are
#                     summed in sorted order, as the plain version sums them


class TilePlan(NamedTuple):
    tile_edges: int   # P, a power of two: tile starts are the sorted edge
    #                   ids k * P
    hub_edges: int    # H = 2P: a row of more than H edges is a hub
    num_tiles: int    # ceil(E / P) when E > H, else 0 (no row is a hub)


def tile_plan(num_edges: int, dim: int) -> TilePlan:
    """P = max(256, 4096 / L) with L = min(32, the least power of two >= D)
    threads across a row's columns, so that a thread adds at most 64 edges
    of a tile or a medium row one after another."""
    lanes = 1
    while lanes < min(dim, 32):
        lanes *= 2
    p = max(256, 4096 // lanes)
    h = 2 * p
    return TilePlan(p, h, -(-num_edges // p) if num_edges > h else 0)


def tile_scratch(num_edges: int, dim: int, device
                 ) -> tuple[TilePlan, torch.Tensor]:
    """The plan, and the kernels' scratch from one ``torch.empty`` (no
    launch): T * (D + 1) float32 words, the partial sums (T, D) and then
    ``tile_row`` (T,) int32."""
    plan = tile_plan(num_edges, dim)
    return plan, torch.empty((plan.num_tiles * (dim + 1),),
                             dtype=torch.float32, device=device)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_segment")
    lib.spmm_segment_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7 + [ctypes.c_void_p])
    lib.spmm_segment_launch.restype = ctypes.c_int
    lib.spmm_segment_error_string.argtypes = [ctypes.c_int]
    lib.spmm_segment_error_string.restype = ctypes.c_char_p
    return lib


def spmm_segment_cuda(x: torch.Tensor, src: torch.Tensor,
                      weights: torch.Tensor, offsets: torch.Tensor
                      ) -> torch.Tensor:
    """(N, D) float32 ``x``; destination-sorted (E,) int32 ``src`` and
    float32 ``weights``; (num_out + 1,) int32 ``offsets`` (row v sums the
    edges ``offsets[v]:offsets[v + 1]``), all on one CUDA device ->
    (num_out, D) float32.  Launches on the current stream (one kernel, or
    two when E > H) and does not synchronize; no launch when the output
    is empty."""
    device = x.device
    arrays = {"x": (x, torch.float32, 2), "src": (src, torch.int32, 1),
              "weights": (weights, torch.float32, 1),
              "offsets": (offsets, torch.int32, 1)}
    for name, (a, dtype, ndim) in arrays.items():
        if a.device.type != "cuda" or a.device != device:
            raise ValueError(f"spmm_segment_cuda needs every input on one "
                             f"CUDA device; {name} is on {a.device}")
        if a.dtype != dtype or a.dim() != ndim or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                             f"tensor, got {a.dtype} {tuple(a.shape)}")
    (n, d), e = x.shape, src.shape[0]
    num_out = offsets.shape[0] - 1
    if weights.shape[0] != e or num_out < 0:
        raise ValueError(f"src and weights must share one length and "
                         f"offsets be non-empty, got {e}, "
                         f"{weights.shape[0]} and {offsets.shape[0]}")
    if max(n, e, d) > _INT32_MAX:
        raise ValueError("spmm_segment_cuda takes N, E and D below 2^31, got "
                         f"{n}, {e} and {d}")
    out = torch.empty((num_out, d), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    plan, scratch = tile_scratch(e, d, device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_segment_launch(
            x.data_ptr(), src.data_ptr(), weights.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), scratch.data_ptr(), num_out,
            n, d, e, *plan, stream)
    if err:
        raise RuntimeError("spmm_segment launch failed: "
                           f"{lib.spmm_segment_error_string(err).decode()}")
    return out
