"""Launcher of the CUDA bottom-up pull step (``csrc/frontier_pull.cu``),
the port of the Pallas ``pull_contrib_pallas`` kernel fused with the
gathers and the segment-OR its wrapper runs around it: a per-vertex walk
over a :class:`PullLayout`, for one frontier or a batch's lanes."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .layout import HUB_TILE, SHORT_ROW, PullLayout

# the tiles kernel adds HUB_TILE to an entry index in int32
_MAX_ENTRIES = 2 ** 31 - 1 - HUB_TILE
MAX_LANES = 65535                 # gridDim.y's limit: the lanes of one call


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontier_pull")
    lib.frontier_pull_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
    lib.frontier_pull_launch.restype = ctypes.c_int
    lib.frontier_pull_error_string.argtypes = [ctypes.c_int]
    lib.frontier_pull_error_string.restype = ctypes.c_char_p
    return lib


def frontier_pull_cuda(layout: PullLayout, frontier: torch.Tensor,
                       visited: torch.Tensor) -> torch.Tensor:
    """A :class:`PullLayout` and (V,) uint8 frontier / visited bitmaps, all
    on one CUDA device -> (V,) uint8 next frontier: 1 at every unvisited
    vertex with an in-neighbor in the frontier.  (L, V) planes, a batch's
    lanes over the one layout, give the (L, V) next frontiers; L above
    MAX_LANES is refused.  One C call: the rows kernel, then the tiles
    kernel when the layout has hub tiles (1 or 2 device launches for all
    lanes, none at L = 0).  Launches on the current stream and does not
    synchronize."""
    device = frontier.device
    arrays = {"ptr": (layout.ptr, torch.int32, 1),
              "nbr": (layout.nbr, torch.int32, 1),
              "tile_vtx": (layout.tile_vtx, torch.int32, 1),
              "tile_start": (layout.tile_start, torch.int32, 1),
              "frontier": (frontier, torch.uint8, frontier.dim()),
              "visited": (visited, torch.uint8, frontier.dim())}
    for name, (a, dtype, dim) in arrays.items():
        if a.device.type != "cuda" or a.device != device:
            raise ValueError(f"frontier_pull_cuda needs every input on one "
                             f"CUDA device; {name} is on {a.device}")
        if a.dtype != dtype or a.dim() != dim or dim not in (1, 2) or \
                not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of {dim if dim in (1, 2) else '1 or 2'} "
                             f"dimensions, got {a.dtype} {tuple(a.shape)}")
    nv, tiles = frontier.shape[-1], layout.tile_vtx.shape[0]
    lanes = frontier.shape[0] if frontier.dim() == 2 else 1
    if not (visited.shape == frontier.shape
            and layout.num_vertices == nv > 0) or nv >= 2 ** 31:
        raise ValueError(f"frontier, visited and the layout must share one "
                         f"V in [1, 2^31), got {tuple(frontier.shape)}, "
                         f"{tuple(visited.shape)} and {layout.num_vertices}")
    if lanes > MAX_LANES:
        raise ValueError(f"frontier_pull_cuda takes at most {MAX_LANES} "
                         f"lanes a call (gridDim.y), got {lanes}")
    if layout.tile_start.shape[0] != tiles or \
            layout.num_edges > _MAX_ENTRIES:
        raise ValueError(f"malformed layout: {tiles} tile vertices, "
                         f"{layout.tile_start.shape[0]} tile starts, "
                         f"{layout.num_edges} entries")
    out = torch.empty(frontier.shape, dtype=torch.uint8, device=device)
    if lanes == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.frontier_pull_launch(
            layout.ptr.data_ptr(), layout.nbr.data_ptr(),
            layout.tile_vtx.data_ptr(), layout.tile_start.data_ptr(), tiles,
            frontier.data_ptr(), visited.data_ptr(), out.data_ptr(), lanes,
            nv, SHORT_ROW, HUB_TILE, stream)
    if err:
        raise RuntimeError("frontier_pull launch failed: "
                           f"{lib.frontier_pull_error_string(err).decode()}")
    return out
