"""Launcher of the CUDA frontier expansion (``csrc/frontier_expand.cu``),
the port of the Pallas ``expand_index_pallas`` kernel fused with its
phase-B ``perm`` gather."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontier_expand")
    lib.frontier_expand_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
    lib.frontier_expand_launch.restype = ctypes.c_int
    lib.frontier_expand_error_string.argtypes = [ctypes.c_int]
    lib.frontier_expand_error_string.restype = ctypes.c_char_p
    return lib


def expand_index_cuda(ends: torch.Tensor, estart: torch.Tensor,
                      deg: torch.Tensor, perm: torch.Tensor, capacity: int
                      ) -> torch.Tensor:
    """(F,) inclusive degree cumsum / CSR range starts / degrees and the
    (E,) CSR ``perm`` -> (capacity,) int32 edge positions of the level,
    ``E`` (the sentinel) from the level's total on.  The total is read on
    the device from ``ends[F-1]``.  Launches on the current stream and does
    not synchronize."""
    arrays = {"ends": ends, "estart": estart, "deg": deg, "perm": perm}
    device = perm.device
    for name, a in arrays.items():
        if a.device.type != "cuda" or a.device != device:
            raise ValueError(f"expand_index_cuda needs every input on one "
                             f"CUDA device; {name} is on {a.device}")
        if a.dtype != torch.int32 or a.dim() != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {a.dtype} {tuple(a.shape)}")
    f = ends.shape[0]
    if f == 0 or estart.shape[0] != f or deg.shape[0] != f:
        raise ValueError("ends, estart and deg must share one non-zero "
                         f"length, got {f}, {estart.shape[0]}, "
                         f"{deg.shape[0]}")
    if not 0 < capacity < 2 ** 31:
        raise ValueError(f"capacity must be in [1, 2^31), got {capacity}")
    out = torch.empty((capacity,), dtype=torch.int32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.frontier_expand_launch(
            ends.data_ptr(), estart.data_ptr(), deg.data_ptr(),
            perm.data_ptr(), out.data_ptr(), f, capacity, perm.shape[0],
            stream)
    if err:
        raise RuntimeError("frontier_expand launch failed: "
                           f"{lib.frontier_expand_error_string(err).decode()}")
    return out
