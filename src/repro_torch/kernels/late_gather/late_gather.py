"""Launcher of the CUDA positional row gather (``csrc/late_gather.cu``),
the port of the Pallas ``late_gather_pallas`` kernel."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

# element types the kernel copies as 2- or 4-byte bit patterns
DTYPES = (torch.float32, torch.int32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("late_gather")
    lib.late_gather_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.late_gather_launch.restype = ctypes.c_int
    lib.late_gather_error_string.argtypes = [ctypes.c_int]
    lib.late_gather_error_string.restype = ctypes.c_char_p
    return lib


def late_gather_cuda(table: torch.Tensor, positions: torch.Tensor
                     ) -> torch.Tensor:
    """(R, W) table, (P,) int32 positions, both on one CUDA device ->
    (P, W) rows, zero where a position is not a row.  Launches on the
    current stream and does not synchronize.  No launch when the output is
    empty."""
    if table.device.type != "cuda" or positions.device != table.device:
        raise ValueError("late_gather_cuda needs table and positions on one "
                         f"CUDA device, got {table.device} and "
                         f"{positions.device}")
    if table.dim() != 2 or positions.dim() != 1:
        raise ValueError(f"expected a (R, W) table and (P,) positions, got "
                         f"{tuple(table.shape)} and {tuple(positions.shape)}")
    if table.dtype not in DTYPES:
        raise TypeError(f"late_gather_cuda copies {DTYPES}, got {table.dtype}")
    if positions.dtype != torch.int32:
        raise TypeError(f"positions must be int32, got {positions.dtype}")
    if not (table.is_contiguous() and positions.is_contiguous()):
        raise ValueError("late_gather_cuda needs contiguous inputs")
    p, w = positions.shape[0], table.shape[1]
    if p * w > _INT32_MAX:
        raise ValueError(f"output of {p} x {w} elements exceeds 2^31 - 1")
    out = torch.empty((p, w), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.late_gather_launch(
            table.data_ptr(), positions.data_ptr(), out.data_ptr(),
            table.shape[0], w, p, table.element_size(), stream)
    if err:
        raise RuntimeError("late_gather launch failed: "
                           f"{lib.late_gather_error_string(err).decode()}")
    return out
