"""Launcher of the CUDA positional row gather (``csrc/late_gather.cu``),
the port of the Pallas ``late_gather_pallas`` kernel and of the fusion in
its ``ops.materialize``: one launch gathers up to ``MAX_COLUMNS`` columns."""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .. import _build

# element types the kernel copies as bit patterns
DTYPES = (torch.float32, torch.int32, torch.bfloat16)
MAX_COLUMNS = 32                  # column descriptors of one launch
MAX_ROW_BYTES = 2 ** 24


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("late_gather")
    lib.late_gather_launch.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.late_gather_launch.restype = ctypes.c_int
    lib.late_gather_error_string.argtypes = [ctypes.c_int]
    lib.late_gather_error_string.restype = ctypes.c_char_p
    return lib


def late_gather_cuda(tables: Sequence[torch.Tensor], positions: torch.Tensor
                     ) -> list[torch.Tensor]:
    """Up to MAX_COLUMNS (R, W_c) tables of one R and (P,) int32
    positions, all on one CUDA device -> the (P, W_c) rows of each table,
    in one launch on the current stream, without a synchronize: row p for
    0 <= p < R, row p + R for -R <= p < 0, a zero row otherwise.  No launch
    when every output is empty."""
    if len(tables) > MAX_COLUMNS:
        raise ValueError(f"one launch gathers at most {MAX_COLUMNS} "
                         f"columns, got {len(tables)}")
    if positions.device.type != "cuda" or \
            any(t.device != positions.device for t in tables):
        raise ValueError("late_gather_cuda needs tables and positions on "
                         "one CUDA device, got "
                         f"{[str(t.device) for t in tables]} and "
                         f"{positions.device}")
    if positions.dtype != torch.int32:
        raise TypeError(f"positions must be int32, got {positions.dtype}")
    if positions.dim() != 1 or not positions.is_contiguous():
        raise ValueError("positions must be a contiguous (P,) tensor, got "
                         f"shape {tuple(positions.shape)}")
    rows = tables[0].shape[0] if tables else 0
    for t in tables:
        if t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"expected (R, W) tables of one R = {rows}, got "
                             f"{[tuple(t.shape) for t in tables]}")
        if t.dtype not in DTYPES:
            raise TypeError(f"late_gather_cuda copies {DTYPES}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("late_gather_cuda needs contiguous tables")
        if t.shape[1] * t.element_size() >= MAX_ROW_BYTES:
            raise ValueError(f"a row of {t.shape[1]} x {t.element_size()} "
                             f"bytes reaches {MAX_ROW_BYTES}")
    p = positions.shape[0]
    outs = [torch.empty((p, t.shape[1]), dtype=t.dtype, device=t.device)
            for t in tables]
    live = [(t, o) for t, o in zip(tables, outs) if o.numel()]
    if not live:
        return outs
    desc = (ctypes.c_int64 * (3 * len(live)))(*(
        v for t, o in live
        for v in (t.data_ptr(), o.data_ptr(), t.shape[1] * t.element_size())))
    lib = _lib()
    with torch.cuda.device(positions.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.late_gather_launch(desc, len(live), positions.data_ptr(),
                                     p, rows, stream)
    if err:
        raise RuntimeError("late_gather launch failed: "
                           f"{lib.late_gather_error_string(err).decode()}")
    return outs
