"""Launcher of the CUDA segment SpMM (``csrc/spmm_segment.cu``), the port
of the Pallas ``spmm_segment_pallas`` kernel together with its wrapper's
zero-fill of rows that have no edge."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_INT32_MAX = 2 ** 31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spmm_segment")
    lib.spmm_segment_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
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
    (num_out, D) float32.  Launches on the current stream and does not
    synchronize; no launch when the output is empty."""
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
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_segment_launch(
            x.data_ptr(), src.data_ptr(), weights.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), num_out, n, d, stream)
    if err:
        raise RuntimeError("spmm_segment launch failed: "
                           f"{lib.spmm_segment_error_string(err).decode()}")
    return out
