"""Launcher of the CUDA frontier expansion (``csrc/frontier_expand.cu``),
the port of the Pallas ``expand_index_pallas`` kernel together with its
wrapper's degrees, cumsum and range starts and its phase-B ``perm`` gather:
three kernels issued by one C call."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

SCAN_TILE = 2048                  # kTile of the .cu: targets a scan block
_LIMIT = 2 ** 31                  # F, V, E and capacity are int32 counts


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontier_expand")
    lib.frontier_expand_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 4 + [ctypes.c_void_p])
    lib.frontier_expand_launch.restype = ctypes.c_int
    lib.frontier_expand_error_string.argtypes = [ctypes.c_int]
    lib.frontier_expand_error_string.restype = ctypes.c_char_p
    return lib


def frontier_expand_cuda(indptr: torch.Tensor, perm: torch.Tensor,
                         targets: torch.Tensor, valid: torch.Tensor,
                         capacity: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(V+1,) int32 ``indptr``, (E,) int32 ``perm``, (F,) int32 targets
    and (F,) bool ``valid``, all on one CUDA device -> (capacity,) int32
    edge positions in frontier order with the sentinel ``E`` from the
    level's total on, ``min(total, capacity)`` as a 0-d int32 and
    ``total > capacity`` as a 0-d bool.  Three launches on the current
    stream (one at F = 0), no synchronize, no torch op."""
    arrays = {"indptr": indptr, "perm": perm, "targets": targets,
              "valid": valid}
    device = targets.device
    for name, a in arrays.items():
        if a.device.type != "cuda" or a.device != device:
            raise ValueError(f"frontier_expand_cuda needs every input on "
                             f"one CUDA device; {name} is on {a.device}")
        want = torch.bool if name == "valid" else torch.int32
        if a.dtype != want:
            raise TypeError(f"{name} must be {want}, got {a.dtype}")
        if a.dim() != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                             f"shape {tuple(a.shape)}")
    f, e, v = targets.shape[0], perm.shape[0], indptr.shape[0] - 1
    if valid.shape[0] != f:
        raise ValueError(f"valid has {valid.shape[0]} entries for {f} "
                         "targets")
    if v < 0:
        raise ValueError("indptr must hold at least one entry")
    for name, n in (("F", f), ("V", v), ("E", e), ("capacity", capacity)):
        if not 0 <= n < _LIMIT:
            raise ValueError(f"{name} must be in [0, 2^31), got {n}")

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    block_sums, ends = empty(-(-f // SCAN_TILE)), empty(f)
    out, count, overflow = empty(capacity), empty(), empty(dtype=torch.bool)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.frontier_expand_launch(
            indptr.data_ptr(), perm.data_ptr(), targets.data_ptr(),
            valid.data_ptr(), block_sums.data_ptr(), ends.data_ptr(),
            out.data_ptr(), count.data_ptr(), overflow.data_ptr(), f, v, e,
            capacity, stream)
    if err:
        raise RuntimeError("frontier_expand launch failed: "
                           f"{lib.frontier_expand_error_string(err).decode()}")
    return out, count, overflow
