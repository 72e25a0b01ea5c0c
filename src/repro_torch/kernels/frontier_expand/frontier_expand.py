"""Launcher of the CUDA frontier expansion (``csrc/frontier_expand.cu``),
the port of the Pallas ``expand_index_pallas`` kernel together with its
wrapper's degrees, cumsum and range starts and its phase-B ``perm`` gather:
three kernels issued by one C call, for one frontier or a batch's lanes."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

SCAN_TILE = 2048                  # kTile of the .cu: targets a scan block
MAX_LANES = 65535                 # gridDim.y's limit: the lanes of one call
_LIMIT = 2 ** 31                  # F, V, E and capacity are int32 counts


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontier_expand")
    lib.frontier_expand_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 5 + [ctypes.c_void_p])
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
    ``total > capacity`` as a 0-d bool.  (L, F) targets and flags, a
    batch's lanes over the one CSR, give (L, capacity) positions and (L,)
    counts and flags, each lane expanded on its own; L above MAX_LANES is
    refused.  Three launches on the current stream for all lanes (one at
    F = 0, none at L = 0), no synchronize, no torch op."""
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
        dims = (1, 2) if name in ("targets", "valid") else (1,)
        if a.dim() not in dims or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor of "
                             f"{' or '.join(map(str, dims))} dimensions, "
                             f"got shape {tuple(a.shape)}")
    if valid.shape != targets.shape:
        raise ValueError(f"valid has shape {tuple(valid.shape)} for "
                         f"targets of shape {tuple(targets.shape)}")
    lead = tuple(targets.shape[:-1])
    lanes = lead[0] if lead else 1
    f, e, v = targets.shape[-1], perm.shape[0], indptr.shape[0] - 1
    if v < 0:
        raise ValueError("indptr must hold at least one entry")
    if lanes > MAX_LANES:
        raise ValueError(f"frontier_expand_cuda takes at most {MAX_LANES} "
                         f"lanes a call (gridDim.y), got {lanes}")
    for name, n in (("F", f), ("V", v), ("E", e), ("capacity", capacity)):
        if not 0 <= n < _LIMIT:
            raise ValueError(f"{name} must be in [0, 2^31), got {n}")

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    block_sums, ends = empty(lanes, -(-f // SCAN_TILE)), empty(lanes, f)
    out, count = empty(*lead, capacity), empty(*lead)
    overflow = empty(*lead, dtype=torch.bool)
    if lanes == 0:
        return out, count, overflow
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.frontier_expand_launch(
            indptr.data_ptr(), perm.data_ptr(), targets.data_ptr(),
            valid.data_ptr(), block_sums.data_ptr(), ends.data_ptr(),
            out.data_ptr(), count.data_ptr(), overflow.data_ptr(), lanes, f,
            v, e, capacity, stream)
    if err:
        raise RuntimeError("frontier_expand launch failed: "
                           f"{lib.frontier_expand_error_string(err).decode()}")
    return out, count, overflow
