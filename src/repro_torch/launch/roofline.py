"""Roofline terms of a counted step on one NVIDIA H100.

The reference's ``src/repro/launch/roofline.py`` reads XLA's compiled
artifact against TPU v5e constants.  The port reads a
:class:`launch.count.Count` (the eager op stream of one step) against the
card's published peaks:

    compute    = sum over dtypes of FLOPs[dtype] / (chips * peak[dtype])
    memory     = bytes / (chips * 3.35e12 B/s HBM)
    collective = coll_bytes / (chips * 900e9 B/s NVLink)

A row carries two byte counts, kept apart: ``hbm_bytes``, the eager
traffic (every op's inputs and outputs), and ``compulsory_bytes``, the
step's arguments read once and outputs written once.  ``memory_basis``
says which of them ``memory_s`` uses; the roofline share of a measured
time uses the compulsory one.

The reference's ``parse_collectives`` reads XLA's HLO text; one card has
no collective to parse, so ``collective_bytes`` is 0 and ``chips`` 1
until the counter counts ``torch.distributed`` collectives (ROADMAP item
11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["PEAKS_SOURCE", "PEAK_FLOPS_BY_DTYPE", "HBM_BW",
           "NVLINK_BW", "FP32_FLOPS", "Roofline", "analyze",
           "lm_model_flops"]

# NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column, dense rates
# (the sheet's tensor-core figures halved: it prints them with
# sparsity); the rates assume the part's 700 W power limit
PEAKS_SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, H100 SXM, dense "
                "rates, at the 700 W power limit")
PEAK_FLOPS_BY_DTYPE = {
    "bfloat16": 989e12,        # BF16 Tensor Core
    "float16": 989e12,         # FP16 Tensor Core
    "tf32": 495e12,            # TF32 Tensor Core
    "float32": 67e12,          # FP32, off the tensor cores
    "float64": 67e12,          # FP64 Tensor Core
}
FP32_FLOPS = PEAK_FLOPS_BY_DTYPE["float32"]
HBM_BW = 3.35e12               # bytes/s, HBM3
NVLINK_BW = 900e9              # bytes/s per card, NVLink 4


@dataclasses.dataclass
class Roofline:
    """The terms of one step.  ``flops_by_dtype`` (``None``: all of
    ``flops`` in bf16) splits the compute term by each dtype's peak;
    ``memory_s`` reads ``hbm_bytes`` or, with ``memory_basis =
    "compulsory"``, ``compulsory_bytes``."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    flops_by_dtype: Optional[dict] = None
    compulsory_bytes: Optional[float] = None
    memory_basis: str = "hbm"

    def __post_init__(self):
        if self.memory_basis not in ("hbm", "compulsory"):
            raise ValueError(f"memory_basis is 'hbm' or 'compulsory', got "
                             f"{self.memory_basis!r}")
        if self.memory_basis == "compulsory" and \
                self.compulsory_bytes is None:
            raise ValueError("memory_basis 'compulsory' needs "
                             "compulsory_bytes")
        unknown = set(self.flops_by_dtype or ()) - set(PEAK_FLOPS_BY_DTYPE)
        if unknown:
            raise ValueError(f"no peak for {sorted(unknown)}; have "
                             f"{sorted(PEAK_FLOPS_BY_DTYPE)}")

    @property
    def compute_s(self) -> float:
        by = self.flops_by_dtype or {"bfloat16": self.flops}
        return sum(f / PEAK_FLOPS_BY_DTYPE[dt] for dt, f in by.items()) \
            / self.chips

    @property
    def memory_bytes(self) -> float:
        return self.compulsory_bytes if self.memory_basis == "compulsory" \
            else self.hbm_bytes

    @property
    def memory_s(self) -> float:
        return self.memory_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def fraction_of_roofline(self) -> float:
        """Useful-compute fraction if perfectly overlapped: compute term
        over the max term (1.0 = compute-bound at peak)."""
        return self.compute_s / max(self.bound_s, 1e-30)

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "memory_basis": self.memory_basis,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "bound_s": self.bound_s,
            "roofline_frac": self.fraction_of_roofline(),
        }


def analyze(count, chips: int = 1, *, model_flops: float | None = None,
            memory_basis: str = "hbm") -> dict:
    """A :class:`launch.count.Count` -> the reference's row: ``flops``,
    ``hbm_bytes``, ``collective_bytes`` and the terms, with
    ``flops_by_dtype``, ``compulsory_bytes``, the argument and output
    sizes (``memory_analysis``'s counterparts) and, given
    ``model_flops``, ``useful_flops_ratio``."""
    if chips != 1:
        raise NotImplementedError("the port counts one card; a mesh waits "
                                  "for ROADMAP item 11")
    rf = Roofline(flops=count.flops, hbm_bytes=count.hbm_bytes,
                  collective_bytes=0.0, chips=chips,
                  flops_by_dtype=count.flops_by_dtype,
                  compulsory_bytes=count.compulsory_bytes,
                  memory_basis=memory_basis)
    out = {**count.row(), "collective_bytes": 0.0, **rf.row(),
           "compulsory_memory_s": count.compulsory_bytes / (chips * HBM_BW),
           "memory_analysis": {
               "argument_size_in_bytes": count.argument_bytes,
               "output_size_in_bytes": count.output_bytes}}
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = model_flops / max(count.flops, 1.0)
    return out


def lm_model_flops(cfg, batch: int, seq: int, *, train: bool) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference)."""
    n = cfg.active_param_count()
    mult = 6.0 if train else 2.0
    return mult * n * batch * seq
