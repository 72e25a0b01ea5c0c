"""Columnar tables — the storage layer of the position-enabled engine.

A ``ColumnTable`` is the port's PosDB table: a dict of equal-length tensors
on one device, one per column.  Positions (row ids) index into every
column.  The row-store emulation (``RowTable``) comes with the slice that
ports the row-store engines.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..kernels.late_gather.ops import late_gather_columns

__all__ = ["ColumnTable", "payload_names"]


def payload_names(n: int) -> list[str]:
    """Column names for the paper's N auxiliary payload columns."""
    return [f"column{i + 1}" for i in range(n)]


@dataclasses.dataclass(frozen=True)
class ColumnTable:
    """A columnar table: name -> (num_rows,) or (num_rows, k) tensor.

    All columns share the leading dimension and the device.  Gathers go
    through :meth:`take`: a position in [-R, 0) counts from the end once,
    and one that is not a row (the padding sentinel ``num_rows``, or one
    below -R) gathers a zero row."""

    columns: Dict[str, torch.Tensor]

    @classmethod
    def from_numpy(cls, cols: Mapping[str, np.ndarray], device
                   ) -> "ColumnTable":
        """Copy numpy columns onto ``device``, keeping each column's dtype."""
        return cls({k: torch.tensor(np.asarray(v), device=device)
                    for k, v in cols.items()})

    def to(self, device) -> "ColumnTable":
        return ColumnTable({k: v.to(device) for k, v in self.columns.items()})

    @property
    def num_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self.columns))

    def column(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def take(self, positions: torch.Tensor, names: Sequence[str] | None = None
             ) -> Dict[str, torch.Tensor]:
        """Gather ``positions`` (int32) from the requested columns.

        All of them go through one ``late_gather_columns`` call, each in
        its own dtype (a 1-D column as an (R, 1) table): on the card one
        kernel launch per 32 columns.  A position in [-R, 0) counts from
        the end once; one >= R (the padding sentinel) or below -R gives
        zeros.  An empty table (R = 0) raises IndexError unless there is
        no position.  Positions of any shape (a batch's (L, R)) go
        through the one call flattened."""
        names = self.names if names is None else tuple(names)
        cols = [self.columns[name] for name in names]
        rows = late_gather_columns(
            [col.reshape(col.shape[0], math.prod(col.shape[1:]))
             for col in cols], positions.reshape(-1))
        return {name: r.reshape(positions.shape + col.shape[1:])
                for name, col, r in zip(names, cols, rows)}
