"""Columnar tables — the storage layer of the position-enabled engine.

A ``ColumnTable`` is the port's PosDB table: a dict of equal-length tensors
on one device, one per column.  Positions (row ids) index into every
column.

``RowTable`` is the row-store emulation used as the PostgreSQL baseline:
all columns are interleaved into a single row-major ``(rows, width)``
float32 tensor, so that touching *any* attribute of a row drags the full
row through the memory system — the cost asymmetry the paper exploits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..kernels.late_gather.ops import late_gather_columns

__all__ = ["ColumnTable", "RowTable", "payload_names"]


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

    def select(self, names: Sequence[str]) -> "ColumnTable":
        return ColumnTable({n: self.columns[n] for n in names})

    def width_bytes(self, names: Sequence[str] | None = None) -> int:
        """Bytes of one row over ``names`` (all columns by default), each
        column at its own dtype's width (the planner's column widths)."""
        names = self.names if names is None else tuple(names)
        return sum(math.prod(self.columns[n].shape[1:])
                   * self.columns[n].element_size() for n in names)

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


@dataclasses.dataclass(frozen=True)
class RowTable:
    """Row-store emulation: one interleaved row-major ``(rows, width)``
    float32 tensor, contiguous, and the column name of each slot.

    Every column is stored as float32 in the slot order of the column
    table's sorted names; an (R, k) column becomes the slots ``name.0`` …
    ``name.k-1``.  So int ids above 2^24 round, as in the reference.
    Column access is a strided read over the rows (the row store's scan
    cost); row gathers read the full width and then project, like a heap
    page read."""

    data: torch.Tensor                   # (rows, width) float32
    layout: tuple[str, ...]              # column name per slot

    @staticmethod
    def layout_of(table: ColumnTable) -> tuple[str, ...]:
        """The slot names a row table of ``table`` has (its width is their
        number), without building it."""
        layout = []
        for name in table.names:
            col = table.columns[name]
            layout += ([name] if col.dim() == 1 else
                       [f"{name}.{j}" for j in range(col.shape[1])])
        return tuple(layout)

    @classmethod
    def from_column_table(cls, table: ColumnTable) -> "RowTable":
        layout = cls.layout_of(table)
        data = torch.empty((table.num_rows, len(layout)),
                           dtype=torch.float32, device=table.device)
        slot = 0
        for name in table.names:
            col = table.columns[name].reshape(table.num_rows, -1)
            data[:, slot:slot + col.shape[1]] = col
            slot += col.shape[1]
        return cls(data, layout)

    @property
    def num_rows(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    def slot(self, name: str) -> int:
        return self.layout.index(name)

    def column(self, name: str) -> torch.Tensor:
        """Full-column read: a view strided over the rows (the row-store
        scan cost)."""
        return self.data[:, self.slot(name)]

    def take_rows(self, positions: torch.Tensor) -> torch.Tensor:
        """Gather whole rows (the heap-page read) at int32 ``positions``
        of any shape, through one ``late_gather_columns`` call of the
        (R, W) table: a position in [-R, 0) counts from the end once, and
        the padding sentinel ``num_rows`` (or one below -R) gives a zero
        row.  Returns ``positions.shape + (W,)``."""
        rows = late_gather_columns([self.data], positions.reshape(-1))[0]
        return rows.reshape(positions.shape + (self.width,))

    def project(self, rows: torch.Tensor, names: Sequence[str]
                ) -> Dict[str, torch.Tensor]:
        """Project columns back out of gathered full rows; multi-slot
        (vector) columns are reassembled from their interleaved slots."""
        out = {}
        for n in names:
            if n in self.layout:
                out[n] = rows[..., self.slot(n)]
                continue
            slots = [i for i, nm in enumerate(self.layout)
                     if nm.startswith(n + ".")]
            if not slots:
                raise KeyError(n)
            out[n] = rows[..., slots]
        return out
