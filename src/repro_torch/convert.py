"""Carry the reference's state across into the port.

The reference's dataset is its column table; the port takes it as numpy
arrays (for example ``{k: np.asarray(v) for k, v in
ds.table.columns.items()}``) and rebuilds its own ``Dataset`` on a device,
keeping each column's dtype.  This is the counterpart of carrying weights
across for a model.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .core.engine import Dataset, resolve_device
from .core.table import ColumnTable

__all__ = ["dataset_from_numpy"]


def dataset_from_numpy(columns: Mapping[str, np.ndarray], num_vertices: int,
                       device=None) -> Dataset:
    """The port's ``Dataset`` over ``columns`` on ``device`` (``None``: the
    card, raising where CUDA is unavailable)."""
    device = resolve_device(device)
    return Dataset.prepare(ColumnTable.from_numpy(columns, device),
                           num_vertices, device=device)
