"""Carry the reference's state across into the port.

The reference's dataset is its column table; the port takes it as numpy
arrays (for example ``{k: np.asarray(v) for k, v in
ds.table.columns.items()}``) and rebuilds its own ``Dataset`` on a device,
keeping each column's dtype.  DeepFM's parameters cross the same way: the
reference's ``init_deepfm`` pytree as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``) become the port's
parameter dictionary, the GNN archs' ``init_gnn`` trees become the
port's ``models.gnn`` trees, the LM archs' ``init_lm`` trees become the
port's ``models.transformer`` trees, and an optimizer's state (``AdamW``'s
``{"mu", "nu", "step"}`` or ``sgd_momentum``'s ``{"vel", "step"}``)
crosses as the parameters do, through ``tree_from_numpy``.
``tree_to_numpy`` hands the port's trees back.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.engine import Dataset, resolve_device
from .core.table import ColumnTable

__all__ = ["dataset_from_numpy", "deepfm_params_from_numpy",
           "gnn_params_from_numpy", "lm_params_from_numpy",
           "tree_from_numpy", "tree_to_numpy"]


def dataset_from_numpy(columns: Mapping[str, np.ndarray], num_vertices: int,
                       device=None) -> Dataset:
    """The port's ``Dataset`` over ``columns`` on ``device`` (``None``: the
    card, raising where CUDA is unavailable)."""
    device = resolve_device(device)
    return Dataset.prepare(ColumnTable.from_numpy(columns, device),
                           num_vertices, device=device)


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a tensor of the same dtype and bits; numpy has no bfloat16
    of its own (JAX's arrives as the ``ml_dtypes`` type of that name), so
    it crosses as raw 16-bit words."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def deepfm_params_from_numpy(params: Mapping[str, Any], device=None
                             ) -> dict[str, Any]:
    """The port's DeepFM parameters (``models.recsys``) from the
    reference's ``init_deepfm`` pytree as numpy arrays (``table``,
    ``first_order``, ``bias``, ``mlp[i]["w"|"b"]``), keeping each dtype
    (a bfloat16 ``table_dtype`` included), on ``device`` (``None``: the
    card, raising where CUDA is unavailable)."""
    device = resolve_device(device)
    out: dict[str, Any] = {k: _tensor(params[k], device)
                           for k in ("table", "first_order", "bias")}
    out["mlp"] = [{k: _tensor(layer[k], device) for k in ("w", "b")}
                  for layer in params["mlp"]]
    return out


def tree_from_numpy(tree: Any, device=None) -> Any:
    """A tree of numpy arrays (dicts and lists) as tensors of the same
    nesting and dtypes on ``device`` (``None``: the card, raising where
    CUDA is unavailable)."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _tensor(node, device)

    return walk(tree)


def gnn_params_from_numpy(params: Any, device=None) -> Any:
    """The port's GNN parameters (``models.gnn``) from the reference's
    ``init_gnn`` tree as numpy arrays (for example
    ``jax.tree_util.tree_map(np.asarray, params)``): the same nesting of
    dicts and lists, each array a tensor of its dtype on ``device``
    (``None``: the card, raising where CUDA is unavailable)."""
    return tree_from_numpy(params, device)


def lm_params_from_numpy(params: Any, device=None) -> Any:
    """The port's LM parameters (``models.transformer``) from the
    reference's ``init_lm`` tree as numpy arrays (for example
    ``jax.tree_util.tree_map(np.asarray, params)``): ``embed``,
    ``layers`` (each leaf with its leading ``n_layers`` axis),
    ``final_ln`` and ``unembed``, each array a tensor of its dtype (a
    bfloat16 one included) on ``device`` (``None``: the card, raising
    where CUDA is unavailable)."""
    return tree_from_numpy(params, device)


def tree_to_numpy(tree: Any) -> Any:
    """A tree of tensors (parameters, optimizer state, metrics) as numpy
    arrays of the same nesting and dtypes, on the host; a bfloat16 tensor
    becomes the ``ml_dtypes`` bfloat16 array the reference uses."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return np.asarray(t)
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return leaf(node)

    return walk(tree)
