"""Parameter trees: nested dicts and lists of tensors, the port's stand-in
for JAX's pytrees.

A dict's entries are visited in sorted key order and a list's in index
order, as ``jax.tree_util`` flattens the reference's trees, so
:func:`leaves` lists a tree's tensors in the reference's leaf order and
:func:`paths` names them as its checkpoints do.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch

__all__ = ["leaves", "paths", "tree_map", "unflatten", "value_and_grad",
           "make_train_step"]


def paths(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) in leaf order; a path holds dict keys and list
    indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of each leaf of ``tree`` and the leaves at the same place in
    ``rest``, in a tree of ``tree``'s structure (tuples become lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _build(node: Any, prefix: tuple, order: dict) -> Any:
    if isinstance(node, dict):
        return {k: _build(v, prefix + (k,), order) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_build(v, prefix + (i,), order) for i, v in enumerate(node)]
    return order[prefix]


def unflatten(like: Any, flat: list) -> Any:
    """The leaves ``flat`` (in :func:`leaves` order) in ``like``'s
    structure.  (A module-level recursion: a nested recursive function
    would hold itself, and with it every leaf, in a reference cycle that
    only the cyclic collector frees, so a training loop's old parameters
    and moments would pile up on the card between collections.)"""
    it = iter(flat)
    order = {path: next(it) for path, _ in paths(like)}
    return _build(like, (), order)


def value_and_grad(loss_fn: Callable, params: Any, *args: Any,
                   has_aux: bool = False, **kwargs: Any
                   ) -> tuple[Any, Any]:
    """``jax.value_and_grad(loss_fn, has_aux=has_aux)(params, *args)``: the
    loss, detached, and its gradient with respect to every leaf of
    ``params``, in ``params``' structure; with ``has_aux``, ``loss_fn``
    returns ``(loss, aux)`` and the value is ``(loss, aux)`` with every
    tensor of ``aux`` detached.  The loss runs on detached copies of the
    leaves that require a gradient, so ``params`` itself is left as it
    was."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        out = loss_fn(live, *args, **kwargs)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, leaves(live), allow_unused=True)
    flat = [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves(live), grads)]
    if has_aux:
        value = (loss.detach(), tree_map(lambda t: t.detach(), out[1]))
    else:
        value = loss.detach()
    return value, unflatten(params, flat)


def make_train_step(loss_fn: Callable, optimizer) -> Callable:
    """``step(params, opt_state, *batch, **kwargs) -> (params, opt_state,
    {"loss", "grad_norm"})``: ``loss_fn(params, *batch, **kwargs)``'s
    gradient and one ``optimizer.update``, the reference's train steps'
    ``jax.value_and_grad`` + ``update``."""
    def step(params, opt_state, *batch, **kwargs):
        loss, grads = value_and_grad(loss_fn, params, *batch, **kwargs)
        params, opt_state, gnorm = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}
    return step
