"""Exact cost of an LM cell, and its affine decomposition in the trip
counts, the reference's ``src/repro/launch/probe.py``.

The reference probes because XLA's ``HloCostAnalysis`` tallies a
``while`` body once: it compiles four small unrolled configs and
extrapolates the affine cost

    T(L, C, K) = a + L·c + (L·C)·d + K·e

(L layers, C attention KV chunks, K loss chunks) to the production cell.
The port's counter (``launch.count``) sees every op an eager step
dispatches, so the port counts the target cell directly on the ``meta``
device, which is exact, and reports that count.  It still fits (a, c, d,
e) from the reference's four probe configs, (L, C, K) = (2, 1, 1),
(4, 1, 1), (2, 2, 1) and (2, 1, 2), at the cell's own shape, and reports
the fit and its extrapolation beside the count: the decomposition says
what a layer, a KV chunk and a loss chunk cost.  In eager, FLOPs do not
move with C or K (d = e = 0): a chunk splits the same products.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..configs.registry import get_config, shapes_for
from .count import Count, count_call
from .steps import build_lm_cell

__all__ = ["KEYS", "measure", "lm_exact_costs"]

KEYS = ("flops", "hbm_bytes", "collective_bytes")


def measure(cfg, dims: dict) -> Count:
    """The :class:`Count` of one step of the LM cell ``dims`` of
    ``cfg``, built on ``meta``."""
    plan = build_lm_cell(cfg, dims, "meta")
    return count_call(plan.fn, *plan.args)[1]


def _terms(count: Count) -> Dict[str, float]:
    return {"flops": count.flops, "hbm_bytes": count.hbm_bytes,
            "collective_bytes": 0.0}


def lm_exact_costs(arch: str, shape_id: str,
                   attn_window: int | None = None,
                   overrides: dict | None = None, *, smoke: bool = False,
                   direct: Optional[Count] = None) -> Dict[str, object]:
    """``{flops, hbm_bytes, collective_bytes}`` of the cell, counted
    directly on ``meta`` (``direct``, a count already made of the same
    cell, saves that count), with ``probe_<key>`` the fit's ``a``,
    ``per_layer``, ``per_chunk`` and ``per_loss_chunk``,
    ``probe_extrapolated`` the fit at the cell's trip counts and
    ``probe_counts`` those counts."""
    cfg, _ = get_config(arch, smoke=smoke)
    if attn_window is not None:
        cfg = dataclasses.replace(cfg, attn_window=attn_window)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    dims = shapes_for("lm", smoke=smoke)[shape_id]
    seq = dims["seq"]
    has_loss = dims["kind"] == "train"

    l_target = cfg.n_layers
    c_target = max(1, -(-seq // cfg.attn_chunk))
    k_target = max(1, seq // min(cfg.loss_chunk, seq)) if has_loss else 1

    def probe(l, c, k):
        pc = dataclasses.replace(cfg, n_layers=l,
                                 attn_chunk=max(1, seq // c),
                                 loss_chunk=max(1, seq // k))
        return _terms(measure(pc, dims))

    t211 = probe(2, 1, 1)
    t411 = probe(4, 1, 1)
    t221 = probe(2, 2, 1)
    t212 = probe(2, 1, 2) if has_loss else None

    out: Dict[str, object] = dict(_terms(direct or measure(cfg, dims)))
    fit = {}
    for key in KEYS:
        d = (t221[key] - t211[key]) / 2.0            # per (layer x chunk)
        e = (t212[key] - t211[key]) if has_loss else 0.0
        c = (t411[key] - t211[key]) / 2.0 - d        # per layer at C=1
        a = t211[key] - 2 * c - 2 * d - e
        fit[key] = a + l_target * c + l_target * c_target * d + k_target * e
        out[f"probe_{key}"] = {"a": a, "per_layer": c, "per_chunk": d,
                               "per_loss_chunk": e}
    out["probe_extrapolated"] = fit
    out["probe_counts"] = {"L": l_target, "C": c_target, "K": k_target}
    return out
