"""Distributed positional BFS: PRecursive over a device mesh, the operator
pipeline on the SAME :func:`~repro_torch.core.operators.fixed_point`
driver as the one-device engines (the reference's
``src/repro/core/distributed_bfs.py``).

PosDB is "a disk-based *distributed* column-store"; the paper evaluates a
single node.  This module is the distributed engine the paper implies, on
``torch.distributed``:

* every column of the edge table is row-sharded over the BFS axes
  (``('pod', 'data')`` on the production mesh): each rank owns a slab of
  edges and builds a *local* CSR join index over it;
* the per-level pipeline is ``CSRIndexJoin`` (shard-local positional
  expansion of the replicated vertex frontier) -> ``AppendUnionAll``
  (shard-local result positions) -> ``ShardTargetExchange`` (ONE tiled
  all-gather of vertex ids a level, the only collective of the loop,
  O(frontier) bytes and never values, then the replicated dedup, so every
  rank derives the same next frontier);
* result positions stay shard-local; the final late materialization is a
  shard-local gather, so payload bytes cross no link at any point.

Where the reference's ``shard_map`` body runs once per device inside one
program, here every rank calls :func:`make_distributed_pbfs`'s function on
its own shard, and the ranks meet in the collectives.  Each rank reads the
level's frontier count on the host (one read a level, as every engine of
the port); after the exchange that count is the same on every rank, so all
ranks run the same levels and the same collectives.  On the card the
expansion is the ``frontier_expand`` kernel and the materialization the
``late_gather`` kernel; on the CPU their plain versions.  The collectives
run over NCCL for CUDA tensors and gloo for CPU ones.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..kernels.frontier_expand.ops import frontier_expand_fused
from ..kernels.late_gather.ops import late_gather
from .csr import build_csr
from .engine import resolve_device
from .operators import (AppendUnionAll, Context, CSRIndexJoin, EngineCaps,
                        Pipeline, RawPositions, Seed, ShardTargetExchange,
                        all_gather_tiled, fixed_point)

__all__ = ["distributed_plan", "make_distributed_pbfs", "gather_result"]

# the backend a group must use for a device type's tensors
_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


def distributed_plan(group, caps: EngineCaps, max_depth: int, *,
                     axis="data", expand_fn=None) -> Pipeline:
    """The distributed PRecursive pipeline: vertex-seeded (the frontier is
    the replicated target block, not edge positions), emitting inside the
    body (``inclusive`` and ``step_tag_offset=0``), with the shard-aware
    target union over ``group``.  ``axis`` names the shard axes in the
    plan's text; ``expand_fn`` plugs the expansion kernel in."""
    return Pipeline(
        name="DistributedPRecursive", rep="pos",
        seed=Seed(kind="vertices"),
        ops=(CSRIndexJoin(expand_fn),
             AppendUnionAll("pos", step_tag_offset=0, append_seed=False),
             ShardTargetExchange(group, axis)),
        finisher=RawPositions(), caps=caps, max_depth=max_depth,
        inclusive=True)


def _shard_group(mesh, axes: Sequence[str]):
    """(group, index): the process group over ``mesh``'s ``axes`` that
    holds this rank, and this rank's index in it.  The index
    is row-major over ``axes``, the order in which the group's tiled
    all-gather concatenates and the reference's ``shard_map`` lays out the
    shards; a mesh whose ranks do not rise in that order raises.  One axis
    is the mesh's own group; several are one new group for each slice of
    the other axes, which every rank of the default group must build
    together (:func:`torch.distributed.new_subgroups_by_enumeration`)."""
    import torch.distributed as dist
    axes = tuple(axes)
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing or len(set(axes)) != len(axes):
        raise ValueError(f"axes {axes}: the mesh's axes are {names}")
    dims = [names.index(a) for a in axes]
    sizes = [mesh.mesh.shape[d] for d in dims]
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        rest = [d for d in range(mesh.mesh.dim()) if d not in dims]
        rows = mesh.mesh.permute(rest + dims).reshape(
            -1, math.prod(sizes)).tolist()
        group, _ = dist.new_subgroups_by_enumeration(rows)
    coord = mesh.get_coordinate()
    index = 0
    for d, n in zip(dims, sizes):
        index = index * n + coord[d]
    if dist.get_rank(group) != index:
        raise ValueError(f"mesh ranks {mesh.mesh.tolist()} do not rise "
                         f"row-major over {axes}: this rank is {index} "
                         f"along them but {dist.get_rank(group)} in its "
                         "group")
    return group, index


def _require_backend(group, device: torch.device) -> None:
    """Raise unless ``group`` runs ``device``'s tensors on NCCL (the card)
    or gloo (the CPU); no collective falls back to another backend."""
    import torch.distributed as dist
    name = str(dist.get_backend(group)).lower()
    by_type = (dict(p.split(":") for p in name.split(","))
               if ":" in name else {device.type: name})
    want = _BACKEND_FOR[device.type]
    if by_type.get(device.type) != want:
        raise RuntimeError(f"a {device.type} run needs a group with {want} "
                           f"for {device.type} tensors; this group's "
                           f"backend is {name!r}")


def make_distributed_pbfs(mesh, axes: Sequence[str], num_vertices: int, *,
                          caps: EngineCaps, max_depth: int,
                          num_payload_cols: int, device=None):
    """This rank's distributed PRecursive BFS over ``mesh``'s ``axes``.

    Returns ``fn(from_loc, to_loc, payload_loc, root) -> (gpos, vals,
    count, depth, overflow)``, the shard that the reference's
    ``shard_map`` body returns: ``from_loc`` / ``to_loc`` (E_loc,) int32
    and ``payload_loc`` (E_loc, W) float32 are this rank's rows of the
    edge table (rows ``index * E_loc`` on, ``index`` the rank's place
    along ``axes``), ``root`` an int, the same on every rank.  ``gpos``
    is the (caps.result,) int32 global edge position of each live result
    row, -1 past ``count``; ``vals`` the (caps.result, W) payload rows
    at them, zero past ``count``; ``count``, ``depth`` (the levels run
    less one) and ``overflow`` (this shard's: its expansion, the gathered
    frontier or its result buffer over capacity) are (1,) each.  Every
    rank of the group must call ``fn`` with the same root; shards of
    unequal E_loc raise on every rank.  ``num_payload_cols`` is the
    reference's argument; the width comes from ``payload_loc``.

    ``device=None`` means the card, ``cuda:<current device>``, and raises
    without one; pass ``device="cpu"`` for the CPU.  On the card the
    group must run NCCL, on the CPU gloo, else this raises.  ``fn.group``
    is the shard group (:func:`gather_result` takes it)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type not in _BACKEND_FOR:
        raise ValueError(f"device {device}: the card or the CPU")
    axes = tuple(axes)
    group, index = _shard_group(mesh, axes)
    _require_backend(group, device)
    plan = distributed_plan(
        group, caps, max_depth, axis=axes if len(axes) > 1 else axes[0],
        expand_fn=frontier_expand_fused if device.type == "cuda" else None)

    def fn(from_loc: torch.Tensor, to_loc: torch.Tensor,
           payload_loc: torch.Tensor, root: int):
        for name, t in (("from_loc", from_loc), ("to_loc", to_loc),
                        ("payload_loc", payload_loc)):
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}; this BFS runs "
                                 f"on {device}")
        e_loc = from_loc.shape[0]
        sizes = all_gather_tiled(torch.tensor([e_loc], dtype=torch.int64,
                                              device=device), group).tolist()
        if any(n != e_loc for n in sizes):
            raise ValueError(f"shards of {sizes} edges: every shard must "
                             "hold the same number of rows")
        ctx = Context(table=None, csr=build_csr(from_loc, num_vertices),
                      join_src=from_loc, join_dst=to_loc)
        r = fixed_point(plan, ctx, root, num_vertices)
        # shard-local late materialization: payload bytes never leave the
        # shard; the dead slots hold the sentinel E_loc, a zero row
        vals = late_gather(payload_loc, r.positions)
        live = torch.arange(caps.result, dtype=torch.int32,
                            device=device) < r.count
        gpos = torch.where(live, r.positions + index * e_loc, -1)
        return gpos, vals, r.count[None], (r.depth - 1)[None], \
            r.overflow[None]

    fn.group = group
    return fn


def gather_result(outputs, group) -> tuple:
    """All-gather one rank's five outputs of :func:`make_distributed_pbfs`
    over its shard ``group`` into the reference's global layout, the
    shards concatenated in mesh order: ``gpos`` (n * caps.result,),
    ``vals`` (n * caps.result, W), ``count``, ``depth`` and ``overflow``
    (n,) each, on the outputs' device.  A collective: every rank calls
    it.  For checks and printouts; not on the BFS's path."""
    gpos, vals, count, depth, overflow = outputs
    return (all_gather_tiled(gpos, group), all_gather_tiled(vals, group),
            all_gather_tiled(count, group), all_gather_tiled(depth, group),
            all_gather_tiled(overflow.to(torch.uint8), group).bool())
