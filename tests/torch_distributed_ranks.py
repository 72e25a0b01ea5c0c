"""The rank side of ``tests/test_torch_distributed_bfs.py``: what one gloo
rank runs, kept apart from the test module so that a spawned rank imports
torch and the port only (no jax, no repro)."""
import numpy as np
import torch

from repro_torch.core.distributed_bfs import (gather_result,
                                              make_distributed_pbfs)
from repro_torch.core.operators import EngineCaps
from repro_torch.data.treegen import TreeSpec, make_edge_table
from repro_torch.launch.mesh import make_mesh


def shard(cols: dict, rank: int, world: int, drop: int = 0) -> tuple:
    """This rank's rows of ``from``, ``to`` and ``column1`` (less ``drop``
    rows at its end) as CPU tensors."""
    e_loc = cols["from"].shape[0] // world
    rows = slice(rank * e_loc, (rank + 1) * e_loc - drop)
    return tuple(torch.from_numpy(np.ascontiguousarray(cols[k][rows]))
                 for k in ("from", "to", "column1"))


def rank_cases(rank: int, world: int, spec: dict, max_depth: int,
               meshes: dict, uneven=None) -> dict:
    """On each mesh of ``meshes`` (key -> (shape, axes, cases)), run its
    (caps name, caps, root name, root) cases and gather each result into
    the reference's global layout.  Returns, on every rank, the meshes'
    shapes and axis names, and on rank 0 the results as numpy arrays
    under ``"<mesh>/<caps>/<root>"``.  With ``uneven`` (caps) the last rank
    also calls at those caps with one row fewer, and each rank reports
    whether it raised ``ValueError``."""
    cols = make_edge_table(TreeSpec(**spec))
    v = spec["num_vertices"]
    args = shard(cols, rank, world)
    out = {"meshes": {}, "results": {}}
    for key, (shape, axes, cases) in meshes.items():
        mesh = make_mesh(shape, axes, device_type="cpu")
        out["meshes"][key] = (tuple(mesh.mesh.shape), mesh.mesh_dim_names)
        fns = {}
        for caps_name, caps, root_name, root in cases:
            if caps_name not in fns:
                fns[caps_name] = make_distributed_pbfs(
                    mesh, axes, v, caps=EngineCaps(*caps),
                    max_depth=max_depth,
                    num_payload_cols=spec["payload_cols"], device="cpu")
            fn = fns[caps_name]
            got = gather_result(fn(*args, root), fn.group)
            if rank == 0:
                out["results"][f"{key}/{caps_name}/{root_name}"] = \
                    tuple(t.numpy() for t in got)
    if uneven is not None:
        mesh = make_mesh((world,), ("data",), device_type="cpu")
        fn = make_distributed_pbfs(mesh, ("data",), v,
                                   caps=EngineCaps(*uneven),
                                   max_depth=max_depth,
                                   num_payload_cols=spec["payload_cols"],
                                   device="cpu")
        drop = 1 if rank == world - 1 else 0
        try:
            fn(*shard(cols, rank, world, drop), 0)
            out["uneven_raised"] = False
        except ValueError:
            out["uneven_raised"] = True
    return out
