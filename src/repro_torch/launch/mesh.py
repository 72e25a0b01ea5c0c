"""Device meshes over ``torch.distributed`` (the reference's
``src/repro/launch/mesh.py``).

Functions, not module-level constants, so importing this module touches no
process group.  Both build a ``DeviceMesh`` over the default group, which
the caller has initialised (``torch.distributed.init_process_group``, or
``repro_torch.distributed.spawn``'s ``init_default_group``): one rank a
device, ranks laid out row-major over the axes.  A mesh whose size is not
the group's world size raises; no smaller mesh is built in its place.

The production meshes keep the reference's shapes: one pod of 256 devices
as ``(data=16, model=16)``, two pods as ``(pod=2, data=16, model=16)``,
the leading ``pod`` axis composing with ``data`` for data parallelism.

The reference's ``_build_mesh`` (a JAX version shim) and
``shard_map_compat`` (``core/distributed_bfs.py``) have no counterpart:
``init_device_mesh`` is the one constructor, and a rank runs its shard's
body itself, with ``torch.distributed`` collectives in place of
``shard_map``'s.
"""
from __future__ import annotations

import math

__all__ = ["make_mesh", "make_production_mesh"]


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named by ``axes`` over the initialised
    default group (tests, one card, elastic re-scale)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of shape {shape} needs the default "
                           "process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                         f"devices but the world size is {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh: (16, 16) as ("data", "model"), or
    with ``multi_pod`` (2, 16, 16) as ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
