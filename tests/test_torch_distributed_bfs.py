"""The port's distributed positional BFS (``repro_torch.core.distributed_bfs``)
against the reference's ``repro.core.distributed_bfs`` on the same inputs.

- ``block_from_mask`` equals the reference's, block and overflow, over
  random masks and capacities below, at and above ``n``.
- At world size 1 (gloo, in this process) ``distributed_plan``'s pipeline
  (``Seed(kind="vertices")``, ``ShardTargetExchange``, ``RawPositions``)
  run by ``fixed_point`` equals the reference's run by its
  ``fixed_point`` inside ``shard_map`` on one device, field for field;
  the plans' text is equal.
- ``make_distributed_pbfs`` on gloo CPU ranks (1 in this process; 2, 4
  and 8 spawned, each world once for all its cases) equals the
  reference's on as many fake host devices (one JAX subprocess with 8
  host devices computes every reference case): ("data",) of 1, 2, 4 and
  8 and ("pod", "data") = (2, 4); roots 0, a middle vertex and a leaf;
  two overflow cases.  ``gpos``, counts, depths and overflow flags are
  equal exactly and ``vals`` bit for bit; the live ``gpos`` are
  ``bfs_reference``'s edge positions (a subset where a shard's result
  buffer overflows: root 0's 1,459 rows on fewer than 2 shards of 1,024),
  and ``vals`` the payload rows at them.
- Lockstep: the middle vertex's subtree lies on the last two of eight
  shards and root 0's first levels on one; every rank runs the same
  levels, within the ranks' timeout.
- Shards of unequal size raise on every rank; ``make_mesh`` and
  ``make_production_mesh`` give their shapes and names and raise on a
  world-size mismatch; ``device=None`` without CUDA raises.

Spawned ranks rendezvous through a file store in a temporary directory:
no TCP port is picked.  Under pytest-xdist the cases are computed once for
the session, by the first worker that needs them, and read by the others
(a lock file in the session's temporary directory).
"""
import fcntl
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh
from jax.sharding import PartitionSpec as P

from conftest import subprocess_env
from repro.core import EngineCaps as RefCaps
from repro.core.csr import build_csr as ref_build_csr
from repro.core.distributed_bfs import distributed_plan as ref_plan
from repro.core.distributed_bfs import shard_map_compat
from repro.core.operators import Context as RefContext
from repro.core.operators import fixed_point as ref_fixed_point
from repro.core.positions import block_from_mask as ref_block_from_mask
from repro.data.treegen import bfs_reference
from repro_torch.core.csr import build_csr
from repro_torch.core.distributed_bfs import (distributed_plan,
                                              make_distributed_pbfs)
from repro_torch.core.operators import Context, EngineCaps, fixed_point
from repro_torch.core.positions import block_from_mask
from repro_torch.data.treegen import TreeSpec, make_edge_table
from repro_torch.distributed.spawn import init_default_group, run_ranks
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from test_torch_engine import release_reference_executables  # noqa: F401
from torch_distributed_ranks import rank_cases

SPEC = dict(num_vertices=2049, height=9, payload_cols=2, seed=3)
MAX_DEPTH = 6
CAPS = {"caps": (1024, 1024), "overflow": (16, 1024)}
MESHES = {"data1": ((1,), ("data",)), "data2": ((2,), ("data",)),
          "data4": ((4,), ("data",)), "data8": ((8,), ("data",)),
          "pod2data4": ((2, 4), ("pod", "data"))}
ROOT_NAMES = ("root", "middle", "leaf")
OVERFLOW_MESHES = ("data8", "pod2data4")
WORLDS = {1: ("data1",), 2: ("data2",), 4: ("data4",),
          8: ("data8", "pod2data4")}
FIELDS = ("gpos", "vals", "counts", "depths", "overflow")
RANK_TIMEOUT_S = 120.0           # each spawned world, and its collectives
REFERENCE_TIMEOUT_S = 420        # the reference's subprocess
MASK_SEEDS = (0, 1, 2, 3)

COLS = make_edge_table(TreeSpec(**SPEC))
V = SPEC["num_vertices"]


def root_ids(cols: dict) -> dict:
    """Root 0; the grandparent of the last vertex (its subtree lies in the
    deepest levels, on the last shards); the last vertex, a leaf."""
    src = cols["from"]
    parent = int(src[-1])
    return {"root": 0, "middle": int(src[parent - 1]),
            "leaf": int(cols["to"][-1])}


ROOTS = root_ids(COLS)


def cases_of(key: str) -> list:
    out = [("caps", CAPS["caps"], n, ROOTS[n]) for n in ROOT_NAMES]
    if key in OVERFLOW_MESHES:
        out.append(("overflow", CAPS["overflow"], "root", ROOTS["root"]))
    return out


REFERENCE_SCRIPT = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import EngineCaps
from repro.core.distributed_bfs import make_distributed_pbfs
from repro.data.treegen import TreeSpec, make_edge_table
from repro.launch.mesh import make_mesh

spec, max_depth, meshes, runs, fields, out = json.loads(sys.argv[1])
table = make_edge_table(TreeSpec(**spec))
cols = [np.asarray(table.column(k)) for k in ("from", "to", "column1")]
res = {}
for key, (shape, axes) in meshes.items():
    mesh = make_mesh(tuple(shape), tuple(axes))
    sh = NamedSharding(mesh, P(tuple(axes) if len(axes) > 1 else axes[0]))
    args = [jax.device_put(c, sh) for c in cols]
    fns = {}
    for caps_name, caps, root_name, root in runs[key]:
        if caps_name not in fns:
            fns[caps_name] = make_distributed_pbfs(
                mesh, tuple(axes), spec["num_vertices"],
                caps=EngineCaps(*caps), max_depth=max_depth,
                num_payload_cols=spec["payload_cols"])
        got = fns[caps_name](*args, jnp.int32(root))
        for name, a in zip(fields, got):
            res[f"{key}/{caps_name}/{root_name}/{name}"] = np.asarray(a)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    """This process as rank 0 of a gloo world of 1, for the module."""
    import torch.distributed as dist
    store = tmp_path_factory.mktemp("world_one") / "store"
    init_default_group(0, 1, str(store), "cpu", RANK_TIMEOUT_S)
    yield
    dist.destroy_process_group()


def compute_runs(workdir) -> tuple:
    """Every case of every mesh: the reference's (its subprocess started
    first) and the port's (world 1 in this process, the others spawned),
    as ``(reference, port, meshes, uneven)``: ``reference[key][field]``
    and ``port[key]`` a tuple of the five gathered outputs, key
    ``"<mesh>/<caps>/<root>"``."""
    out = workdir / "ref.npz"
    arg = json.dumps([SPEC, MAX_DEPTH, MESHES,
                      {k: cases_of(k) for k in MESHES}, FIELDS, str(out)])
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_SCRIPT, arg],
                           env=subprocess_env(8), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        port, meshes, uneven = {}, {}, []
        for world, keys in WORLDS.items():
            per_mesh = {k: (*MESHES[k], cases_of(k)) for k in keys}
            if world == 1:
                outs = [rank_cases(0, 1, SPEC, MAX_DEPTH, per_mesh)]
            else:
                outs = run_ranks(rank_cases, world, SPEC, MAX_DEPTH,
                                 per_mesh,
                                 CAPS["caps"] if world == 2 else None,
                                 timeout_s=RANK_TIMEOUT_S)
            port.update(outs[0]["results"])
            meshes.update(outs[0]["meshes"])
            if world == 2:
                uneven = [o["uneven_raised"] for o in outs]
        _, err = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    with np.load(out) as z:
        reference = {}
        for name in z.files:
            key, field = name.rsplit("/", 1)
            reference.setdefault(key, {})[field] = z[name]
    return reference, port, meshes, uneven


@pytest.fixture(scope="module")
def runs(world_one, tmp_path_factory):
    """:func:`compute_runs`, once for the session: alone, here; under
    xdist, by the first worker to hold the session's lock, pickled into
    the session's temporary directory for the others."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return compute_runs(tmp_path_factory.mktemp("runs"))
    shared = tmp_path_factory.getbasetemp().parent / "torch_distributed_bfs"
    shared.mkdir(exist_ok=True)
    cache = shared / "runs.pkl"
    with open(shared / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not cache.exists():
                data = compute_runs(shared)
                with open(shared / "runs.tmp", "wb") as f:
                    pickle.dump(data, f)
                os.replace(shared / "runs.tmp", cache)
            with open(cache, "rb") as f:
                return pickle.load(f)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def oracle_positions(root: int) -> set:
    levels = bfs_reference(COLS["from"], COLS["to"], root, MAX_DEPTH, V)
    return set().union(*levels[:MAX_DEPTH + 1])


def assert_same_outputs(got: tuple, want: dict, label: str) -> None:
    for name, g in zip(FIELDS, got):
        w = want[name]
        assert g.shape == w.shape, (label, name, g.shape, w.shape)
        if name == "overflow":
            np.testing.assert_array_equal(g, w.astype(bool),
                                          err_msg=f"{label} {name}")
            continue
        assert g.dtype == w.dtype, (label, name, g.dtype, w.dtype)
        if name == "vals":     # bit for bit
            np.testing.assert_array_equal(g.view(np.int32),
                                          w.view(np.int32),
                                          err_msg=f"{label} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


@pytest.mark.parametrize("seed", MASK_SEEDS)
@pytest.mark.parametrize("cap_of_n", ["below", "equal", "above"])
def test_block_from_mask_matches_reference(seed, cap_of_n):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    values = rng.integers(-5, 10_000, size=n).astype(np.int32)
    mask = rng.random(n) < rng.random()
    cap = {"below": max(1, int(mask.sum()) // 2), "equal": n,
           "above": n + 17}[cap_of_n]
    blk, ovf = block_from_mask(torch.from_numpy(values),
                               torch.from_numpy(mask), cap, -1)
    want, want_ovf = ref_block_from_mask(jnp.asarray(values),
                                         jnp.asarray(mask), cap, -1)
    np.testing.assert_array_equal(blk.positions.numpy(),
                                  np.asarray(want.positions))
    assert blk.positions.dtype == torch.int32
    assert int(blk.count) == int(want.count)
    assert bool(ovf) == bool(want_ovf)


def test_block_from_mask_of_nothing_is_all_sentinel():
    blk, ovf = block_from_mask(torch.zeros(0, dtype=torch.int32),
                               torch.zeros(0, dtype=torch.bool), 4, 7)
    want, want_ovf = ref_block_from_mask(jnp.zeros(0, jnp.int32),
                                         jnp.zeros(0, bool), 4, 7)
    assert blk.positions.tolist() == np.asarray(want.positions).tolist()
    assert int(blk.count) == int(want.count) == 0
    assert bool(ovf) == bool(want_ovf) is False


def reference_world_one(root: int, caps: tuple):
    """The reference's distributed pipeline on one device: its
    ``fixed_point`` inside ``shard_map`` over a one-device mesh."""
    mesh = RefMesh(np.array(jax.devices()[:1]), ("data",))
    plan = ref_plan("data", RefCaps(*caps), MAX_DEPTH)

    def body(frm, to, r):
        ctx = RefContext(table=None, rows=None, csr=ref_build_csr(frm, V),
                         join_src=frm, join_dst=to)
        res = ref_fixed_point(plan, ctx, r, V)
        return (res.positions, res.count[None], res.depth[None],
                res.overflow[None], res.row_depths)

    fn = shard_map_compat(body, mesh, (P("data"), P("data"), P()),
                          (P("data"),) * 5)
    return [np.asarray(a) for a in jax.jit(fn)(
        jnp.asarray(COLS["from"]), jnp.asarray(COLS["to"]),
        jnp.int32(root))]


@pytest.mark.parametrize("caps_name", sorted(CAPS))
@pytest.mark.parametrize("root_name", ROOT_NAMES)
def test_distributed_plan_at_world_one_matches_reference(world_one,
                                                         root_name,
                                                         caps_name):
    import torch.distributed as dist
    root, caps = ROOTS[root_name], CAPS[caps_name]
    plan = distributed_plan(dist.group.WORLD, EngineCaps(*caps), MAX_DEPTH)
    frm, to = torch.from_numpy(COLS["from"]), torch.from_numpy(COLS["to"])
    ctx = Context(table=None, csr=build_csr(frm, V), join_src=frm,
                  join_dst=to)
    r = fixed_point(plan, ctx, root, V)
    want = reference_world_one(root, caps)
    got = [r.positions.numpy(), r.count[None].numpy(),
           r.depth[None].numpy(), r.overflow[None].numpy(),
           r.row_depths.numpy()]
    for name, g, w in zip(("positions", "count", "depth", "overflow",
                           "row_depths"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert r.values == {}


@pytest.mark.parametrize("axis", ["data", ("pod", "data")])
def test_distributed_plan_renders_as_the_reference(world_one, axis):
    import torch.distributed as dist
    caps = CAPS["caps"]
    got = distributed_plan(dist.group.WORLD, EngineCaps(*caps), MAX_DEPTH,
                           axis=axis)
    assert got.render(5) == ref_plan(axis, RefCaps(*caps),
                                     MAX_DEPTH).render(5)
    assert hash(got) == hash(distributed_plan(None, EngineCaps(*caps),
                                              MAX_DEPTH, axis=axis))


@pytest.mark.parametrize("root_name", ROOT_NAMES)
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_distributed_pbfs_matches_reference(runs, mesh_key, root_name):
    reference, port, _, _ = runs
    key = f"{mesh_key}/caps/{root_name}"
    got = port[key]
    assert_same_outputs(got, reference[key], key)
    gpos, vals, _, _, overflow = got
    live = gpos >= 0
    got_set, want_set = set(gpos[live].tolist()), \
        oracle_positions(ROOTS[root_name])
    if overflow.any():     # a shard's result buffer is full: a subset
        assert got_set < want_set, key
    else:
        assert got_set == want_set, key
    np.testing.assert_array_equal(vals[live], COLS["column1"][gpos[live]])
    assert not vals[~live].any()


@pytest.mark.parametrize("mesh_key", OVERFLOW_MESHES)
def test_distributed_pbfs_overflow_matches_reference(runs, mesh_key):
    reference, port, _, _ = runs
    key = f"{mesh_key}/overflow/root"
    assert_same_outputs(port[key], reference[key], key)
    assert port[key][4].any(), "frontier 16 must overflow at root 0"


def test_lockstep_on_roots_whose_levels_lie_on_few_shards(runs):
    """Root 0's levels 1-3 and the middle vertex's whole subtree lie on
    one or two of eight shards: the others expand nothing for those
    levels, yet every rank reports the same depth (so ran the same
    levels and all-gathers), and the world finished within its
    timeout."""
    _, port, _, _ = runs
    e_loc = COLS["from"].shape[0] // 8
    for root_name in ("root", "middle"):
        gpos, _, counts, depths, _ = port[f"data8/caps/{root_name}"]
        assert len(set(depths.tolist())) == 1, (root_name, depths)
        levels = bfs_reference(COLS["from"], COLS["to"], ROOTS[root_name],
                               MAX_DEPTH, V)
        shards = [{p // e_loc for p in lvl} for lvl in levels if lvl]
        assert min(len(s) for s in shards) <= 2, (root_name, shards)
    _, _, counts, _, _ = port["data8/caps/middle"]
    assert (counts > 0).sum() <= 2 and counts.sum() > 0, counts


def test_unequal_shards_raise_on_every_rank(runs):
    _, _, _, uneven = runs
    assert uneven == [True, True]


@pytest.mark.parametrize("mesh_key", ["data2", "data4", "data8",
                                      "pod2data4"])
def test_make_mesh_on_spawned_ranks(runs, mesh_key):
    _, _, meshes, _ = runs
    shape, axes = MESHES[mesh_key]
    assert meshes[mesh_key] == (shape, axes)


def test_make_mesh_at_world_one(world_one):
    mesh = make_mesh((1,), ("data",), device_type="cpu")
    assert tuple(mesh.mesh.shape) == (1,)
    assert mesh.mesh_dim_names == ("data",)


@pytest.mark.parametrize("build", [
    lambda: make_mesh((2,), ("data",), device_type="cpu"),
    lambda: make_mesh((2, 4), ("pod", "data"), device_type="cpu"),
    lambda: make_production_mesh(device_type="cpu"),
    lambda: make_production_mesh(multi_pod=True, device_type="cpu"),
], ids=["data2", "pod2data4", "production", "multi_pod"])
def test_mesh_of_another_size_than_the_world_raises(world_one, build):
    with pytest.raises(ValueError, match=r"world size is 1"):
        build()


def test_production_mesh_names_its_shape(world_one):
    with pytest.raises(ValueError, match=r"\(2, 16, 16\) holds 512"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_device_none_without_cuda_raises(world_one, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = make_mesh((1,), ("data",), device_type="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_distributed_pbfs(mesh, ("data",), V,
                              caps=EngineCaps(*CAPS["caps"]),
                              max_depth=MAX_DEPTH, num_payload_cols=2)
