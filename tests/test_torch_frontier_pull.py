"""The port's plain ``frontier_pull`` versions against the JAX Pallas
kernel (``pull_contrib_pallas`` through ``frontier_pull_fused``,
interpret mode) and the JAX ``frontier_pull_ref``, on random graphs,
frontiers and visited sets in the manner of tests/test_kernels.py, with
``from``/``to`` values outside [0, V) and an empty edge list, and on the
shared ``PULL_CASES`` (hub rows of many tiles hit first or only last, rows
at the thread and tile limits, clamped ids, a ragged V, an empty
frontier, everything visited, no edges).

Both plain versions run: the per-entry ``frontier_pull_ref`` and the
per-vertex ``frontier_pull_layout_ref`` over the kernel's ``PullLayout``.
The (V,) next-frontier masks must be exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.csr import build_csr
from repro.kernels.frontier_pull import frontier_pull_fused, frontier_pull_ref
from repro_torch.core.csr import build_csr as port_build_csr
from repro_torch.kernels.frontier_pull import (PULL_CASES, build_pull_layout,
                                               frontier_pull_layout_ref,
                                               pull_case)
from repro_torch.kernels.frontier_pull import ops as fp_ops
from repro_torch.kernels.frontier_pull import \
    frontier_pull_ref as port_frontier_pull_ref
from repro_torch.kernels.frontier_pull.layout import HUB_TILE, SHORT_ROW
from repro_torch.kernels.frontier_pull.ref import HUB, NO_HIT, TILE_ROWS
from test_torch_engine import release_reference_executables  # noqa: F401

# one vertex and edge count for the random cases, so the interpret-mode
# Pallas kernel compiles once
NUM_VERTICES, NUM_EDGES = 40, 300


def check_case(src, dst, frontier, visited):
    """The reference's kernel, its plain version, the port's two plain
    versions and the port's wrapper on CPU tensors, with and without a
    layout, all agree exactly."""
    v = frontier.shape[0]
    rcsr = build_csr(jnp.asarray(dst), v)
    args = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(frontier),
            jnp.asarray(visited))
    want = np.asarray(frontier_pull_ref(rcsr, *args))
    np.testing.assert_array_equal(
        np.asarray(frontier_pull_fused(rcsr, *args)), want)

    prcsr = port_build_csr(torch.from_numpy(dst), v)
    pargs = [torch.from_numpy(a) for a in (src, dst, frontier, visited)]
    layout = build_pull_layout(prcsr, pargs[0], pargs[1], v)
    before = fp_ops.LAUNCHES
    for got in (port_frontier_pull_ref(prcsr, *pargs),
                fp_ops.frontier_pull_fused(prcsr, *pargs),
                frontier_pull_layout_ref(layout, *pargs[2:]),
                fp_ops.frontier_pull_fused(prcsr, *pargs, layout=layout)):
        assert got.dtype == torch.bool and got.shape == (v,)
        np.testing.assert_array_equal(got.numpy(), want)
    assert fp_ops.LAUNCHES == before       # no kernel ran on the CPU
    return want


@pytest.mark.parametrize("seed", range(12))
def test_frontier_pull_random(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, NUM_VERTICES, NUM_EDGES).astype(np.int32)
    dst = rng.integers(0, NUM_VERTICES, NUM_EDGES).astype(np.int32)
    frontier = rng.random(NUM_VERTICES) < 0.3
    visited = (rng.random(NUM_VERTICES) < 0.4) | frontier
    check_case(src, dst, frontier, visited)


@pytest.mark.parametrize("seed", range(4))
def test_frontier_pull_out_of_range_ids(seed):
    """``from``/``to`` values below 0 and at or above V clip onto vertex 0
    or V-1 per entry; build_csr keeps such entries in ``perm``."""
    rng = np.random.default_rng(100 + seed)
    lo, hi = -5, NUM_VERTICES + 5
    src = rng.integers(lo, hi, NUM_EDGES).astype(np.int32)
    dst = rng.integers(lo, hi, NUM_EDGES).astype(np.int32)
    frontier = rng.random(NUM_VERTICES) < 0.5
    frontier[[0, NUM_VERTICES - 1]] = True
    visited = rng.random(NUM_VERTICES) < 0.2
    visited[[0, NUM_VERTICES - 1]] = False
    want = check_case(src, dst, frontier, visited)
    assert want[0] and want[NUM_VERTICES - 1]


def test_frontier_pull_no_edges():
    none = np.zeros((0,), np.int32)
    frontier = np.ones(8, bool)
    assert not check_case(none, none, frontier, np.zeros(8, bool)).any()


def test_frontier_pull_everything_visited():
    rng = np.random.default_rng(5)
    src = rng.integers(0, NUM_VERTICES, NUM_EDGES).astype(np.int32)
    dst = rng.integers(0, NUM_VERTICES, NUM_EDGES).astype(np.int32)
    full = np.ones(NUM_VERTICES, bool)
    assert not check_case(src, dst, full, full).any()


def test_frontier_pull_cuda_launcher_rejects_cpu_tensors():
    from repro_torch.kernels.frontier_pull import frontier_pull_cuda
    dst = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    layout = build_pull_layout(port_build_csr(dst, 3), dst, dst, 3)
    bits = torch.zeros((3,), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        frontier_pull_cuda(layout, bits, bits)


@pytest.mark.parametrize("case", PULL_CASES)
def test_frontier_pull_cases_match_reference(case):
    """Every shared case through the JAX Pallas kernel (interpret mode) and
    the JAX plain version, and the port's plain versions and wrapper."""
    src, dst, frontier, visited = pull_case(case)
    want = check_case(src, dst, frontier, visited)
    if case in ("hub_early", "hub_last"):
        assert want[HUB]
    elif case == "tile_edges":
        assert all(want[o] == (o != NO_HIT) for o in TILE_ROWS)
    elif case in ("empty_frontier", "all_visited", "e0"):
        assert not want.any()
    else:
        assert want.any()


def walk_as_the_kernel_splits(layout, frontier, visited):
    """The kernel's work split on the host: each row of at most SHORT_ROW
    entries walked by its vertex, each hub tile of at most HUB_TILE
    entries setting its vertex when it holds a hit."""
    ptr, nbr = layout.ptr.tolist(), layout.nbr.tolist()
    out = np.zeros(len(ptr) - 1, bool)
    for v in range(len(out)):
        if not visited[v] and ptr[v + 1] - ptr[v] <= SHORT_ROW:
            out[v] = any(frontier[n] for n in nbr[ptr[v]:ptr[v + 1]])
    for v, start in zip(layout.tile_vtx.tolist(),
                        layout.tile_start.tolist()):
        end = min(start + HUB_TILE, ptr[v + 1])
        if not visited[v] and any(frontier[n] for n in nbr[start:end]):
            out[v] = True
    return out


@pytest.mark.parametrize("case", PULL_CASES)
def test_pull_layout_rows_and_tiles(case):
    """The layout's rows hold each vertex's clamped in-neighbors in
    reverse-CSR order, its tiles cover every entry of every row longer than
    SHORT_ROW exactly once, and the kernel's split of the walk gives the
    plain version's mask."""
    src, dst, frontier, visited = pull_case(case)
    v = frontier.shape[0]
    t_src, t_dst = torch.from_numpy(src), torch.from_numpy(dst)
    rcsr = port_build_csr(t_dst, v)
    layout = build_pull_layout(rcsr, t_src, t_dst, v)
    for t in layout:
        assert t.dtype == torch.int32
    ptr = layout.ptr.numpy()
    perm = rcsr.perm.numpy()
    np.testing.assert_array_equal(layout.nbr.numpy(),
                                  np.clip(src[perm], 0, v - 1))
    np.testing.assert_array_equal(np.diff(ptr),
                                  np.bincount(np.clip(dst, 0, v - 1),
                                              minlength=v))
    deg = np.diff(ptr)
    want_tiles = [(u, s) for u in np.flatnonzero(deg > SHORT_ROW)
                  for s in range(ptr[u], ptr[u + 1], HUB_TILE)]
    assert list(zip(layout.tile_vtx.tolist(),
                    layout.tile_start.tolist())) == want_tiles
    np.testing.assert_array_equal(
        walk_as_the_kernel_splits(layout, frontier, visited),
        frontier_pull_layout_ref(layout, torch.from_numpy(frontier),
                                 torch.from_numpy(visited)).numpy())
    if case in ("hub_early", "hub_last"):
        assert layout.tile_vtx.tolist() == [HUB] * 12


def test_pull_layout_refuses_a_perm_that_does_not_sort_join_dst():
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.integers(0, 50, 200).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 50, 200).astype(np.int32))
    by_src = port_build_csr(src, 50)        # sorts the other column
    with pytest.raises(ValueError, match="does not sort join_dst"):
        build_pull_layout(by_src, src, dst, 50)
    build_pull_layout(port_build_csr(dst, 50), src, dst, 50)


@pytest.fixture(scope="module")
def small_tree():
    from repro_torch.convert import dataset_from_numpy
    from repro_torch.data.treegen import TreeSpec, make_edge_table
    cols = make_edge_table(TreeSpec(num_vertices=600, height=7,
                                    payload_cols=1, seed=2))
    return dataset_from_numpy(cols, 600, "cpu")


def test_dataset_builds_each_pull_layout_once(small_tree):
    """``Dataset`` builds one layout per orientation on first use, over
    that orientation's reverse CSR, and its context hands it on; the fused
    ``both`` view has none."""
    from repro_torch.convert import dataset_from_numpy
    ds = dataset_from_numpy({k: c.numpy() for k, c in
                             small_tree.table.columns.items()}, 600, "cpu")
    assert ds.context().pull_layout is None
    for direction in ("outbound", "inbound", "both"):
        ds.ensure_pull_layout(direction)
    assert set(ds.pull_layouts) == {"outbound", "inbound"}
    built = dict(ds.pull_layouts)
    for direction in ("outbound", "inbound"):
        ds.ensure_pull_layout(direction)
        ctx = ds.context(direction)
        assert ds.pull_layouts[direction] is built[direction]
        assert ctx.pull_layout is built[direction]
        want = build_pull_layout(ctx.rcsr, ctx.join_src, ctx.join_dst, 600)
        for got, w in zip(built[direction], want):
            assert torch.equal(got, w)
    assert ds.context("both").pull_layout is None


@pytest.mark.parametrize("direction", ["outbound", "inbound"])
def test_pull_steps_hand_the_layout_to_the_kernel_slot(small_tree,
                                                       direction):
    """A pull step passes its context's layout to the plugged-in wrapper on
    every level; the result equals the plan without a kernel."""
    from repro_torch.core.bitmap import diropt_plan
    from repro_torch.core.engine import EngineCaps, RecursiveQuery
    from repro_torch.core.operators import execute
    ds = small_tree
    ds.ensure_pull_layout(direction)
    q = RecursiveQuery("diropt", 7, 1, EngineCaps(1024, 2048),
                       direction=direction)
    seen = []

    def spy(*args, layout=None):
        seen.append(layout)
        return fp_ops.frontier_pull_fused(*args, layout=layout)

    root = 0 if direction == "outbound" else 599
    plans = [diropt_plan(q.caps, 7, q.out_cols, direction, alpha=1e9,
                         beta=1e9, pull_fn=fn) for fn in (None, spy)]
    want, got = (execute(p, ds.context(direction), root, 600)
                 for p in plans)
    assert len(seen) == int(got.depth) > 0
    assert all(layout is ds.pull_layouts[direction] for layout in seen)
    for field in ("positions", "count", "depth", "row_depths", "level_dirs"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
