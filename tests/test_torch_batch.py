"""Batched roots: the port's ``run_query_batch`` against the JAX reference.

For every port engine and direction, lane ``i`` of the port's batch is
compared field for field with lane ``i`` of the reference's batch and with
the port's own ``run_query(roots[i])``: positions in emission order,
count, depth, overflow, row depths, ``level_dirs`` and every value column.
Nothing here does float arithmetic on values, so the tolerance is 0.

The graph (V = 48) is built so that the batch takes every path of the
batched driver: a star (root 0 reaches 24 vertices at once), a chain (root
40 walks one vertex a level, so the lanes converge at different depths
and, at the same level, ``hybrid`` and the direction switch take
different branches in different lanes), a leaf (37), negative and
out-of-range roots (clipped as ``run_query`` clips them) and a repeated
root.  Each reference batch is computed once per module: JAX keeps every
compiled CPU executable mapped.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import EngineCaps, RecursiveQuery
from repro.core.engine import result_lane as ref_result_lane
from repro.core.engine import run_query_batch as ref_run_query_batch
from repro_torch.core import engine as port
from repro_torch.core.csr import build_csr, lane_cumsum
from repro_torch.kernels.frontier_expand import (EXPAND_CASES,
                                                 expand_lanes_case,
                                                 frontier_expand_fused,
                                                 frontier_expand_ref)
from repro_torch.kernels.frontier_expand import ops as fe_ops
from repro_torch.kernels.frontier_pull import (PULL_CASES, build_pull_layout,
                                               frontier_pull_fused,
                                               frontier_pull_layout_ref,
                                               frontier_pull_ref,
                                               pull_lanes_case)
from repro_torch.kernels.frontier_pull import ops as fp_ops
from test_torch_engine import (DIRECTIONS, assert_same_result, both_datasets,
                               port_query)
from test_torch_engine import release_reference_executables  # noqa: F401

V = 48
LEAF, CHAIN = 37, 40
ROOTS = [0, LEAF, V - 1, -2, V + 3, CHAIN, 0]
MAX_DEPTH = 8
ENGINES = ("precursive", "bitmap", "hybrid", "diropt", "diropt_hybrid")
BRANCHING = ("hybrid", "diropt", "diropt_hybrid")


def graph_columns():
    """The star, its fan-in onto 25..30, the chain 40 -> ... -> 47, a leaf
    37 and 30 random edges among the first 37 vertices, in shuffled
    order."""
    rng = np.random.default_rng(21)
    star = [(0, i) for i in range(1, 25)]
    fan = [(i, 25 + i % 6) for i in range(1, 25)]
    chain = [(i, i + 1) for i in range(CHAIN, V - 1)]
    rand = zip(rng.integers(0, LEAF, 30).tolist(),
               rng.integers(0, CHAIN, 30).tolist())
    rand = [(a, b) for a, b in rand] + [(36, LEAF), (30, LEAF)]
    edges = np.array(star + fan + chain + rand, np.int32)
    edges = edges[rng.permutation(len(edges))]
    e = len(edges)
    return {"id": np.arange(e, dtype=np.int32),
            "from": edges[:, 0].copy(), "to": edges[:, 1].copy(),
            "name": rng.standard_normal((e, 4)).astype(np.float32)}


@pytest.fixture(scope="module")
def data():
    return both_datasets(graph_columns(), V)


E = len(graph_columns()["id"])


def query(engine, direction, caps=None):
    return RecursiveQuery(engine, MAX_DEPTH, 0,
                          EngineCaps(*(caps or (E + 16, 4 * E + 16))),
                          direction=direction)


@pytest.fixture(scope="module")
def ref_batch(data):
    """The reference's batch of one (engine, direction, caps, roots),
    computed once per module."""
    ref, _ = data
    cache = {}

    def get(engine, direction, caps=None, roots=tuple(ROOTS)):
        key = (engine, direction, caps, roots)
        if key not in cache:
            cache[key] = ref_run_query_batch(query(engine, direction, caps),
                                             ref, list(roots))
        return cache[key]
    return get


def port_batch(ds, engine, direction, caps=None, roots=ROOTS):
    return port.run_query_batch(port_query(query(engine, direction, caps)),
                                ds, roots)


def assert_lanes(got, want, ds, q, roots):
    """Each lane equal to the reference's lane and to the port's single
    run of its root."""
    for i, root in enumerate(roots):
        lane = port.result_lane(got, i)
        assert_same_result(lane, ref_result_lane(want, i))
        one = port.run_query(port_query(q), ds, root)
        for field in ("positions", "count", "depth", "overflow",
                      "row_depths", "level_dirs"):
            a, b = getattr(lane, field), getattr(one, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), (root, field)
        for k in one.values:
            assert torch.equal(lane.values[k], one.values[k]), (root, k)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("engine", ENGINES)
def test_batch_lanes_match_reference_and_single_root(data, ref_batch,
                                                     engine, direction):
    _, ds = data
    got = port_batch(ds, engine, direction)
    assert got.positions.shape[0] == len(ROOTS)
    assert_lanes(got, ref_batch(engine, direction), ds,
                 query(engine, direction), ROOTS)


def test_lanes_converge_at_different_depths(data, ref_batch):
    """The chain's lane runs longer than the star's, and the leaf's stops
    at once: the driver retires lanes one group at a time."""
    _, ds = data
    for engine in ENGINES:
        depths = port_batch(ds, engine, "outbound").depth.tolist()
        assert depths[ROOTS.index(CHAIN)] > depths[0] > \
            depths[ROOTS.index(LEAF)], (engine, depths)
        want = np.asarray(ref_batch(engine, "outbound").depth)
        assert depths == want.tolist()


def lanes_disagree(r, engine) -> bool:
    """Some level that two lanes both executed saw them take different
    branches: push and pull in ``level_dirs``, or for ``hybrid`` a frontier
    block (the rows first emitted at the level) below and one at or above
    the sparse threshold."""
    depth, count = r.depth.tolist(), r.count.tolist()
    for d in range(MAX_DEPTH + 1):
        alive = [i for i in range(len(depth)) if depth[i] > d]
        if engine == "hybrid":
            threshold = max(1, int(V * 0.05))
            widths = {int((r.row_depths[i][:count[i]] == d).sum())
                      for i in alive}
            if {w < threshold for w in widths - {0}} == {True, False}:
                return True
        elif len({int(r.level_dirs[i, d]) for i in alive}) > 1:
            return True
    return False


@pytest.mark.parametrize("engine", BRANCHING)
def test_lanes_take_different_branches_on_one_level(data, engine):
    """The star's and the chain's lanes take different sides of the
    engine's branch on one level in at least one direction, which the
    test above then held against the reference."""
    _, ds = data
    assert any(lanes_disagree(port_batch(ds, engine, d), engine)
               for d in DIRECTIONS), engine


@pytest.mark.parametrize("engine", ENGINES)
def test_only_one_lane_overflows(data, ref_batch, engine):
    """Caps that only the star's lane exceeds (its 24-edge first level and
    its 78 rows): that lane overflows alone, the others are whole."""
    _, ds = data
    roots, caps = (0, LEAF, CHAIN, V - 1), (16, 40)
    got = port_batch(ds, engine, "outbound", caps, list(roots))
    assert got.overflow.tolist() == [True, False, False, False]
    assert_lanes(got, ref_batch(engine, "outbound", caps, roots), ds,
                 query(engine, "outbound", caps), roots)


def test_result_lane_slices_every_field(data):
    _, ds = data
    r = port_batch(ds, "diropt", "outbound")
    lane = port.result_lane(r, 5)
    assert lane.positions.shape == r.positions.shape[1:]
    assert lane.count.dim() == 0 and lane.depth.dim() == 0
    assert torch.equal(lane.level_dirs, r.level_dirs[5])
    assert lane.values.keys() == r.values.keys()
    assert torch.equal(lane.values["name"], r.values["name"][5])
    assert lane.vertex_values is None


@pytest.mark.parametrize("engine", ["precursive", "diropt"])
def test_no_roots_matches_reference(data, ref_batch, engine):
    """An empty batch: every field with a lane axis of 0, as in the
    reference."""
    _, ds = data
    got = port_batch(ds, engine, "outbound", roots=[])
    want = ref_batch(engine, "outbound", roots=())
    for field in ("positions", "count", "depth", "overflow", "row_depths",
                  "level_dirs"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert tuple(a.shape) == tuple(np.asarray(b).shape), field
            assert a.dtype == getattr(torch, str(np.asarray(b).dtype))
    for k, v in want.values.items():
        assert tuple(got.values[k].shape) == tuple(np.asarray(v).shape)


def test_weighted_batch_raises_not_implemented(data):
    """A weighted query names the slice that brings it; an engine with no
    value plane raises ValueError first, as ``run_query`` does."""
    _, ds = data
    for engine in ("precursive", "bitmap"):
        q = port.RecursiveQuery(engine, 4, 0, port.EngineCaps(64, 256),
                                workload="shortest_path", weight_col="name")
        with pytest.raises(NotImplementedError,
                           match="batched roots, weighted"):
            port.run_query_batch(q, ds, [0, 1])
    bad = port.RecursiveQuery("diropt", 4, 0, port.EngineCaps(64, 256),
                              workload="shortest_path", weight_col="name")
    with pytest.raises(ValueError, match="value plane"):
        port.run_query_batch(bad, ds, [0, 1])


def test_kernel_plugged_batch_runs_plain_on_cpu(data):
    """With the kernel wrappers plugged in, a CPU batch runs their plain
    versions: the same lanes, and no launch counted."""
    _, ds = data
    ds.ensure_pull_layout("outbound")
    for engine in ("precursive", "diropt_hybrid"):
        q = port_query(query(engine, "outbound"))
        plain = port.run_query_batch(q, ds, ROOTS)
        plan = port.build_plan(q, expand_fn=frontier_expand_fused,
                               pull_fn=frontier_pull_fused)
        before = (fe_ops.LAUNCHES, fp_ops.LAUNCHES)
        got = port.execute_batch(plan, port.query_context(q, ds), ROOTS, V)
        assert (fe_ops.LAUNCHES, fp_ops.LAUNCHES) == before
        for field in ("positions", "count", "depth", "row_depths"):
            assert torch.equal(getattr(got, field), getattr(plain, field))


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_batched_expand_ref_matches_single_lanes(case):
    """The plain expansion over (4, F) lanes equals it on each lane alone:
    positions, count and overflow."""
    src, v, targets, valid, capacity = expand_lanes_case(case)
    csr = build_csr(torch.from_numpy(src), v)
    t, m = torch.from_numpy(targets.copy()), torch.from_numpy(valid.copy())
    got = frontier_expand_ref(csr, t, m, capacity)
    assert got[0].shape == (4, capacity) and got[1].shape == (4,)
    for i in range(4):
        want = frontier_expand_ref(csr, t[i].contiguous(), m[i].contiguous(),
                                   capacity)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g[i], w), (case, i)
    assert int(got[1][1]) == 0 and not bool(got[2][1])   # the empty lane


@pytest.mark.parametrize("case", PULL_CASES)
def test_batched_pull_refs_match_single_lanes(case):
    """Both plain pulls over (4, V) planes equal the per-entry pull on each
    lane alone."""
    src, dst, frontier, visited = (torch.from_numpy(a.copy())
                                   for a in pull_lanes_case(case))
    nv = frontier.shape[-1]
    rcsr = build_csr(dst, nv)
    layout = build_pull_layout(rcsr, src, dst, nv)
    got = frontier_pull_ref(rcsr, src, dst, frontier, visited)
    by_layout = frontier_pull_layout_ref(layout, frontier, visited)
    for i in range(4):
        want = frontier_pull_ref(rcsr, src, dst, frontier[i], visited[i])
        assert torch.equal(got[i], want) and torch.equal(by_layout[i], want)
    assert not got[1].any()                               # empty frontier


@pytest.mark.parametrize("shape", [(5, 1000), (3, 1), (0, 7), (4, 0), (9,)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32])
def test_lane_cumsum_matches_each_row(shape, dtype):
    """The one flat scan less each lane's prefix equals the int32 cumsum
    of each row on its own."""
    rng = np.random.default_rng(len(shape) * 10 + sum(shape))
    x = torch.from_numpy(rng.integers(0, 300, shape).astype(np.int32))
    x = (x % 2 == 1) if dtype == torch.bool else x
    got = lane_cumsum(x)
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert torch.equal(got, torch.cumsum(x, -1, dtype=torch.int32))
