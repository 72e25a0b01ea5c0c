"""MS-BFS (the bit-parallel ``multiquery`` engine): the port's
``run_query_multi`` against the JAX reference's, on the CPU.

Every case holds the port's batch against the reference's batch on every
field, bit for bit (positions with their sentinel padding, count, depth,
overflow, row depths, every value column, and ``level_dirs`` /
``vertex_values`` both None), and each lane against the port's own
``run_query`` of ``diropt`` on that root (the deferred-emission engine
whose compact layout MS-BFS shares): positions, count, depth, overflow,
row depths and values.  Nothing here does float arithmetic, so the
tolerance is 0.

Cases: the reference's seeded ``_random_case`` graphs in every direction;
on a 3,000-vertex tree a partial word (5 lanes) with a hub lane beside leaf
lanes, a full word (32 lanes), per-lane depth caps, per-lane overflow under
a tiny result cap, and roots -2 and V + 3 (clipped).  The word sweep's
``_segment_or`` is held against the reference's segmented scan directly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bitmap as ref_bitmap
from repro.core import operators as ref_ops
from repro.core.engine import (ENGINE_NAMES, PLAN_BUILDERS, Dataset,
                               EngineCaps, RecursiveQuery, build_plan,
                               plan_repr, run_query, run_query_multi)
from repro_torch.core import bitmap as port_bitmap
from repro_torch.core import engine as port
from repro_torch.core import operators as port_ops
from repro_torch.core.operators import WORD_LANES
from repro_torch.data.treegen import TreeSpec, bfs_reference, make_edge_table
from test_multiquery import _random_case
from test_torch_engine import (DIRECTIONS, assert_same_result,
                               both_datasets, port_query)
from test_torch_engine import release_reference_executables  # noqa: F401

SEEDS = (3, 7, 21, 48, 5, 11, 30)



def mq_query(depth, caps, direction, lanes=1):
    return RecursiveQuery("multiquery", depth, 0, caps, direction=direction,
                          lanes=lanes)


def port_mq(q: RecursiveQuery) -> port.RecursiveQuery:
    return port.RecursiveQuery(q.engine, q.max_depth, q.payload_cols,
                               port.EngineCaps(*q.caps), q.dedup,
                               q.direction, lanes=q.lanes)


def carried(ref: Dataset, num_vertices: int):
    """The port's CPU dataset over the reference dataset's own columns."""
    from repro_torch.convert import dataset_from_numpy
    cols = {k: np.asarray(v) for k, v in ref.table.columns.items()}
    return dataset_from_numpy(cols, num_vertices, "cpu")


def assert_multi(got, want):
    """Port batch == reference batch on every field."""
    assert_same_result(got, want)
    assert got.vertex_values is None and want.vertex_values is None
    assert got.level_dirs is None and want.level_dirs is None


def assert_lanes_equal_diropt(got, ds, q, roots, lane_limits=None):
    """Lane i == the port's ``run_query(diropt)`` on roots[i] (at the
    lane's depth cap, if any)."""
    for i, root in enumerate(roots):
        depth = q.max_depth if lane_limits is None else int(lane_limits[i])
        dq = port.RecursiveQuery("diropt", depth, q.payload_cols,
                                 port.EngineCaps(*q.caps),
                                 direction=q.direction)
        one = port.run_query(dq, ds, int(root))
        lane = port.result_lane(got, i)
        for field in ("positions", "count", "depth", "overflow",
                      "row_depths"):
            a, b = getattr(lane, field), getattr(one, field)
            assert a.dtype == b.dtype and torch.equal(a, b), (i, root, field)
        assert sorted(lane.values) == sorted(one.values)
        for k in one.values:
            assert torch.equal(lane.values[k], one.values[k]), (i, root, k)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_cases_match_reference(seed):
    """The reference's seeded graphs, every direction: the port's batch
    equals the reference's, and each lane the port's diropt."""
    ref, roots, depth, e = _random_case(seed)
    ds = carried(ref, ref.num_vertices)
    caps = EngineCaps(frontier=e + 16, result=e + 16)
    for direction in DIRECTIONS:
        q = mq_query(depth, caps, direction)
        got = port.run_query_multi(port_mq(q), ds, roots)
        assert_multi(got, run_query_multi(q, ref, roots))
        assert_lanes_equal_diropt(got, ds, q, roots)


@pytest.fixture(scope="module")
def tree():
    """The reference suite's small tree (3,000 vertices, height 10), its
    leaves (targets of the deepest level) and a depth-2 vertex."""
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=4, seed=11)
    cols = make_edge_table(spec)
    ref, ds = both_datasets(cols, spec.num_vertices)
    levels = bfs_reference(cols["from"], cols["to"], 0, 10,
                           spec.num_vertices)
    deepest = [lv for lv in levels if lv][-1]
    leaves = sorted({int(cols["to"][i]) for i in deepest})[:3]
    mid = int(cols["to"][min(levels[1])])
    return ref, ds, cols, leaves, mid


def tree_caps(cols, result=None):
    e = cols["id"].shape[0]
    return EngineCaps(frontier=e + 8, result=e + 8 if result is None
                      else result)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_partial_word_and_mixed_convergence(tree, direction):
    """5 roots in a 32-lane word: the hub lane (root 0) still sweeping
    while the leaf lanes froze at once; freezing must not touch the other
    lanes' bits."""
    ref, ds, cols, leaves, mid = tree
    roots = np.asarray([0, *leaves, mid], np.int32)
    q = mq_query(6, tree_caps(cols), direction, lanes=5)
    got = port.run_query_multi(port_mq(q), ds, roots)
    assert got.count.shape == (5,)
    assert_multi(got, run_query_multi(q, ref, roots))
    assert_lanes_equal_diropt(got, ds, q, roots)
    if direction == "outbound":
        assert int(got.count[0]) > 0
        assert got.count[1:4].tolist() == [0, 0, 0]


def test_full_word(tree):
    """32 lanes, the sign bit of an int32 word among them: lane 31 must
    propagate like lane 0."""
    ref, ds, cols, leaves, mid = tree
    rng = np.random.default_rng(4)
    roots = np.asarray([0, mid, *leaves,
                        *rng.integers(0, 3000, 27)], np.int32)
    roots[31] = 0                     # the sign-bit lane runs the hub too
    assert len(roots) == WORD_LANES
    q = mq_query(10, tree_caps(cols), "outbound", lanes=WORD_LANES)
    got = port.run_query_multi(port_mq(q), ds, roots)
    assert_multi(got, run_query_multi(q, ref, roots))
    assert_lanes_equal_diropt(got, ds, q, roots)
    assert int(got.count[31]) == int(got.count[0]) == cols["id"].shape[0]


def test_per_lane_depth_caps(tree):
    """A lane capped at depth d equals diropt with ``max_depth=d``; its
    neighbors are unaffected.  A cap above the query's depth clamps to it,
    and a negative cap leaves the lane out from the start."""
    ref, ds, cols, leaves, mid = tree
    roots = np.asarray([0, 0, 1, 0, mid], np.int32)
    limits = np.asarray([2, 5, 5, 9, 0], np.int32)
    q = mq_query(5, tree_caps(cols), "outbound", lanes=5)
    got = port.run_query_multi(port_mq(q), ds, roots, limits)
    assert_multi(got, run_query_multi(q, ref, roots, limits))
    assert_lanes_equal_diropt(got, ds, q, roots, np.minimum(limits, 5))
    neg = np.asarray([-1, 3], np.int32)
    q2 = mq_query(5, tree_caps(cols), "outbound", lanes=2)
    got = port.run_query_multi(port_mq(q2), ds, roots[:2], neg)
    assert_multi(got, run_query_multi(q2, ref, roots[:2], neg))
    assert got.depth.tolist()[0] == 0 and int(got.count[0]) == 0


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_per_lane_overflow_flags(tree, direction):
    """Overflow is per lane: a tiny result cap truncates the lane that
    reaches far (root 0 outbound, a leaf inbound, up its path of 10 edges)
    and flags it alone (both ways every root reaches the whole tree)."""
    ref, ds, cols, leaves, mid = tree
    far, near = (leaves[0], 0) if direction == "inbound" else (0, leaves[0])
    roots = np.asarray([far, near], np.int32)
    q = mq_query(10, tree_caps(cols, result=4), direction, lanes=2)
    got = port.run_query_multi(port_mq(q), ds, roots)
    assert_multi(got, run_query_multi(q, ref, roots))
    assert_lanes_equal_diropt(got, ds, q, roots)
    assert got.overflow.tolist() == [True, direction == "both"]


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_clipped_and_colliding_roots(tree, direction):
    """Roots -2 and V + 3 clip to 0 and V - 1, as run_query clips them;
    colliding roots are distinct bits of one vertex's word."""
    ref, ds, cols, leaves, mid = tree
    roots = [-2, 3003, 0, 2999, mid, mid]
    q = mq_query(10, tree_caps(cols), direction, lanes=len(roots))
    got = port.run_query_multi(port_mq(q), ds, roots)
    assert_multi(got, run_query_multi(q, ref, np.asarray(roots, np.int32)))
    assert_lanes_equal_diropt(got, ds, q, roots)


@pytest.mark.parametrize("case", range(6))
def test_segment_or_matches_reference_scan(case):
    """The bit-plane segment-OR against the reference's segmented scan:
    words with the top bit set, empty segments (a trailing one too),
    words past the last segment, and no words at all."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(case)
    num_seg = int(rng.integers(1, 40))
    e = 0 if case == 5 else int(rng.integers(1, 200))
    lens = rng.multinomial(e, rng.dirichlet(np.ones(num_seg)))
    lens[-1] = 0 if case % 2 else lens[-1]
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    words = rng.integers(0, 1 << 32, e, dtype=np.uint64)
    words[::3] |= np.uint64(1 << 31)
    want = np.asarray(jax.jit(ref_ops._segment_or, static_argnums=2)(
        jnp.asarray(words.astype(np.uint32)), jnp.asarray(indptr), num_seg))
    got = port_ops._segment_or(torch.from_numpy(words.astype(np.int64)),
                               torch.from_numpy(indptr), num_seg)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    lanes = 7
    masked = words & np.uint64((1 << lanes) - 1)
    got7 = port_ops._segment_or(torch.from_numpy(masked.astype(np.int64)),
                                torch.from_numpy(indptr), num_seg, lanes)
    np.testing.assert_array_equal(
        got7.numpy(), want.astype(np.int64) & ((1 << lanes) - 1))


def test_errors_raise_as_in_reference(tree):
    """33 roots, ``lanes`` outside 1..32, a missing reverse CSR and the
    scalar driver all raise the reference's exception types."""
    ref, ds, cols, leaves, mid = tree
    caps = tree_caps(cols)
    q = mq_query(3, caps, "outbound")
    roots33 = np.zeros(33, np.int32)
    for run, pq, d in ((run_query_multi, q, ref),
                       (port.run_query_multi, port_mq(q), ds)):
        with pytest.raises(ValueError, match="at most 32"):
            run(pq, d, roots33)
    cols_out = ("id", "from", "to", "name")
    for lanes in (0, 33, -1):
        with pytest.raises(ValueError, match="lanes must be in"):
            ref_bitmap.multiquery_plan(caps, 3, cols_out, lanes=lanes)
        with pytest.raises(ValueError, match="lanes must be in"):
            port_bitmap.multiquery_plan(port.EngineCaps(*caps), 3, cols_out,
                                        lanes=lanes)
    with pytest.raises(ValueError, match="lanes must be in"):
        build_plan(mq_query(3, caps, "outbound", lanes=33))
    with pytest.raises(ValueError, match="lanes must be in"):
        port.build_plan(port_mq(mq_query(3, caps, "outbound", lanes=33)))
    with pytest.raises(ValueError):
        ref_bitmap.multiquery_plan(caps, 3, cols_out, direction="up")
    with pytest.raises(ValueError):
        port_bitmap.multiquery_plan(port.EngineCaps(*caps), 3, cols_out,
                                    direction="up")
    # a dataset whose reverse CSR was never built
    fresh_ref, fresh = both_datasets(cols, 3000)
    plan = ref_bitmap.multiquery_plan(caps, 3, cols_out, lanes=2)
    with pytest.raises(ValueError, match="reverse CSR"):
        ref_ops.execute_multiquery(plan, fresh_ref.context("outbound"),
                                   np.asarray([0, 1], np.int32), 3000)
    pplan = port_bitmap.multiquery_plan(port.EngineCaps(*caps), 3, cols_out,
                                        lanes=2)
    with pytest.raises(ValueError, match="reverse CSR"):
        port_ops.execute_multiquery(pplan, fresh.context("outbound"),
                                    [0, 1], 3000)
    # the scalar driver cannot finish a multiquery plan, in either package
    with pytest.raises(NotImplementedError):
        run_query(q, ref, 0)
    with pytest.raises(NotImplementedError):
        port.run_query(port_mq(q), ds, 0)
    # no value plane: a weighted multiquery query is refused at build time
    wq = port.RecursiveQuery("multiquery", 3, 0, port.EngineCaps(*caps),
                             workload="shortest_path", weight_col="w")
    with pytest.raises(ValueError, match="no value plane"):
        port.run_query_multi(wq, ds, [0])


@pytest.mark.parametrize("lanes", [1, 5, 32])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_plan_and_describe_match_reference(direction, lanes):
    """``plan_repr`` of ``multiquery`` and each operator's ``describe()``
    render what the reference renders; the engine is a builder but not
    one of ``ENGINE_NAMES``."""
    for depth, payload, root in ((16, 8, 0), (3, 0, 41)):
        assert port.plan_repr("multiquery", depth, payload, root) == \
            plan_repr("multiquery", depth, payload, root)
    caps, cols = EngineCaps(8, 8), ("id", "from", "to", "name")
    want = ref_bitmap.multiquery_plan(caps, 6, cols, direction, lanes)
    got = port_bitmap.multiquery_plan(port.EngineCaps(8, 8), 6, cols,
                                      direction, lanes)
    assert got.render(3) == want.render(3)
    assert got.seed.describe() == want.seed.describe()
    assert got.ops[0].describe() == want.ops[0].describe()
    assert got.finisher.describe() == want.finisher.describe()
    assert (got.name, got.rep, got.inclusive, got.tracks_vertex_depth,
            got.carries_positions) == \
        (want.name, want.rep, want.inclusive, want.tracks_vertex_depth,
         want.carries_positions)
    assert port.MULTIQUERY_ENGINE == "multiquery"
    assert port.MULTIQUERY_ENGINE in port._PLAN_BUILDERS
    assert port.MULTIQUERY_ENGINE in PLAN_BUILDERS
    assert port.MULTIQUERY_ENGINE not in port.ENGINE_NAMES
    assert port.ENGINE_NAMES == ENGINE_NAMES
    assert port.WORD_LANES == WORD_LANES == 32
    assert port.positions_available("multiquery")


def test_query_of_another_engine_runs_as_multiquery(tree):
    """``run_query_multi`` runs the multiquery engine whatever ``q.engine``
    names, as the reference's does."""
    ref, ds, cols, leaves, mid = tree
    q = RecursiveQuery("precursive", 4, 0, tree_caps(cols))
    roots = [0, mid]
    assert_multi(port.run_query_multi(port_query(q), ds, roots),
                 run_query_multi(q, ref, np.asarray(roots, np.int32)))
