"""Batched roots for the weighted workloads and the paper's six value
engines: the port's ``run_query_batch`` against the reference's vmapped
``run_query_batch``, and each lane against the port's own ``run_query``.

Tolerances.  Every lane must equal the port's single-root run of its root
bit for bit, on every field (``vertex_values`` included): on the CPU each
lane scatters into its own row, in that lane's order.  Against the
reference the rule of ``tests/test_torch_semiring.py`` holds: integer
fields, value columns and the ``shortest_path`` / ``aggregate_max`` /
``aggregate_min`` planes exact, ``aggregate_sum`` and ``aggregate_mul``
planes within rtol 1e-5 and atol 1e-6 (the two packages' scatters add in
another order), with the same non-finite entries.  The value engines
gather values only, so their tolerance is 0.

The weighted graph (V = 24) is a random multigraph on 0..17 (in-degree
above 1), a chain 18 -> 22 and an isolated vertex 23, so the lanes of one
batch converge at different depths: root 0 keeps improving where the chain
lane walks one vertex a level and the leaf lane dies at once.  Roots -2
and V + 3 are clipped as ``run_query`` clips them.  The value engines run
over the golden tree of ``tests/test_operators.py`` and its roots.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import EngineCaps, RecursiveQuery
from repro.core.engine import result_lane as ref_result_lane
from repro.core.engine import run_query_batch as ref_run_query_batch
from repro.data.treegen import TreeSpec, make_edge_table
from repro_torch.core import engine as port
from repro_torch.core.operators import execute, execute_batch
from repro_torch.kernels.spmm_segment import (SPMM_CASES,
                                              spmm_segment_lanes_ref,
                                              spmm_segment_ref,
                                              spmm_tile_case)
from repro_torch.kernels.spmm_segment import ops as spmm_ops
from test_torch_engine import assert_same_result, both_datasets
from test_torch_engine import release_reference_executables  # noqa: F401
from test_torch_semiring import (SEMIRINGS, assert_same_weighted,
                                 both_weighted, port_query,
                                 weighted_columns)

V = 24
LEAF, CHAIN = 23, 18
ROOTS = [0, LEAF, CHAIN, -2, V + 3, 5, 0]
DEPTH = 6
WEIGHTED_CELLS = ([("precursive", d) for d in ("outbound", "inbound",
                                               "both")]
                  + [("bitmap", d) for d in ("outbound", "inbound")])
# the golden tree of tests/test_operators.py and its batch roots
GOLDEN_SPEC = TreeSpec(num_vertices=3000, height=10, payload_cols=4,
                       seed=11)
GOLDEN_ROOTS = [0, 1, 2, 5, 17, 100, 2000, 2999]
GOLDEN_CAPS = (2048, 4096)
VALUE_CELLS = ([(e, d) for e in ("trecursive", "trecursive_rewrite")
                for d in ("outbound", "inbound", "both")]
               + [(e, "outbound") for e in ("rowstore", "rowstore_index",
                                            "rowstore_rewrite",
                                            "rowstore_index_rewrite")])
FIELDS = ("positions", "count", "depth", "overflow", "row_depths",
          "level_dirs", "vertex_values")


def weighted_graph():
    rng = np.random.default_rng(25)
    e = 50
    src = rng.integers(0, CHAIN, e).tolist() + list(range(CHAIN, LEAF - 1))
    dst = rng.integers(0, CHAIN, e).tolist() + list(range(CHAIN + 1, LEAF))
    order = rng.permutation(len(src))
    w = rng.uniform(0.5, 2.0, len(src))
    return weighted_columns(np.asarray(src)[order], np.asarray(dst)[order],
                            w[order], seed=25)


@pytest.fixture(scope="module")
def weighted():
    return both_weighted(weighted_graph(), V)


@pytest.fixture(scope="module")
def golden():
    cols = {k: np.asarray(v)
            for k, v in make_edge_table(GOLDEN_SPEC).columns.items()}
    return both_datasets(cols, GOLDEN_SPEC.num_vertices)


def weighted_query(engine, workload, direction, caps=None):
    e = len(weighted_graph()["id"])
    return RecursiveQuery(engine, DEPTH, 0,
                          EngineCaps(*(caps or (e + 16, 8 * e + 16))),
                          dedup=False, direction=direction,
                          workload=workload, weight_col="w")


def value_query(engine, direction, caps=GOLDEN_CAPS):
    return RecursiveQuery(engine, 4, 4, EngineCaps(*caps),
                          direction=direction)


def assert_lane_is_single_run(lane, one, label) -> None:
    """Bit-equal, field for field and column for column."""
    for field in FIELDS:
        a, b = getattr(lane, field), getattr(one, field)
        assert (a is None) == (b is None), (label, field)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), (label, field)
    assert lane.values.keys() == one.values.keys()
    for k in one.values:
        assert torch.equal(lane.values[k], one.values[k]), (label, k)


def assert_batch(got, want, ds, q, roots, workload="reach") -> None:
    """Each lane equal to the reference's lane under the module's rule
    and to the port's single run of its root bit for bit."""
    assert got.count.shape == (len(roots),)
    for i, root in enumerate(roots):
        lane = port.result_lane(got, i)
        if workload == "reach":
            assert_same_result(lane, ref_result_lane(want, i))
        else:
            assert_same_weighted(lane, ref_result_lane(want, i), workload)
        one = port.run_query(port_query(q), ds, root)
        assert_lane_is_single_run(lane, one, (q.engine, q.direction, root))


@pytest.mark.parametrize("workload", SEMIRINGS)
@pytest.mark.parametrize("engine,direction", WEIGHTED_CELLS,
                         ids=lambda x: x if isinstance(x, str) else None)
def test_weighted_batch_matches_reference(weighted, engine, direction,
                                          workload):
    """Weighted ``precursive`` in every direction and ``bitmap`` outbound
    and inbound, under every semiring: the lanes converge at different
    depths (shortest_path re-expands only improved vertices; the walk
    semirings stop at the depth cap or where a lane's frontier dies)."""
    ref, ds = weighted
    q = weighted_query(engine, workload, direction)
    got = port.run_query_batch(port_query(q), ds, ROOTS)
    assert_batch(got, ref_run_query_batch(q, ref, ROOTS), ds, q, ROOTS,
                 workload)
    if (engine, direction, workload) == ("precursive", "outbound",
                                         "shortest_path"):
        assert len(set(got.depth.tolist())) >= 3     # lanes retire apart


@pytest.mark.parametrize("engine,direction", VALUE_CELLS,
                         ids=lambda x: x if isinstance(x, str) else None)
def test_value_engine_batch_matches_reference(golden, engine, direction):
    """The six value engines, every direction ``build_plan`` allows, over
    the golden tree's roots of ``test_batch_matches_sequential``."""
    ref, ds = golden
    q = value_query(engine, direction)
    got = port.run_query_batch(port_query(q), ds, GOLDEN_ROOTS)
    assert_batch(got, ref_run_query_batch(q, ref, GOLDEN_ROOTS), ds, q,
                 GOLDEN_ROOTS)


@pytest.mark.parametrize("engine,direction,workload", [
    ("precursive", "outbound", "aggregate_sum"),
    ("bitmap", "inbound", "shortest_path"),
    ("trecursive", "outbound", "reach"),
    ("rowstore", "outbound", "reach")])
def test_one_lane_overflows(weighted, golden, engine, direction, workload):
    """A result cap that root 0's lane overflows and the other lanes do
    not: the per-lane flags the bucket executor evicts on, each lane equal
    to the reference and to its single-root run."""
    if workload == "reach":
        ref, ds = golden
        q = value_query(engine, direction, caps=(2048, 600))
        roots = GOLDEN_ROOTS
    else:
        ref, ds = weighted
        q = weighted_query(engine, workload, direction, caps=(80, 40))
        roots = ROOTS
    got = port.run_query_batch(port_query(q), ds, roots)
    assert_batch(got, ref_run_query_batch(q, ref, roots), ds, q, roots,
                 workload)
    over = got.overflow.tolist()
    assert over[0] and not all(over), over


@pytest.mark.parametrize("engine,workload", [
    ("precursive", "shortest_path"), ("bitmap", "aggregate_sum"),
    ("trecursive_rewrite", "reach"), ("rowstore_index", "reach")])
def test_empty_batch_matches_reference_shapes(weighted, golden, engine,
                                              workload):
    """``roots = []``: every field with a lane axis of 0, in the
    reference's shapes and dtypes."""
    ref, ds = golden if workload == "reach" else weighted
    q = (value_query(engine, "outbound") if workload == "reach"
         else weighted_query(engine, workload, "outbound"))
    got = port.run_query_batch(port_query(q), ds, [])
    want = ref_run_query_batch(q, ref, [])
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape, field
            assert a.dtype == getattr(torch, str(b.dtype)), field
    assert got.values.keys() == want.values.keys()
    for k, v in want.values.items():
        v = np.asarray(v)
        assert tuple(got.values[k].shape) == v.shape, k
        assert got.values[k].dtype == getattr(torch, str(v.dtype)), k


@pytest.mark.parametrize("direction", ("outbound", "inbound"))
def test_spmm_plugged_batch_runs_plain_on_cpu(weighted, direction):
    """The weighted ``bitmap`` plan with the ``spmm_segment`` wrapper
    plugged in: a CPU batch hands it every lane with its frontier bits,
    takes the lane-axis plain version, launches nothing, and each lane
    equals the single-root run of the same plan."""
    _, ds = weighted
    q = port_query(weighted_query("bitmap", "aggregate_sum", direction))
    plan = port.build_plan(q, spmm_fn=spmm_ops.spmm_segment_sorted)
    ctx = port.query_context(q, ds)
    before = spmm_ops.LAUNCHES
    got = execute_batch(plan, ctx, ROOTS, V)
    assert spmm_ops.LAUNCHES == before
    for i, root in enumerate(ROOTS):
        assert_lane_is_single_run(port.result_lane(got, i),
                                  execute(plan, ctx, root, V), root)
    plain = port.run_query_batch(q, ds, ROOTS)
    assert torch.equal(got.vertex_values, plain.vertex_values)


def test_batch_keeps_build_plan_errors(weighted, golden):
    """The row store stays outbound-only, the dense weighted step
    single-direction, and an engine with no value plane refuses a weighted
    workload, in a batch as in ``run_query``."""
    _, ds = golden
    for direction in ("inbound", "both"):
        with pytest.raises(ValueError, match="outbound-only"):
            port.run_query_batch(port_query(value_query(
                "rowstore_rewrite", direction)), ds, [0, 1])
    _, ds = weighted
    with pytest.raises(ValueError, match="single-direction"):
        port.run_query_batch(port_query(weighted_query(
            "bitmap", "shortest_path", "both")), ds, [0, 1])
    for engine in ("trecursive", "hybrid", "diropt"):
        with pytest.raises(ValueError, match="value plane"):
            port.run_query_batch(port_query(weighted_query(
                engine, "aggregate_max", "outbound")), ds, [0, 1])


@pytest.mark.parametrize("d", (1, 4, 17, 128))
@pytest.mark.parametrize("case", SPMM_CASES)
def test_spmm_lanes_ref_matches_one_lane(case, d):
    """The lane-axis plain version over three lanes of one tile case (each
    with its own x and source mask, the second masking every source off)
    equals the one-lane plain version on each lane with its masked sources
    padded to N; ``spmm_segment_sorted`` on CPU tensors takes it."""
    x, src, dst, w, n_out = (torch.from_numpy(np.asarray(a)) if
                             isinstance(a, np.ndarray) else a
                             for a in spmm_tile_case(case, d))
    n = x.shape[0]
    rng = np.random.default_rng(SPMM_CASES.index(case) + 100 * d)
    xs = torch.stack([x, -x, x * 2])
    mask = torch.from_numpy(rng.random((3, n)) < 0.6)
    mask[1] = False
    got = spmm_segment_lanes_ref(xs, src, dst, w, n_out, mask)
    assert got.shape == (3, n_out, d)
    for lane in range(3):
        live = mask[lane][src.clamp(0, n - 1).long()]
        want = spmm_segment_ref(xs[lane], torch.where(live, src, n), dst, w,
                                n_out)
        assert torch.equal(got[lane], want), lane
    assert not got[1].any()                               # the empty lane
    seg = spmm_ops.segments(dst, n_out)
    s_src, s_w = src[seg.order], w[seg.order]
    sorted_ = spmm_ops.spmm_segment_sorted(xs, s_src, seg.seg, s_w,
                                           seg.offsets, mask)
    assert torch.equal(sorted_, spmm_segment_lanes_ref(
        xs, s_src, seg.seg, s_w, n_out, mask))
    one = spmm_ops.spmm_segment_sorted(xs[:1], s_src, seg.seg, s_w,
                                       seg.offsets)
    assert torch.equal(one[0], spmm_ops.spmm_segment_sorted(
        x, s_src, seg.seg, s_w, seg.offsets))
    assert torch.equal(sorted_[2:], spmm_ops.spmm_segment_sorted(
        xs[2:], s_src, seg.seg, s_w, seg.offsets, mask[2:]))
    with pytest.raises(ValueError, match="mask"):
        spmm_ops.spmm_segment_sorted(x, s_src, seg.seg, s_w, seg.offsets,
                                     mask[0])
    assert spmm_segment_lanes_ref(xs[:0], src, dst, w, n_out).shape == \
        (0, n_out, d)
