"""The port's cost inputs (the operators' ``estimate()``, the cost model's
``pipeline_cost`` and the ``core/`` leftovers it reads) against the JAX
reference.

Tolerances: every operator's ``OpCost`` and ``DirectionSwitch.predict``
exactly equal on a seeded grid of ``CostEnv``s (the same float arithmetic
in the same order); ``pipeline_cost`` labels, rows, levels and per-level
directions exactly equal, its bytes and ``est_us`` within a relative
1e-12; column widths, selected tables, gathers, sorts, ``precursive_bfs``
and ``edge_view_bytes`` exactly equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import core as ref_core
from repro.core import bitmap as ref_bitmap
from repro.core import operators as ref_ops
from repro.core import recursive as ref_rec
from repro.core.engine import (ENGINE_NAMES, Dataset, EngineCaps,
                               RecursiveQuery, build_plan)
from repro.core.table import ColumnTable
from repro.data.treegen import TreeSpec, make_edge_table
from repro.planner import cost as ref_cost
from repro_torch import core as port_core
from repro_torch.convert import dataset_from_numpy
from repro_torch.core import bitmap as port_bitmap
from repro_torch.core import engine as port
from repro_torch.core import operators as port_ops
from repro_torch.core import recursive as port_rec
from repro_torch.core.table import ColumnTable as PortTable
from repro_torch.planner import cost as port_cost
from test_torch_engine import DIRECTIONS, assert_same_result, graph_columns
from test_torch_engine import release_reference_executables  # noqa: F401

GOLDEN = TreeSpec(num_vertices=3000, height=10, payload_cols=4, seed=11)
CAPS = EngineCaps(frontier=2048, result=4096)
WORKLOADS = ("reach", "shortest_path", "aggregate_sum")


def kernel_fn(*args, **kwargs):
    """A plugged kernel slot: pricing reads only whether one is there."""
    raise AssertionError("priced, never run")


# ---------------------------------------------------------------------------
# operator estimates
# ---------------------------------------------------------------------------

COLS = ("id", "from", "to", "name", "column1", "column2")


def operator_pairs():
    """(label, reference operator, port operator): every operator the port
    has, in each of its pricing branches.  The port's kernel slots that the
    reference lacks (``WeightedExpand``/``HybridStep``/``HybridPullStep``
    ``expand_fn``) price as the reference's kernel-free operator."""
    pairs = []

    def add(label, make_ref, make_port):
        pairs.append((label, make_ref(ref_ops), make_port(port_ops)))

    def same(label, make):
        add(label, make, make)

    for kind, scan in (("edges", "columnar"), ("dense", "columnar"),
                       ("edges", "rows")):
        same(f"Seed[{kind},{scan}]",
             lambda m, k=kind, s=scan: m.Seed(kind=k, scan=s))
    for src in ("pos", "vals", "rows"):
        same(f"ReadTargets[{src}]", lambda m, s=src: m.ReadTargets(s))
    same("VisitedDedup", lambda m: m.VisitedDedup())
    same("CSRIndexJoin", lambda m: m.CSRIndexJoin())
    same("CSRIndexJoin+kernel",
         lambda m: m.CSRIndexJoin(expand_fn=kernel_fn))
    same("ScanHashJoin", lambda m: m.ScanHashJoin())
    add("WeightedExpand",
        lambda m: m.WeightedExpand(semiring="aggregate_sum"),
        lambda m: m.WeightedExpand(semiring="aggregate_sum",
                                   expand_fn=kernel_fn))
    for use in (False, True):
        add(f"WeightedDenseStep[{use}]",
            lambda m, u=use: m.WeightedDenseStep(semiring="aggregate_sum",
                                                 use_kernel=u),
            lambda m, u=use: m.WeightedDenseStep(
                semiring="aggregate_sum", spmm_fn=kernel_fn if u else None))
    for deferred in (False, True):
        same(f"DenseBitmapStep[{deferred}]",
             lambda m, d=deferred: m.DenseBitmapStep(deferred=d))
        for fn in (None, kernel_fn):
            same(f"PullStep[{deferred},{fn is not None}]",
                 lambda m, d=deferred, f=fn: m.PullStep(deferred=d,
                                                        expand_fn=f))
    for frac in (0.05, 0.5):
        add(f"HybridStep[{frac}]", lambda m, f=frac: m.HybridStep(f),
            lambda m, f=frac: m.HybridStep(f, expand_fn=kernel_fn))
    add("HybridPullStep", lambda m: m.HybridPullStep(),
        lambda m: m.HybridPullStep(expand_fn=kernel_fn))
    for alpha, beta in ((1.0, 64.0), (0.25, 8.0)):
        for fn in (None, kernel_fn):
            same(f"DirectionSwitch[{alpha},{fn is not None}]",
                 lambda m, a=alpha, b=beta, f=fn: m.DirectionSwitch(
                     push=m.DenseBitmapStep(deferred=True),
                     pull=m.PullStep(deferred=True, expand_fn=f),
                     alpha=a, beta=b))
        add(f"DirectionSwitch[hybrid,{alpha}]",
            lambda m, a=alpha, b=beta: m.DirectionSwitch(
                push=m.HybridStep(), pull=m.HybridPullStep(), alpha=a,
                beta=b),
            lambda m, a=alpha, b=beta: m.DirectionSwitch(
                push=m.HybridStep(expand_fn=kernel_fn),
                pull=m.HybridPullStep(expand_fn=kernel_fn), alpha=a,
                beta=b))
    for rows, nxt in ((False, False), (False, True), (True, False)):
        same(f"EarlyMaterialize[{rows},{nxt}]",
             lambda m, r=rows, n=nxt: m.EarlyMaterialize(
                 cols=COLS + ("__next__",), rows=r, with_next=n))
    for rep in ("pos", "vals", "rows"):
        same(f"AppendUnionAll[{rep}]",
             lambda m, r=rep: m.AppendUnionAll(rep=r, cols=COLS))
    same("LateMaterialize", lambda m: m.LateMaterialize(COLS))
    same("EmitTuples", lambda m: m.EmitTuples(COLS))
    same("ProjectRows", lambda m: m.ProjectRows(COLS))
    same("CompactEmitted", lambda m: m.CompactEmitted(COLS))
    same("DeferredEmit", lambda m: m.DeferredEmit(COLS))
    for use_rows in (False, True):
        same(f"TopLevelJoin[{use_rows}]",
             lambda m, u=use_rows: m.TopLevelJoin(
                 COLS, inner=m.EmitTuples(("id", "to")), use_rows=u))
    for lanes in (1, 8, 32):
        same(f"MultiQuerySeed[{lanes}]",
             lambda m, n=lanes: m.MultiQuerySeed(lanes=n))
        same(f"MultiQueryWordSweep[{lanes}]",
             lambda m, n=lanes: m.MultiQueryWordSweep(lanes=n))
        same(f"MultiQueryEmit[{lanes}]",
             lambda m, n=lanes: m.MultiQueryEmit(COLS, lanes=n))
    return pairs


OPERATORS = operator_pairs()


def env_grid(seed: int = 0, n: int = 24) -> list[dict]:
    """Seeded CostEnv fields: sparse and dense frontiers, kernel factors 0,
    1 and random, and visited counts on either side of the direction
    switch's crossover (few vertices left unvisited, or most)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        v = int(rng.integers(1, 1 << 20))
        e = int(rng.integers(0, 4 * v))
        f = float(rng.uniform(1, v))
        out.append(dict(
            frontier_rows=f, unique_rows=float(rng.uniform(0, f)),
            emitted_rows=float(rng.uniform(0, e + 1)), num_vertices=v,
            num_edges=e, frontier_cap=int(rng.integers(1, 1 << 18)),
            result_cap=int(rng.integers(1, 1 << 20)),
            row_bytes=int(rng.integers(8, 200)),
            col_bytes={"id": 4, "from": 4, "to": 4, "name": 16,
                       "column1": 2, "column2": 4},
            kernel_factor=(0.0, 1.0, float(rng.uniform(0, 50)))[i % 3],
            visited_rows=(float(v) - float(rng.uniform(0, 2)) if i % 2
                          else float(rng.uniform(0, v / 64)))))
    # the crossover itself: m_f against m_u = unvisited * avg degree
    out.append(dict(out[0], emitted_rows=0.0, frontier_rows=0.0))
    out.append(dict(out[1], num_vertices=0, num_edges=0, frontier_rows=0.0,
                    visited_rows=0.0))
    return out


ENVS = env_grid()


@pytest.mark.parametrize("label,ref_op,port_op", OPERATORS,
                         ids=[p[0] for p in OPERATORS])
def test_operator_estimate_matches_reference(label, ref_op, port_op):
    assert port_op.describe() == ref_op.describe()
    for fields in ENVS:
        want = ref_op.estimate(ref_ops.CostEnv(**fields))
        got = port_op.estimate(port_ops.CostEnv(**fields))
        assert type(got).__name__ == "OpCost"
        assert tuple(got) == tuple(want), fields
    if hasattr(ref_op, "predict"):
        for fields in ENVS:
            assert (port_op.predict(port_ops.CostEnv(**fields))
                    == ref_op.predict(ref_ops.CostEnv(**fields)))


def test_direction_switch_predicts_both_branches():
    op = port_ops.DirectionSwitch(push=port_ops.DenseBitmapStep(True),
                                  pull=port_ops.PullStep(True))
    seen = {op.predict(port_ops.CostEnv(**f)) for f in ENVS}
    assert seen == {"push", "pull"}


def test_base_operator_estimate_and_cols_bytes():
    env = dict(ENVS[0], col_bytes={"id": 4, "name": 16})
    for m in (ref_ops, port_ops):
        assert tuple(m.Operator().estimate(m.CostEnv(**env))) == (
            env["frontier_rows"], 0.0)
    assert (port_ops._cols_bytes(port_ops.CostEnv(**env),
                                 ("id", "name", "__next__"))
            == ref_ops._cols_bytes(ref_ops.CostEnv(**env),
                                   ("id", "name", "__next__")) == 24.0)


# ---------------------------------------------------------------------------
# pipeline_cost of every engine's plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    cols = {k: np.asarray(v) for k, v in
            make_edge_table(GOLDEN).columns.items()}
    cols["w"] = np.random.default_rng(3).uniform(
        0.5, 2.0, GOLDEN.num_edges).astype(np.float32)
    r = Dataset.prepare(ColumnTable.from_numpy(cols), GOLDEN.num_vertices)
    carried = {k: np.asarray(v) for k, v in r.table.columns.items()}
    return r, dataset_from_numpy(carried, GOLDEN.num_vertices, "cpu")


def plan_cells():
    cells = []
    for engine in ENGINE_NAMES + ("multiquery",):
        for workload in WORKLOADS:
            if workload != "reach" and engine not in ("precursive",
                                                      "bitmap"):
                continue
            for d in DIRECTIONS:
                if engine.startswith("rowstore") and d != "outbound":
                    continue
                if workload != "reach" and engine == "bitmap" and \
                        d == "both":
                    continue
                cells.append((engine, workload, d))
    return cells


PLAN_CELLS = plan_cells()


def same_cost(got, want):
    assert [op.label for op in got.per_op] == [op.label for op in
                                               want.per_op]
    assert [op.rows for op in got.per_op] == [op.rows for op in want.per_op]
    np.testing.assert_allclose([op.bytes for op in got.per_op],
                               [op.bytes for op in want.per_op],
                               rtol=1e-12, atol=0)
    for f in ("plain_bytes", "kernel_bytes", "total_bytes", "est_us"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=0, err_msg=f)
    assert got.levels == want.levels
    assert got.result_rows == want.result_rows
    assert got.level_dirs == want.level_dirs


def widths(r, p):
    col_bytes = port_cost.column_bytes(p.table)
    assert col_bytes == ref_cost.column_bytes(r.table)
    row_bytes = len(port_core.RowTable.layout_of(p.table)) * 4
    assert row_bytes == r.rows.width * 4
    return col_bytes, row_bytes


@pytest.mark.parametrize("engine,workload,direction", PLAN_CELLS,
                         ids=["-".join(c) for c in PLAN_CELLS])
def test_pipeline_cost_matches_reference(golden, engine, workload,
                                         direction):
    r, p = golden
    col_bytes, row_bytes = widths(r, p)
    kw = dict(engine=engine, max_depth=7, payload_cols=4, caps=CAPS,
              direction=direction, workload=workload,
              weight_col=None if workload == "reach" else "w",
              lanes=8 if engine == "multiquery" else 1)
    want_plan = build_plan(RecursiveQuery(**kw))
    got_plan = port.build_plan(port.RecursiveQuery(
        **dict(kw, caps=port.EngineCaps(*CAPS))))
    for consts in (None, (2500.0, 7.0, 11.0)):
        c = [None, None] if consts is None else [
            m.CostConstants(*consts, kernel_factor=3.0)
            for m in (ref_cost, port_cost)]
        want = ref_cost.pipeline_cost(
            want_plan, r.stats(direction), row_bytes=row_bytes,
            col_bytes=col_bytes, constants=c[0])
        got = port_cost.pipeline_cost(
            got_plan, p.stats(direction), row_bytes=row_bytes,
            col_bytes=col_bytes, constants=c[1])
        same_cost(got, want)


KERNEL_PLANS = {
    "precursive+expand": (
        lambda d: ref_rec.precursive_plan(CAPS, 7, COLS, True, d,
                                          expand_fn=kernel_fn),
        lambda d: port_rec.precursive_plan(port.EngineCaps(*CAPS), 7, COLS,
                                           True, d, expand_fn=kernel_fn)),
    "bitmap+spmm": (
        lambda d: ref_bitmap.weighted_bitmap_plan(
            CAPS, 7, COLS, "aggregate_sum", d, use_kernel=True),
        lambda d: port_bitmap.weighted_bitmap_plan(
            port.EngineCaps(*CAPS), 7, COLS, "aggregate_sum", d,
            spmm_fn=kernel_fn)),
    "diropt+pull": (
        lambda d: ref_bitmap.diropt_plan(CAPS, 7, COLS, d,
                                         pull_fn=kernel_fn),
        lambda d: port_bitmap.diropt_plan(port.EngineCaps(*CAPS), 7, COLS,
                                          d, pull_fn=kernel_fn)),
}


@pytest.mark.parametrize("direction", ["outbound", "inbound"])
@pytest.mark.parametrize("name", sorted(KERNEL_PLANS))
def test_kernel_plans_price_as_reference(golden, name, direction):
    """The kernel slots the reference scales (the expansion, the pull, the
    dense (sum, ×) combine) split into plain and kernel bytes alike; an
    unresolved factor is refused alike."""
    r, p = golden
    col_bytes, row_bytes = widths(r, p)
    make_ref, make_port = KERNEL_PLANS[name]
    for kf in (0.0, 1.0, 0.37, 250.0):
        want = ref_cost.pipeline_cost(
            make_ref(direction), r.stats(direction), row_bytes=row_bytes,
            col_bytes=col_bytes,
            constants=ref_cost.CostConstants(kernel_factor=kf))
        got = port_cost.pipeline_cost(
            make_port(direction), p.stats(direction), row_bytes=row_bytes,
            col_bytes=col_bytes,
            constants=port_cost.CostConstants(kernel_factor=kf))
        same_cost(got, want)
    if want.kernel_bytes > 0:
        with pytest.raises(ValueError, match="kernel_factor"):
            port_cost.pipeline_cost(make_port(direction), p.stats(direction),
                                    row_bytes=row_bytes, col_bytes=col_bytes)


def test_estimate_us_and_constants_match_reference():
    for kw in (dict(), dict(bytes_per_us=3.0, level_us=1.5, base_us=0.0,
                            kernel_factor=2.0, pull_alpha=0.5, pull_beta=7.0,
                            guard_degrade_us=10.0, guard_reject_us=20.0)):
        rc, pc = ref_cost.CostConstants(**kw), port_cost.CostConstants(**kw)
        assert tuple(pc) == tuple(rc)
        assert pc.to_json() == rc.to_json()
        assert port_cost.CostConstants.from_json(rc.to_json()) == pc
        for args in ((1e6, 0.0, 3), (5.5, 1e4, 0)):
            b = dict(plain_bytes=args[0], kernel_bytes=args[1],
                     levels=args[2])
            if args[1] and rc.kernel_factor is None:
                continue
            assert (port_cost.estimate_us(pc, **b)
                    == ref_cost.estimate_us(rc, **b))
    assert tuple(port_cost.DEFAULT_CONSTANTS) == tuple(
        ref_cost.DEFAULT_CONSTANTS)


# ---------------------------------------------------------------------------
# the core/ leftovers
# ---------------------------------------------------------------------------

def test_width_bytes_and_select_match_reference():
    rng = np.random.default_rng(0)
    e = 9
    cols = {"id": np.arange(e, dtype=np.int32),
            "f": rng.random(e).astype(np.float32),
            "name": rng.random((e, 4)).astype(np.float32),
            "b": rng.random(e).astype(np.float32)}
    r = ColumnTable.from_numpy(cols)
    r = ColumnTable({**r.columns, "b": r.columns["b"].astype(jnp.bfloat16)})
    p = PortTable.from_numpy(cols, "cpu")
    p = PortTable({**p.columns, "b": p.columns["b"].to(torch.bfloat16)})
    for names in (None, ["b"], ["name"], ["id", "f"], ["name", "b", "id"]):
        assert p.width_bytes(names) == r.width_bytes(names)
    assert p.width_bytes(["b"]) == 2 and p.width_bytes() == 26
    assert port_cost.column_bytes(p) == ref_cost.column_bytes(r)
    sel = p.select(["name", "id"])
    assert list(sel.columns) == list(r.select(["name", "id"]).columns)
    assert sel.names == ("id", "name")
    assert sel.columns["name"] is p.columns["name"]


def test_take_late_matches_reference():
    rng = np.random.default_rng(1)
    cols = {"id": np.arange(12, dtype=np.int32),
            "name": rng.random((12, 3)).astype(np.float32)}
    r, p = ColumnTable.from_numpy(cols), PortTable.from_numpy(cols, "cpu")
    pos = np.array([3, 0, 11, 12, 5, 12], np.int32)   # sentinel 12
    want = ref_core.take_late(r, ref_core.PosBlock(jnp.asarray(pos),
                                                   jnp.int32(4)))
    got = port_core.take_late(p, port_core.PosBlock(
        torch.from_numpy(pos), torch.tensor(4, dtype=torch.int32)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    got = port_core.take_late(p, port_core.PosBlock(
        torch.from_numpy(pos), torch.tensor(4)), ["name"])
    assert list(got) == ["name"]


@pytest.mark.parametrize("num_buckets", [1, 4, 7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_positions_by_key_matches_reference(seed, num_buckets):
    """Duplicate keys keep their order (stable); keys in [-n, 0) count from
    the end, any other key outside [0, n) is counted nowhere."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2 * num_buckets, 2 * num_buckets, 40).astype(
        np.int32)
    want = ref_core.sort_positions_by_key(jnp.asarray(keys), num_buckets)
    got = port_core.sort_positions_by_key(torch.from_numpy(keys),
                                          num_buckets)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dedup", [True, False])
def test_precursive_bfs_matches_reference(dedup):
    g = dict(seed=12, num_vertices=29, num_edges=70)
    cols = graph_columns(**g)
    r = Dataset.prepare(ColumnTable.from_numpy(cols), g["num_vertices"])
    p = dataset_from_numpy(cols, g["num_vertices"], "cpu")
    caps = EngineCaps(86, 4 * 70 + 16)
    out_cols = ("id", "from", "to", "name")
    for root in (0, 5, 28):
        want = ref_core.precursive_bfs(r.table, r.csr, jnp.int32(root),
                                       caps=caps, max_depth=4,
                                       out_cols=out_cols, dedup=dedup)
        got = port_core.precursive_bfs(p.table, p.csr, root,
                                       caps=port.EngineCaps(*caps),
                                       max_depth=4, out_cols=out_cols,
                                       dedup=dedup)
        assert_same_result(got, want)


def test_edge_view_bytes_match_reference(golden):
    r, p = golden
    for d in ("both", "outbound", "inbound"):
        assert p.edge_view_bytes(d) == r.edge_view_bytes(d)
    with pytest.raises(ValueError, match="direction"):
        p.edge_view_bytes("sideways")


def test_core_exports_resolve():
    names = ("ColumnTable", "RowTable", "payload_names", "PosBlock",
             "empty_block", "compact_mask", "append_block", "take_late",
             "sort_positions_by_key", "CSRIndex", "build_csr",
             "expand_frontier", "Context", "Pipeline", "TraversalState",
             "fixed_point", "fixed_point_batch", "execute", "execute_batch",
             "EngineCaps", "BFSResult", "precursive_bfs", "trecursive_bfs",
             "rowstore_bfs", "trecursive_rewrite_bfs",
             "rowstore_rewrite_bfs", "bitmap_bfs", "hybrid_bfs")
    for n in names:
        assert hasattr(ref_core, n), n
        assert callable(getattr(port_core, n)) or isinstance(
            getattr(port_core, n), type), n
    assert port_core.execute is port_ops.execute
    assert port_core.EngineCaps is port_ops.EngineCaps
    assert dataclasses.is_dataclass(port_core.Pipeline)
