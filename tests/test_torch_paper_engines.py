"""The paper's tuple-based and row-store engines (``trecursive``,
``rowstore``, ``rowstore_index`` and the three Exp-3 ``*_rewrite``
engines) on the port, against the JAX reference.

The port's ``run_query(..., device="cpu")`` is compared field for field
with the reference's: positions in emission order (all -1 on the tuple and
row pipelines, real ones after a ``TopLevelJoin``), count, depth,
overflow, row depths and every value column in the reference's dtype —
the row-store engines return float32 columns, whose int ids round above
2^24 in both packages.  Every value is a gather, so the tolerance is 0.
``RowTable``, ``plan_repr``, ``positions_available`` and the errors are
held to the reference too.  Each reference pipeline compiles once per
module where it can: JAX keeps every compiled CPU executable mapped.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bitmap as ref_bitmap
from repro.core import recursive as ref_recursive
from repro.core.engine import (ENGINE_NAMES, EngineCaps, RecursiveQuery,
                               build_plan, plan_repr, positions_available,
                               run_query)
from repro.core.table import ColumnTable, RowTable
from repro.data.treegen import TreeSpec, make_edge_table
from repro_torch.core import bitmap as port_bitmap
from repro_torch.core import engine as port
from repro_torch.core import recursive as port_recursive
from repro_torch.core.table import ColumnTable as PortColumnTable
from repro_torch.core.table import RowTable as PortRowTable
from test_torch_engine import (GOLDEN, GRAPHS, assert_same_result,
                               both_datasets, graph_columns, port_query)
from test_torch_engine import release_reference_executables  # noqa: F401

TUPLE_ENGINES = ("trecursive", "trecursive_rewrite")
ROW_ENGINES = ("rowstore", "rowstore_index", "rowstore_rewrite",
               "rowstore_index_rewrite")
ENGINES = TUPLE_ENGINES + ROW_ENGINES
# every (engine, direction) the reference allows: the row store is
# outbound-only
CELLS = ([(e, d) for e in TUPLE_ENGINES
          for d in ("outbound", "inbound", "both")]
         + [(e, "outbound") for e in ROW_ENGINES])
ROOTS = (0, 1, 17, 2999)


@pytest.fixture(scope="module")
def graphs():
    """Both golden graphs, as reference and port datasets."""
    return {g["seed"]: both_datasets(graph_columns(**g), g["num_vertices"])
            for g in GRAPHS}


@pytest.mark.parametrize("engine,direction", CELLS,
                         ids=lambda x: x if isinstance(x, str) else None)
@pytest.mark.parametrize("g", GRAPHS, ids=lambda g: f"g{g['seed']}")
def test_golden_paper_engine_cells(graphs, g, engine, direction):
    """The 20 ``g3/*`` and ``g12/*`` cells of reach_parity.json for the six
    engines, and the live reference on the same graph."""
    with open(GOLDEN) as f:
        cell = json.load(f)[f"g{g['seed']}/{engine}/{direction}"]
    ref, ds = graphs[g["seed"]]
    q = RecursiveQuery(engine, g["max_depth"], 0,
                       EngineCaps(g["num_edges"] + 16,
                                  4 * g["num_edges"] + 16),
                       direction=direction)
    got = port.run_query(port_query(q), ds, 0)
    assert int(got.count) == cell["count"]
    assert int(got.depth) == cell["depth"]
    assert bool(got.overflow) == cell["overflow"]
    assert got.positions.tolist() == cell["positions"]
    assert got.values["id"].tolist() == cell["ids"]
    assert got.row_depths.tolist() == cell["row_depths"]
    assert_same_result(got, run_query(q, ref, 0))


@pytest.fixture(scope="module")
def tree():
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=4, seed=11)
    return both_datasets({k: np.asarray(v) for k, v in
                          make_edge_table(spec).columns.items()},
                         spec.num_vertices)


@pytest.mark.parametrize("engine,direction", CELLS,
                         ids=lambda x: x if isinstance(x, str) else None)
def test_tree_roots_match_reference(tree, engine, direction):
    ref, ds = tree
    q = RecursiveQuery(engine, 10, 4, EngineCaps(4096, 8192),
                       direction=direction)
    for root in ROOTS:
        assert_same_result(port.run_query(port_query(q), ds, root),
                           run_query(q, ref, root))


@pytest.mark.parametrize("engine", ENGINES)
def test_undeduplicated_walk_matches_reference(tree, engine):
    ref, ds = tree
    direction = "both" if engine in TUPLE_ENGINES else "outbound"
    q = RecursiveQuery(engine, 5, 4, EngineCaps(4096, 8192), dedup=False,
                       direction=direction)
    assert_same_result(port.run_query(port_query(q), ds, 3),
                       run_query(q, ref, 3))


@pytest.mark.parametrize("caps", [(64, 4096), (4096, 300)])
@pytest.mark.parametrize("engine", ENGINES)
def test_overflowing_caps_match_reference(tree, engine, caps):
    ref, ds = tree
    q = RecursiveQuery(engine, 10, 4, EngineCaps(*caps))
    got = port.run_query(port_query(q), ds, 0)
    assert bool(got.overflow)
    assert_same_result(got, run_query(q, ref, 0))


def test_legacy_wrappers_match_reference(tree):
    """``trecursive_bfs``, ``trecursive_rewrite_bfs``, ``rowstore_bfs``
    and ``rowstore_rewrite_bfs`` (with the index) over a bare column table
    (tuple engines) or row table (row engines) and the CSR, as the
    reference's wrappers take them."""
    ref, ds = tree
    caps = EngineCaps(4096, 8192)
    out_cols = RecursiveQuery("trecursive", 10, 4, caps).out_cols
    rt, port_rt = RowTable.from_column_table(ref.table), \
        PortRowTable.from_column_table(ds.table)
    kw = dict(max_depth=10, out_cols=out_cols)
    pkw = dict(kw, caps=port.EngineCaps(*caps))
    kw["caps"] = caps
    for name, ref_args, port_args, extra in (
            ("trecursive_bfs", (ref.table, ref.csr), (ds.table, ds.csr), {}),
            ("trecursive_rewrite_bfs", (ref.table, ref.csr),
             (ds.table, ds.csr), {}),
            ("rowstore_bfs", (rt, ref.csr), (port_rt, ds.csr), {}),
            ("rowstore_rewrite_bfs", (rt, ref.csr), (port_rt, ds.csr),
             {"use_index": True})):
        want = getattr(ref_recursive, name)(*ref_args, 0, **kw, **extra)
        got = getattr(port_recursive, name)(*port_args, 0, **pkw, **extra)
        assert_same_result(got, want)


# ---------------------------------------------------------------------------
# RowTable
# ---------------------------------------------------------------------------

def row_columns():
    """Ids, the two vertex columns, a vector column and a scalar float
    column, in an order that the row table sorts."""
    rng = np.random.default_rng(5)
    e = 37
    return {"id": rng.permutation(e).astype(np.int32),
            "from": rng.integers(0, 20, e).astype(np.int32),
            "to": rng.integers(0, 20, e).astype(np.int32),
            "name": rng.standard_normal((e, 4)).astype(np.float32),
            "w": rng.standard_normal(e).astype(np.float32)}


def test_row_table_matches_reference():
    """Layout, the interleaved data, the strided column read, the full-row
    gather at real, sentinel and wrapped positions, and the projection of
    scalar and vector columns."""
    cols = row_columns()
    ref = RowTable.from_column_table(ColumnTable.from_numpy(cols))
    got = PortRowTable.from_column_table(
        PortColumnTable.from_numpy(cols, "cpu"))
    assert got.layout == ref.layout
    assert (got.num_rows, got.width) == (ref.num_rows, ref.width)
    assert got.data.dtype == torch.float32 and got.data.is_contiguous()
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    for name in ("id", "from", "name.2", "w"):
        assert got.slot(name) == ref.slot(name)
        np.testing.assert_array_equal(got.column(name).numpy(),
                                      np.asarray(ref.column(name)))
    e = ref.num_rows
    pos = np.array([0, 5, e - 1, e, -1, -e, 3, e], np.int32)
    want = np.asarray(ref.take_rows(pos))
    rows = got.take_rows(torch.from_numpy(pos))
    np.testing.assert_array_equal(rows.numpy(), want)
    assert not rows[3].any() and not rows[7].any()
    names = ("id", "name", "to", "w")
    proj = got.project(rows, names)
    ref_proj = ref.project(want, names)
    for name in names:
        assert proj[name].dtype == torch.float32
        np.testing.assert_array_equal(proj[name].numpy(),
                                      np.asarray(ref_proj[name]))
    with pytest.raises(KeyError):
        got.project(rows, ("nope",))


def test_row_table_zero_row_below_minus_r():
    """Below -R the reference's gather gives NaN; the port gives a zero row,
    as its ``late_gather`` does (no engine passes such a position).  Any
    shape of positions gathers, and an empty table raises IndexError."""
    cols = row_columns()
    got = PortRowTable.from_column_table(
        PortColumnTable.from_numpy(cols, "cpu"))
    e = got.num_rows
    rows = got.take_rows(torch.tensor([-e - 1, -3 * e, 2], dtype=torch.int32))
    assert not rows[:2].any()
    assert torch.equal(rows[2], got.data[2])
    grid = got.take_rows(torch.tensor([[0, e], [-1, 4]], dtype=torch.int32))
    assert grid.shape == (2, 2, got.width)
    assert torch.equal(grid[1, 0], got.data[e - 1])
    empty = PortRowTable(torch.zeros((0, 3)), ("a", "b", "c"))
    assert empty.take_rows(torch.zeros((0,), dtype=torch.int32)).shape == \
        (0, 3)
    with pytest.raises(IndexError):
        empty.take_rows(torch.zeros((1,), dtype=torch.int32))


@pytest.mark.parametrize("engine", ("rowstore", "rowstore_rewrite"))
def test_large_ids_round_as_in_the_reference(engine):
    """Ids of 2^24 and above: the row store holds them as float32, so they
    round; the rewrite's join casts them back, clips them into [0, E - 1]
    and finds one row for all of them.  The port gives the reference's
    float32 values."""
    g = GRAPHS[0]
    cols = graph_columns(**g)
    cols["id"] = (2 ** 24 + 1 + 3 * np.arange(g["num_edges"])).astype(
        np.int32)
    ref, ds = both_datasets(cols, g["num_vertices"])
    q = RecursiveQuery(engine, g["max_depth"], 0,
                       EngineCaps(g["num_edges"] + 16,
                                  4 * g["num_edges"] + 16))
    got = port.run_query(port_query(q), ds, 0)
    want = run_query(q, ref, 0)
    assert_same_result(got, want)
    ids = got.values["id"][:int(got.count)]
    assert ids.dtype == torch.float32
    assert not torch.equal(ids.to(torch.int64).unique(),
                           torch.from_numpy(cols["id"]).long().unique())


# ---------------------------------------------------------------------------
# plans, names and errors
# ---------------------------------------------------------------------------

def test_engine_names_and_positions_contract_match_reference():
    assert port.ENGINE_NAMES == ENGINE_NAMES
    for engine in ENGINE_NAMES:
        assert port.positions_available(engine) == \
            positions_available(engine), engine
    assert port.positions_available("rowstore_rewrite")
    assert not port.positions_available("rowstore")
    assert set(port.VALUE_ENGINE_NAMES) == set(ENGINES)


@pytest.mark.parametrize("depth,payload,root", [(16, 8, 0), (3, 0, 41)])
def test_plan_repr_matches_reference(depth, payload, root):
    """Every engine's rendered Volcano tree, derived from its operators,
    MS-BFS's (``multiquery``, outside ENGINE_NAMES) among them."""
    for engine in ENGINE_NAMES + ("multiquery",):
        assert port.plan_repr(engine, depth, payload, root) == \
            plan_repr(engine, depth, payload, root), engine


@pytest.mark.parametrize("direction", ("outbound", "inbound"))
@pytest.mark.parametrize("semiring", ("shortest_path", "aggregate_sum"))
def test_weighted_plans_render_as_in_reference(semiring, direction):
    caps, cols = EngineCaps(8, 8), ("id", "from", "to", "name")
    pcaps = port.EngineCaps(8, 8)
    assert port_recursive.weighted_precursive_plan(
        pcaps, 6, cols, semiring, direction).render(3) == \
        ref_recursive.weighted_precursive_plan(
            caps, 6, cols, semiring, direction).render(3)
    assert port_bitmap.weighted_bitmap_plan(
        pcaps, 6, cols, semiring, direction).render(3) == \
        ref_bitmap.weighted_bitmap_plan(
            caps, 6, cols, semiring, direction).render(3)


@pytest.mark.parametrize("direction", ("inbound", "both"))
@pytest.mark.parametrize("engine", ROW_ENGINES)
def test_row_store_is_outbound_only(engine, direction):
    caps = EngineCaps(8, 8)
    q = RecursiveQuery(engine, 3, 0, caps, direction=direction)
    with pytest.raises(ValueError, match="outbound-only"):
        build_plan(q)
    with pytest.raises(ValueError, match="outbound-only"):
        port.build_plan(port_query(q))


def test_row_store_error_builds_no_row_table(graphs):
    """The direction check comes before the row table is built."""
    _, ds = graphs[3]
    fresh = port.Dataset(ds.table, ds.csr, ds.num_vertices)
    q = port.RecursiveQuery("rowstore", 3, 0, port.EngineCaps(8, 8),
                            direction="inbound")
    with pytest.raises(ValueError, match="outbound-only"):
        port.run_query(q, fresh, 0)
    assert fresh.rows is None
    port.run_query(dataclasses.replace(q, direction="outbound"), fresh, 0)
    rows = fresh.rows
    assert rows is not None and rows.width == 7
    port.run_query(port.RecursiveQuery("rowstore_index", 3, 0,
                                       port.EngineCaps(8, 8)), fresh, 0)
    assert fresh.rows is rows


@pytest.mark.parametrize("engine", ENGINES)
def test_batches_name_their_slice(graphs, engine):
    """``run_query_batch`` on the six engines raises NotImplementedError
    naming the ROADMAP slice, after ``build_plan``'s checks."""
    _, ds = graphs[3]
    q = port.RecursiveQuery(engine, 3, 0, port.EngineCaps(64, 256))
    with pytest.raises(NotImplementedError,
                       match="batched roots, the paper's other engines"):
        port.run_query_batch(q, ds, [0, 1])
    if engine in ROW_ENGINES:
        with pytest.raises(ValueError, match="outbound-only"):
            port.run_query_batch(port.RecursiveQuery(
                engine, 3, 0, port.EngineCaps(64, 256), direction="both"),
                ds, [0, 1])
