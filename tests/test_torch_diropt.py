"""The port's dense and direction-optimizing engines (``bitmap``,
``hybrid``, ``diropt``, ``diropt_hybrid``) against the JAX reference.

Every result is compared field for field with the reference's: positions
in emission order, count, depth, overflow, row depths, ``level_dirs`` and
every value column.  The path does no float arithmetic on values, so the
tolerance is 0 everywhere.  Besides: the 24 cells of reach_parity.json
for these engines, ``diropt`` row-equal to its push-only counterpart, the
switch forced to pull on every level, and the kernel-plugged plans on the
CPU (which run the plain versions and never launch).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bitmap as ref_bitmap
from repro.core import operators as ref_ops
from repro.core.engine import (DIROPT_ENGINE_NAMES, ENGINE_NAMES, EngineCaps,
                               PUSH_COUNTERPART, RecursiveQuery, run_query)
from repro.core.operators import execute
from repro_torch.core import bitmap as port_bitmap
from repro_torch.core import engine as port
from repro_torch.core import operators as port_ops
from repro_torch.kernels.frontier_expand import ops as fe_ops
from repro_torch.kernels.frontier_pull import ops as fp_ops
from test_torch_engine import (DIRECTIONS, GOLDEN, GRAPHS, assert_same_result,
                               both_datasets, graph_columns, port_query)
from test_torch_engine import release_reference_executables  # noqa: F401

DENSE_ENGINES = ("bitmap", "hybrid", "diropt", "diropt_hybrid")
FORCE_PULL = dict(alpha=1e9, beta=1e9)


def assert_rows_equal(a, b) -> None:
    """Two port results with the same rows, order, depths and loop
    accounting (the push/pull pairs; ``level_dirs`` differ by design)."""
    for field in ("positions", "count", "depth", "overflow", "row_depths"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    for k in b.values:
        assert torch.equal(a.values[k], b.values[k]), k


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("engine", DENSE_ENGINES)
@pytest.mark.parametrize("g", GRAPHS, ids=lambda g: f"g{g['seed']}")
def test_golden_dense_cells(g, engine, direction):
    """The ``g*/{engine}/{direction}`` cells of reach_parity.json, and the
    live reference on the same graph."""
    with open(GOLDEN) as f:
        cell = json.load(f)[f"g{g['seed']}/{engine}/{direction}"]
    ref, ds = both_datasets(graph_columns(**g), g["num_vertices"])
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
    from repro.data.treegen import TreeSpec, make_edge_table
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=4, seed=11)
    return both_datasets({k: np.asarray(v) for k, v in
                          make_edge_table(spec).columns.items()},
                         spec.num_vertices)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("engine", DENSE_ENGINES)
def test_tree_roots_match_reference(tree, engine, direction):
    """Root 0 (the whole tree, and both sides of the switch), a depth-1
    vertex, an inner vertex and the last vertex."""
    ref, ds = tree
    q = RecursiveQuery(engine, 10, 4, EngineCaps(4096, 8192),
                       direction=direction)
    for root in (0, 1, 17, 2999):
        assert_same_result(port.run_query(port_query(q), ds, root),
                           run_query(q, ref, root))


def test_switch_takes_both_sides_on_the_tree(tree):
    """Root 0 of the tree crosses the switch: the test above holds both the
    push and the pull side of ``diropt`` and ``diropt_hybrid``, and both
    branches of ``hybrid``, against the reference."""
    _, ds = tree
    for engine in DIROPT_ENGINE_NAMES:
        r = port.run_query(port.RecursiveQuery(
            engine, 10, 4, port.EngineCaps(4096, 8192)), ds, 0)
        dirs = r.level_dirs.tolist()
        assert 0 in dirs and 1 in dirs, (engine, dirs)
    threshold = int(3000 * 0.05)
    r = port.run_query(port.RecursiveQuery(
        "hybrid", 10, 4, port.EngineCaps(4096, 8192)), ds, 0)
    widths = torch.bincount(r.row_depths[:int(r.count)])
    assert (widths < threshold).any() and (widths >= threshold).any()


@pytest.mark.parametrize("caps", [(64, 4096), (4096, 300), (40, 100)])
@pytest.mark.parametrize("engine", DENSE_ENGINES)
def test_overflowing_caps_match_reference(tree, engine, caps):
    ref, ds = tree
    q = RecursiveQuery(engine, 10, 4, EngineCaps(*caps))
    got = port.run_query(port_query(q), ds, 0)
    want = run_query(q, ref, 0)
    assert bool(got.overflow) == bool(want.overflow)
    assert_same_result(got, want)


def random_graph(seed):
    """Small random multigraphs as tests/test_diropt.py draws them."""
    rng = np.random.default_rng(seed)
    v = int(rng.integers(6, 48))
    e = int(rng.integers(2, 3 * v))
    cols = {"id": np.arange(e, dtype=np.int32),
            "from": rng.integers(0, v, e).astype(np.int32),
            "to": rng.integers(0, v, e).astype(np.int32),
            "name": rng.standard_normal((e, 4)).astype(np.float32)}
    return cols, v, int(rng.integers(0, v)), int(rng.integers(1, 6))


def graph_caps(num_edges, direction):
    n = 2 * num_edges if direction == "both" else num_edges
    return port.EngineCaps(n + 16, n + 16)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_diropt_equals_push_counterpart(tree, direction):
    """Row for row, whatever the switch decides: on the tree and on random
    multigraphs (the port alone; the reference is held above)."""
    cases = [(tree[1], 0, 10, port.EngineCaps(4096, 8192))]
    for seed in range(6):
        cols, v, root, depth = random_graph(seed)
        cases.append((both_datasets(cols, v)[1], root, depth,
                      graph_caps(len(cols["id"]), direction)))
    for ds, root, depth, caps in cases:
        for engine in DIROPT_ENGINE_NAMES:
            got = port.run_query(port.RecursiveQuery(
                engine, depth, 0, caps, direction=direction), ds, root)
            want = port.run_query(port.RecursiveQuery(
                PUSH_COUNTERPART[engine], depth, 0, caps,
                direction=direction), ds, root)
            assert_rows_equal(got, want)
            assert set(got.level_dirs.tolist()) <= {-1, 0, 1}


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("seed", [1, 7])
def test_forced_pull_matches_reference(seed, direction):
    """alpha = beta = 1e9 pins the switch to pull: every level runs
    PullStep / HybridPullStep, ``level_dirs`` says so, and the rows equal
    the push-only engines; each port plan equals the reference's."""
    cols, v, root, depth = random_graph(seed)
    ref, ds = both_datasets(cols, v)
    caps = graph_caps(len(cols["id"]), direction)
    out = ("id", "from", "to", "name")
    for make, push in (("diropt_plan", "bitmap"),
                       ("diropt_hybrid_plan", "hybrid")):
        kw = dict(direction=direction, **FORCE_PULL)
        got = port_ops.execute(getattr(port_bitmap, make)(caps, depth, out,
                                                          **kw),
                               ds.context(direction), root, v)
        want = execute(getattr(ref_bitmap, make)(EngineCaps(*caps), depth,
                                                 out, **kw),
                       ref.context(direction), root, v)
        assert_same_result(got, want)
        assert (got.level_dirs[:int(got.depth)] == 1).all()
        assert_rows_equal(got, port.run_query(port.RecursiveQuery(
            push, depth, 0, caps, direction=direction), ds, root))


def emitted_mode_switch(module, caps, max_depth, out_cols, **kw):
    """A switch over the EMITTED-mode dense steps (no deferral), which no
    engine builds: exercises PullStep's emitted mode and the predicate's
    popcount of ``visited``."""
    return module.Pipeline(
        name="EmittedSwitch", rep="dense",
        seed=module.Seed(kind="dense"),
        ops=(module.DirectionSwitch(push=module.DenseBitmapStep(),
                                    pull=module.PullStep(), **kw),),
        finisher=module.CompactEmitted(tuple(out_cols)),
        caps=caps, max_depth=max_depth, inclusive=True, tracks_emitted=True,
        tracks_switch=True)


@pytest.mark.parametrize("kw", [{}, FORCE_PULL], ids=["switch", "pull"])
def test_emitted_mode_switch_matches_reference(tree, kw):
    ref, ds = tree
    out = ("id", "from", "to", "name")
    for direction in DIRECTIONS:
        got = port_ops.execute(
            emitted_mode_switch(port_ops, port.EngineCaps(8192, 8192), 10,
                                out, **kw), ds.context(direction), 0, 3000)
        want = execute(
            emitted_mode_switch(ref_ops, EngineCaps(8192, 8192), 10, out,
                                **kw), ref.context(direction), 0, 3000)
        assert_same_result(got, want)


def test_kernel_plugged_plans_on_cpu_never_launch(tree):
    """The plans ``run_query`` builds on the card, with both kernel
    wrappers plugged in, run here on CPU tensors: the wrappers take their
    plain versions, nothing launches, and every result is unchanged, with
    the reverse CSR built (the card's path) and without it (the natural-
    order pull)."""
    _, ds = tree
    before = fe_ops.LAUNCHES, fp_ops.LAUNCHES
    for direction in DIRECTIONS:
        for engine in DENSE_ENGINES:
            q = port.RecursiveQuery(engine, 10, 4, port.EngineCaps(4096, 8192),
                                    direction=direction)
            for kw in ({}, FORCE_PULL):
                if kw and engine not in DIROPT_ENGINE_NAMES:
                    continue
                plans = [port.build_plan(q), port.build_plan(
                    q, expand_fn=fe_ops.frontier_expand_fused,
                    pull_fn=fp_ops.frontier_pull_fused)]
                if kw:
                    plans = [getattr(port_bitmap, f"{engine}_plan")(
                        q.caps, 10, q.out_cols, direction=direction,
                        pull_fn=fn, **kw)
                        for fn in (None, fp_ops.frontier_pull_fused)]
                want = port_ops.execute(plans[0], ds.context(direction), 0,
                                        3000)
                assert_rows_equal(port_ops.execute(
                    plans[1], ds.context(direction), 0, 3000), want)
    assert (fe_ops.LAUNCHES, fp_ops.LAUNCHES) == before


def test_outbound_pull_without_reverse_csr(tree):
    """On the CPU an outbound dataset keeps no reverse CSR until asked
    (the reference's natural-order pull); with it, the same result; a
    kernel plugged in without it is refused."""
    ref, _ = tree
    carried = {k: np.asarray(v) for k, v in ref.table.columns.items()}
    from repro_torch.convert import dataset_from_numpy
    ds = dataset_from_numpy(carried, 3000, "cpu")
    q = port.RecursiveQuery("diropt", 10, 4, port.EngineCaps(4096, 8192))
    plain = port.run_query(q, ds, 0)
    assert ds.rcsr is None
    with pytest.raises(ValueError, match="ensure_reverse"):
        port_ops.execute(port.build_plan(
            q, pull_fn=fp_ops.frontier_pull_fused), ds.context(), 0, 3000)
    ds.ensure_reverse()
    assert_same_result(port.run_query(q, ds, 0), plain)


def test_bfs_helpers_match_reference(tree):
    ref, ds = tree
    out = ("id", "from", "to", "name")
    caps = (4096, 8192)
    assert_same_result(
        port_bitmap.bitmap_bfs(ds.table, 3000, 0, caps=port.EngineCaps(*caps),
                               max_depth=10, out_cols=out),
        ref_bitmap.bitmap_bfs(ref.table, 3000, 0, caps=EngineCaps(*caps),
                              max_depth=10, out_cols=out))
    assert_same_result(
        port_bitmap.hybrid_bfs(ds.table, ds.csr, 0,
                               caps=port.EngineCaps(*caps), max_depth=10,
                               out_cols=out),
        ref_bitmap.hybrid_bfs(ref.table, ref.csr, 0, caps=EngineCaps(*caps),
                              max_depth=10, out_cols=out))


def test_engine_names_follow_reference():
    assert set(port.ENGINE_NAMES) <= set(ENGINE_NAMES)
    assert [e for e in ENGINE_NAMES if e in port.ENGINE_NAMES] == \
        list(port.ENGINE_NAMES)
    assert port.DIROPT_ENGINE_NAMES == DIROPT_ENGINE_NAMES
    assert port.PUSH_COUNTERPART == PUSH_COUNTERPART
