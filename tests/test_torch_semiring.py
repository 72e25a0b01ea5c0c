"""The port's semiring value plane (the ``precursive`` and ``bitmap``
engines under the five value semirings) against the JAX reference.

Inputs are made from numpy seeds and carried into both packages.
Tolerances: every integer field (positions in emission order, count,
depth, overflow, row depths) and every value column must be exactly equal.
``vertex_values`` must be bit-equal for ``shortest_path``,
``aggregate_max`` and ``aggregate_min`` (min and max are exact in any
order).  For ``aggregate_sum`` and ``aggregate_mul`` a vertex that combines
several arrivals may round differently, because the two packages' scatters
add or multiply in another order: there ``rtol = 1e-5, atol = 1e-6``, with
the same pattern of non-finite entries.  The scatter primitives are held
to the same rule.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import semiring as ref_sr
from repro.core.bitmap import weighted_bitmap_plan as ref_weighted_bitmap
from repro.core.engine import Dataset, EngineCaps, RecursiveQuery, run_query
from repro.core.operators import execute
from repro.core.table import ColumnTable
from repro_torch.convert import dataset_from_numpy
from repro_torch.core import engine as port
from repro_torch.core import semiring as port_sr
from repro_torch.core.operators import execute as port_execute
from repro_torch.kernels.spmm_segment import ops as spmm_ops
from test_torch_engine import assert_same_result

SEMIRINGS = tuple(ref_sr.SEMIRINGS)
EXACT = ("shortest_path", "aggregate_max", "aggregate_min")


def assert_values_close(got, want, workload) -> None:
    """(V,) value planes under the module's tolerance rule."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    if workload in EXACT:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def assert_same_weighted(got, want, workload) -> None:
    assert_same_result(got, want)
    assert_values_close(got.vertex_values.numpy(), want.vertex_values,
                        workload)


def weighted_columns(src, dst, w, seed=0):
    rng = np.random.default_rng(seed)
    e = len(src)
    return {"id": np.arange(e, dtype=np.int32),
            "from": np.asarray(src, np.int32),
            "to": np.asarray(dst, np.int32),
            "name": rng.standard_normal((e, 4)).astype(np.float32),
            "w": np.asarray(w, np.float32)}


def both_weighted(cols, num_vertices):
    ref = Dataset.prepare(ColumnTable.from_numpy(cols), num_vertices)
    carried = {k: np.asarray(v) for k, v in ref.table.columns.items()}
    return ref, dataset_from_numpy(carried, num_vertices, "cpu")


def multigraph(seed):
    """A random multigraph with in-degree > 1 (fixed size, so the
    reference compiles once per plan)."""
    rng = np.random.default_rng(seed)
    v, e = 24, 60
    return (weighted_columns(rng.integers(0, v, e), rng.integers(0, v, e),
                             rng.uniform(0.5, 2.0, e), seed), v)


def dag(seed):
    """The DAG of tests/test_metamorphic.py::_check_dag_aggregation: edges
    point from the smaller to the larger vertex."""
    rng = np.random.default_rng(seed)
    v = int(rng.integers(6, 24))
    e = int(rng.integers(4, 3 * v))
    a = rng.integers(0, v, e)
    b = rng.integers(0, v, e)
    keep = a != b
    src, dst = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    return weighted_columns(src, dst, rng.uniform(0.25, 2.0, len(src)),
                            seed), v


def weighted_query(engine, workload, direction, caps, max_depth=4):
    return RecursiveQuery(engine, max_depth, 0, caps, dedup=False,
                          direction=direction, workload=workload,
                          weight_col="w")


def port_query(q: RecursiveQuery) -> port.RecursiveQuery:
    return port.RecursiveQuery(q.engine, q.max_depth, q.payload_cols,
                               port.EngineCaps(*q.caps), q.dedup,
                               q.direction, q.workload, q.weight_col)


# ---------------------------------------------------------------------------
# the registry and the scatter primitives
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert tuple(port_sr.SEMIRINGS) == SEMIRINGS
    for name, s in ref_sr.SEMIRINGS.items():
        p = port_sr.get_semiring(name)
        assert (p.name, p.combine, p.propagate, p.identity, p.seed_value,
                p.improving) == (s.name, s.combine, s.propagate, s.identity,
                                 s.seed_value, s.improving)
    assert port_sr.WORKLOADS == ref_sr.WORKLOADS
    for name in ("reach", "nope"):
        with pytest.raises(ValueError, match="unknown semiring"):
            port_sr.get_semiring(name)


@pytest.mark.parametrize("workload", SEMIRINGS)
def test_scatter_elem_propagate_match_reference(workload):
    """Duplicate indices, and indices at or past the end (dropped)."""
    rng = np.random.default_rng(SEMIRINGS.index(workload))
    n, k = 12, 40
    arr = rng.uniform(-2.0, 2.0, n).astype(np.float32)
    idx = rng.integers(0, n + 4, k).astype(np.int32)
    vals = rng.uniform(0.5, 2.0, k).astype(np.float32)
    other = rng.uniform(-2.0, 2.0, n).astype(np.float32)
    rs, ps = ref_sr.get_semiring(workload), port_sr.get_semiring(workload)
    got = port_sr.scatter_combine(ps, torch.from_numpy(arr),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(vals))
    want = ref_sr.scatter_combine(rs, jnp.asarray(arr), jnp.asarray(idx),
                                  jnp.asarray(vals))
    assert_values_close(got.numpy(), want, workload)
    assert_values_close(
        port_sr.elem_combine(ps, torch.from_numpy(arr),
                             torch.from_numpy(other)).numpy(),
        ref_sr.elem_combine(rs, jnp.asarray(arr), jnp.asarray(other)),
        "shortest_path")
    assert_values_close(
        port_sr.propagate(ps, torch.from_numpy(arr),
                          torch.from_numpy(other)).numpy(),
        ref_sr.propagate(rs, jnp.asarray(arr), jnp.asarray(other)),
        "shortest_path")


def test_or_combine_matches_reference():
    rng = np.random.default_rng(3)
    arr = rng.random(10) < 0.3
    idx = rng.integers(0, 14, 30).astype(np.int32)
    vals = rng.random(30) < 0.5
    got = port_sr.or_combine(torch.from_numpy(arr), torch.from_numpy(idx),
                             torch.from_numpy(vals))
    want = ref_sr.or_combine(jnp.asarray(arr), jnp.asarray(idx),
                             jnp.asarray(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# run_query, every weighted engine x direction x semiring
# ---------------------------------------------------------------------------

CASES = ([("precursive", d) for d in ("outbound", "inbound", "both")]
         + [("bitmap", d) for d in ("outbound", "inbound")])


@pytest.mark.parametrize("workload", SEMIRINGS)
@pytest.mark.parametrize("engine,direction", CASES)
def test_run_query_matches_reference(engine, direction, workload):
    """A random multigraph (two roots) and the metamorphic DAG (its first
    source), depth 4."""
    for cols, v in (multigraph(0), dag(10)):
        ref, ds = both_weighted(cols, v)
        e = len(cols["id"])
        n = 2 * e if direction == "both" else e
        q = weighted_query(engine, workload, direction,
                           EngineCaps(n + 16, 16 * n + 64))
        roots = (0, 5) if v == 24 else (int(cols["from"][0]),)
        for root in roots:
            assert_same_weighted(port.run_query(port_query(q), ds, root),
                                 run_query(q, ref, root), workload)


@pytest.mark.parametrize("engine", ("precursive", "bitmap"))
def test_dag_aggregation_matches_path_fold(engine):
    """tests/test_metamorphic.py section 5: on a DAG, aggregate_sum equals
    the per-path UNION ALL fold (seeds 10 and 14)."""
    for seed in (10, 14):
        cols, v = dag(seed)
        src, dst, w = cols["from"], cols["to"], cols["w"]
        root, depth = int(src[0]), 3
        total, frontier = {root: 1.0}, {root: 1.0}
        for _ in range(depth + 1):
            nxt = {}
            for s, d, wt in zip(src, dst, w):
                if int(s) in frontier:
                    nxt[int(d)] = nxt.get(int(d), 0.0) + frontier[int(s)] * wt
            for k, x in nxt.items():
                total[k] = total.get(k, 0.0) + x
            frontier = nxt
        _, ds = both_weighted(cols, v)
        e = len(src)
        q = port.RecursiveQuery(engine, depth, 0,
                                port.EngineCaps(e + 16, 16 * e + 64), False,
                                workload="aggregate_sum", weight_col="w")
        r = port.run_query(q, ds, root)
        assert not bool(r.overflow)
        vv = r.vertex_values.numpy()
        for vertex, val in total.items():
            np.testing.assert_allclose(vv[vertex], val, rtol=1e-5)


@pytest.mark.parametrize("engine", ("precursive", "bitmap"))
def test_min_distance_survives_competing_paths(engine):
    """tests/test_semiring.py's regressions: the 2-hop detour (cost 2)
    beats the heavy direct edge (10), and a cheaper 3-hop path found after
    the 1-hop one still wins (label-correcting convergence)."""
    for src, dst, w, v, depth, want in (
            ([0, 0, 2], [1, 2, 1], [10.0, 1.0, 1.0], 3, 4, [0.0, 2.0, 1.0]),
            ([0, 0, 2, 3], [1, 2, 3, 1], [9.0, 1.0, 1.0, 1.0], 4, 6,
             [0.0, 3.0, 1.0, 2.0])):
        ref, ds = both_weighted(weighted_columns(src, dst, w), v)
        q = weighted_query(engine, "shortest_path", "outbound",
                           EngineCaps(32, 64), depth)
        got = port.run_query(port_query(q), ds, 0)
        assert got.vertex_values.tolist() == want
        assert_same_weighted(got, run_query(q, ref, 0), "shortest_path")


@pytest.mark.parametrize("direction", ("outbound", "inbound"))
def test_bitmap_spmm_slot_on_cpu_matches_reference_kernel_path(direction):
    """The bitmap plan with the ``spmm_segment`` wrapper plugged in, on CPU
    tensors, takes the plain version and launches nothing; it matches the
    reference's plan with ``use_kernel=True`` (the Pallas kernel in
    interpret mode, which aggregate_sum reaches)."""
    cols, v = multigraph(1)
    ref, ds = both_weighted(cols, v)
    q = weighted_query("bitmap", "aggregate_sum", direction,
                       EngineCaps(76, 1024))
    want = execute(ref_weighted_bitmap(q.caps, q.max_depth, q.out_cols,
                                       "aggregate_sum", direction,
                                       use_kernel=True),
                   ref.context(direction, weight_col="w"), 0, v)
    pq = port_query(q)
    before = spmm_ops.LAUNCHES
    got = port_execute(port.build_plan(
        pq, spmm_fn=spmm_ops.spmm_segment_sorted),
        port.query_context(pq, ds), 0, v)
    assert spmm_ops.LAUNCHES == before
    assert_same_weighted(got, want, "aggregate_sum")
    plain = port.run_query(pq, ds, 0)
    assert torch.equal(got.vertex_values, plain.vertex_values)


def test_weighted_routing_errors():
    caps = port.EngineCaps(8, 8)
    for engine in ("hybrid", "diropt", "diropt_hybrid", "trecursive"):
        q = port.RecursiveQuery(engine, 3, 0, caps, workload="shortest_path",
                                weight_col="w")
        with pytest.raises(ValueError, match="no value plane"):
            port.build_plan(q)
    with pytest.raises(ValueError, match="single-direction"):
        port.build_plan(port.RecursiveQuery(
            "bitmap", 3, 0, caps, direction="both",
            workload="aggregate_sum", weight_col="w"))
    with pytest.raises(ValueError, match="unknown workload"):
        port.build_plan(port.RecursiveQuery("precursive", 3, 0, caps,
                                            workload="nope"))


def test_weight_column_is_carried_across():
    """``dataset_from_numpy`` carries a float32 ``w`` column as the weight
    column; another float type is cast to float32 once and cached; a
    missing or 2-D column raises."""
    cols, v = multigraph(2)
    ref, ds = both_weighted(cols, v)
    w = ds.table.column("w")
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref.table.column("w")))
    assert ds.edge_weights("w") is ds.edge_weights("w")
    assert ds.context("inbound", weight_col="w").edge_weights is \
        ds.edge_weights("w")
    assert ds.context("outbound").edge_weights is None
    cols64 = dict(cols, w=cols["w"].astype(np.float64),
                  w2=np.ones((len(cols["w"]), 2), np.float32))
    ds64 = dataset_from_numpy(cols64, v, "cpu")
    assert ds64.table.column("w").dtype == torch.float64
    np.testing.assert_array_equal(ds64.edge_weights("w").numpy(), cols["w"])
    with pytest.raises(ValueError, match="1-D"):
        ds64.edge_weights("w2")
    with pytest.raises(ValueError, match="unknown weight column"):
        ds64.edge_weights("nope")


def test_reach_has_no_value_plane():
    cols, v = multigraph(0)
    _, ds = both_weighted(cols, v)
    for engine in ("precursive", "bitmap"):
        r = port.run_query(port.RecursiveQuery(engine, 4, 0,
                                               port.EngineCaps(76, 1024)),
                           ds, 0)
        assert r.vertex_values is None
