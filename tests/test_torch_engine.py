"""The port's PRecursive main path, end to end, against the JAX reference.

The port's ``run_query(..., device="cpu")`` is compared field for field
with the reference's ``run_query``: positions in emission order, count,
depth, overflow, row depths and every value column.  Gathers do no
arithmetic, so floats are compared exactly too (tolerance 0).  The port's
dataset is carried across from the reference's table with
``dataset_from_numpy``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from repro.core.engine import Dataset, EngineCaps, RecursiveQuery, run_query
from repro.core.operators import execute
from repro.core.recursive import precursive_plan
from repro.core.table import ColumnTable
from repro.data.treegen import TreeSpec, make_edge_table
from repro.planner.calibrate import kernel_expand_fn
from repro_torch.convert import dataset_from_numpy
from repro_torch.core import engine as port
from repro_torch.core.operators import execute as port_execute
from repro_torch.core.recursive import precursive_plan as port_precursive_plan
from repro_torch.kernels.frontier_expand import frontier_expand_fused

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "tests", "golden", "reach_parity.json")
DIRECTIONS = ("outbound", "inbound", "both")
# the two graphs of scripts/gen_reach_golden.py, rebuilt the same way
GRAPHS = (dict(seed=3, num_vertices=17, num_edges=40, max_depth=4),
          dict(seed=12, num_vertices=29, num_edges=70, max_depth=6))


@pytest.fixture(scope="module", autouse=True)
def release_reference_executables():
    """XLA keeps every compiled CPU executable mapped, and one xdist worker
    runs many JAX files, up to Linux's 65,530 memory maps (ROADMAP §3):
    drop the executables of the modules before this one and, once it is
    done, its own.  Every parity module imports this fixture."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def graph_columns(seed, num_vertices, num_edges, **_):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, size=num_edges)
    dst = rng.integers(0, num_vertices, size=num_edges)
    return {"id": np.arange(num_edges, dtype=np.int32),
            "from": src.astype(np.int32),
            "to": dst.astype(np.int32),
            "name": rng.standard_normal((num_edges, 4)).astype(np.float32)}


def both_datasets(cols, num_vertices):
    ref = Dataset.prepare(ColumnTable.from_numpy(cols), num_vertices)
    carried = {k: np.asarray(v) for k, v in ref.table.columns.items()}
    return ref, dataset_from_numpy(carried, num_vertices, "cpu")


def port_query(q: RecursiveQuery) -> port.RecursiveQuery:
    return port.RecursiveQuery(q.engine, q.max_depth, q.payload_cols,
                               port.EngineCaps(*q.caps), q.dedup,
                               q.direction)


def assert_same_result(got, want) -> None:
    """Field for field, including ``level_dirs`` where the engine has it."""
    for field in ("positions", "count", "depth", "overflow", "row_depths"):
        g = getattr(got, field).numpy()
        w = np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    if want.level_dirs is None:
        assert got.level_dirs is None
    else:
        g, w = got.level_dirs.numpy(), np.asarray(want.level_dirs)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg="level_dirs")
    assert sorted(got.values) == sorted(want.values)
    for k, w in want.values.items():
        g, w = got.values[k].numpy(), np.asarray(w)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("g", GRAPHS, ids=lambda g: f"g{g['seed']}")
def test_golden_precursive_cells(g, direction):
    """The ``g*/precursive/*`` cells of reach_parity.json, and the live
    reference on the same graph."""
    with open(GOLDEN) as f:
        cell = json.load(f)[f"g{g['seed']}/precursive/{direction}"]
    ref, ds = both_datasets(graph_columns(**g), g["num_vertices"])
    q = RecursiveQuery("precursive", g["max_depth"], 0,
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


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_tree_roots_match_reference(tree, direction):
    ref, ds = tree
    q = RecursiveQuery("precursive", 10, 4, EngineCaps(4096, 8192),
                       direction=direction)
    for root in (0, 1, 17, 2999):
        assert_same_result(port.run_query(port_query(q), ds, root),
                           run_query(q, ref, root))


@pytest.mark.parametrize("caps", [(64, 4096), (4096, 300), (40, 100)])
def test_overflowing_caps_match_reference(tree, caps):
    ref, ds = tree
    q = RecursiveQuery("precursive", 10, 4, EngineCaps(*caps))
    got = port.run_query(port_query(q), ds, 0)
    assert bool(got.overflow)
    assert_same_result(got, run_query(q, ref, 0))


def test_undeduplicated_walk_matches_reference(tree):
    ref, ds = tree
    q = RecursiveQuery("precursive", 5, 4, EngineCaps(4096, 8192),
                       dedup=False, direction="both")
    assert_same_result(port.run_query(port_query(q), ds, 3),
                       run_query(q, ref, 3))


def test_kernel_plugged_pipeline_matches_reference(tree):
    """The reference planner's kernel candidate (the Pallas expansion in
    CSRIndexJoin) against the port's pipeline with the kernel wrapper
    plugged in (its plain version, on the CPU)."""
    ref, ds = tree
    q = RecursiveQuery("precursive", 10, 4, EngineCaps(4096, 8192))
    want = execute(precursive_plan(q.caps, q.max_depth, q.out_cols,
                                   expand_fn=kernel_expand_fn()),
                   ref.context(), 0, ref.num_vertices)
    pq = port_query(q)
    plan = port_precursive_plan(pq.caps, pq.max_depth, pq.out_cols,
                                expand_fn=frontier_expand_fused)
    got = port_execute(plan, ds.context(), 0, ds.num_vertices)
    assert_same_result(got, want)


def test_other_engines_name_their_slice():
    """Every engine of the reference now builds on the port: the paper's
    other engines and MS-BFS (``multiquery``), which once named their
    ROADMAP slices; an unknown engine still raises."""
    for engine in ("trecursive", "rowstore", "rowstore_index_rewrite",
                   "multiquery"):
        q = port.RecursiveQuery(engine, 3, 0, port.EngineCaps(8, 8))
        assert port.build_plan(q).ops
    with pytest.raises(ValueError, match="unknown engine"):
        port.build_plan(port.RecursiveQuery("nope", 3, 0,
                                            port.EngineCaps(8, 8)))


def test_prepare_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    cols = graph_columns(**GRAPHS[0])
    table = port.ColumnTable.from_numpy(cols, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.Dataset.prepare(table, GRAPHS[0]["num_vertices"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dataset_from_numpy(cols, GRAPHS[0]["num_vertices"])


def test_port_imports_neither_jax_nor_reference():
    """Every repro_torch module and chip_smoke.py import in a fresh
    interpreter without pulling in jax or any module of repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
