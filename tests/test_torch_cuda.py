"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one; the
file imports neither jax nor repro, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Kernels and plain versions get the same inputs; a gather does no
arithmetic, so they must agree exactly.  ``spmm_segment`` sums: where a
row has one edge it must agree exactly, elsewhere within ``rtol = 1e-5,
atol = 1e-5`` (the plain version's ``index_add_`` adds with atomics in no
fixed order), and for rows of thousands of edges within 1e-5 of the
row's sum of absolute terms.  A weighted ``run_query`` on the card equals the CPU run in
every integer field and value column, and in ``vertex_values`` exactly for
min and max semirings, within ``rtol = 1e-5, atol = 1e-6`` for sum and
product (the CPU and the card scatter in different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import dataset_from_numpy
from repro_torch.core.csr import build_csr, expand_frontier
from repro_torch.core.engine import EngineCaps, RecursiveQuery, run_query
from repro_torch.data.treegen import TreeSpec, make_edge_table
from repro_torch.kernels.frontier_expand import ops as fe_ops
from repro_torch.kernels.frontier_pull import ops as fp_ops
from repro_torch.kernels.frontier_pull.ref import frontier_pull_ref
from repro_torch.kernels.late_gather import ops as lg_ops
from repro_torch.kernels.late_gather.ref import late_gather_ref
from repro_torch.kernels.spmm_segment import ops as spmm_ops
from repro_torch.kernels.spmm_segment.ref import spmm_segment_ref


@pytest.fixture
def cuda():
    """The card; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("r,w,p", [(8, 1, 4), (64, 37, 25), (128, 128, 200),
                                   (33, 260, 7), (1000, 5, 4096)])
def test_late_gather_kernel_matches_plain(cuda, dtype, r, w, p):
    rng = np.random.default_rng(r * w + p)
    tab = torch.from_numpy(rng.standard_normal((r, w)) * 10).to(dtype)
    pos = torch.from_numpy(rng.integers(-2, r + 5, p).astype(np.int32))
    before = lg_ops.LAUNCHES
    got = lg_ops.late_gather(tab.to(cuda), pos.to(cuda))
    torch.cuda.synchronize()
    assert lg_ops.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), late_gather_ref(tab, pos))


@pytest.mark.parametrize("seed", range(10))
def test_frontier_expand_kernel_matches_plain(cuda, seed):
    rng = np.random.default_rng(seed)
    v = int(rng.integers(4, 200))
    e = int(rng.integers(1, 3000))
    f = int(rng.integers(1, 300))
    src = torch.from_numpy(rng.integers(0, v, e).astype(np.int32))
    targets = torch.from_numpy(rng.integers(-1, v, f).astype(np.int32))
    valid = torch.from_numpy(rng.random(f) < 0.8)
    cap = int(rng.integers(1, e + 64))
    want = expand_frontier(build_csr(src, v), targets, valid, cap)
    before = fe_ops.LAUNCHES
    got = fe_ops.frontier_expand_fused(build_csr(src.to(cuda), v),
                                       targets.to(cuda), valid.to(cuda), cap)
    torch.cuda.synchronize()
    assert fe_ops.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("seed", range(10))
def test_frontier_pull_kernel_matches_plain(cuda, seed):
    """Random graphs with ids outside [0, V) (clipped per entry), and an
    empty edge list (a zero mask, no launch)."""
    rng = np.random.default_rng(seed)
    v = int(rng.integers(2, 300))
    e = 0 if seed == 0 else int(rng.integers(1, 5000))
    src = torch.from_numpy(rng.integers(-3, v + 3, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(-3, v + 3, e).astype(np.int32))
    frontier = torch.from_numpy(rng.random(v) < 0.3)
    visited = torch.from_numpy(rng.random(v) < 0.4) | frontier
    want = frontier_pull_ref(build_csr(dst, v), src, dst, frontier, visited)
    before = fp_ops.LAUNCHES
    got = fp_ops.frontier_pull_fused(build_csr(dst.to(cuda), v),
                                     src.to(cuda), dst.to(cuda),
                                     frontier.to(cuda), visited.to(cuda))
    torch.cuda.synchronize()
    assert fp_ops.LAUNCHES == before + (e > 0)
    assert got.dtype == torch.bool and torch.equal(got.cpu(), want)


ENGINES = ("precursive", "bitmap", "hybrid", "diropt", "diropt_hybrid")


@pytest.mark.parametrize("direction", ["outbound", "inbound", "both"])
@pytest.mark.parametrize("engine", ENGINES)
def test_run_query_on_card_matches_cpu(cuda, engine, direction):
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
    cols = make_edge_table(spec)
    q = RecursiveQuery(engine, 10, 2, EngineCaps(4096, 8192),
                       direction=direction)
    for root in (0, 17, 2999):
        got = run_query(q, dataset_from_numpy(cols, 3000, cuda), root)
        want = run_query(q, dataset_from_numpy(cols, 3000, "cpu"), root)
        for field in ("positions", "count", "depth", "overflow",
                      "row_depths", "level_dirs"):
            g, w = getattr(got, field), getattr(want, field)
            assert (g is None and w is None) or torch.equal(g.cpu(), w), \
                field
        for k in want.values:
            assert torch.equal(got.values[k].cpu(), want.values[k]), k


def spmm_inputs(case: str, d: int):
    """(a) a tree level: in-degree 1, V = 2^20, sources outside a random
    frontier padded with V; (b) V = 2^20, E = 2^22 uniform; (c) V = 2^16,
    E = 2^18 uniform; (d) (c) plus 8 hub rows of about 12,500 edges each
    (the warp-summed rows at D = 1), every 5th source padded.  Weights
    uniform in [0.5, 2), from a numpy seed."""
    rng = np.random.default_rng(("a", "b", "c", "d").index(case))
    if case == "a":
        v = 1 << 20
        dst = np.arange(1, v, dtype=np.int32)
        src = (rng.random(v - 1) * dst).astype(np.int32)   # parent < child
        frontier = rng.random(v) < 0.15
        src = np.where(frontier[src], src, v).astype(np.int32)
    else:
        v, e = (1 << 20, 1 << 22) if case == "b" else (1 << 16, 1 << 18)
        src = rng.integers(0, v, e).astype(np.int32)
        dst = rng.integers(0, v, e).astype(np.int32)
        if case == "d":
            hubs = 100_000
            src = np.concatenate([src, rng.integers(0, v, hubs)])
            dst = np.concatenate([dst, rng.integers(0, 8, hubs)])
            src[::5] = v
            src, dst = src.astype(np.int32), dst.astype(np.int32)
    w = rng.uniform(0.5, 2.0, dst.shape[0]).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32))
    return x, torch.from_numpy(src), torch.from_numpy(dst), \
        torch.from_numpy(w), v


@pytest.mark.parametrize("d", [1, 17, 128])
@pytest.mark.parametrize("case", ["a", "b", "c", "d"])
def test_spmm_segment_kernel_matches_plain(cuda, case, d):
    x, src, dst, w, v = (t.to(cuda) if isinstance(t, torch.Tensor) else t
                         for t in spmm_inputs(case, d))
    want = spmm_segment_ref(x, src, dst, w, v)
    before = spmm_ops.LAUNCHES
    got = spmm_ops.spmm_segment(x, src, dst, w, v)
    torch.cuda.synchronize()
    assert spmm_ops.LAUNCHES == before + 1
    assert got.shape == (v, d) and got.dtype == torch.float32
    if case == "a":
        assert torch.equal(got, want)
    elif case == "d":
        # a hub row sums ~12,500 terms that cancel: its rounding error is
        # bounded by the row's absolute sum, not by its value
        scale = spmm_segment_ref(x.abs(), src, dst, w.abs(), v)
        assert bool(((got - want).abs() <= 1e-5 * scale + 1e-5).all())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


WEIGHTED = ([("precursive", d) for d in ("outbound", "inbound", "both")]
            + [("bitmap", d) for d in ("outbound", "inbound")])
SEMIRINGS = ("shortest_path", "aggregate_sum", "aggregate_max",
             "aggregate_min", "aggregate_mul")


@pytest.mark.parametrize("workload", SEMIRINGS)
@pytest.mark.parametrize("engine,direction", WEIGHTED)
def test_weighted_run_query_on_card_matches_cpu(cuda, engine, direction,
                                                workload):
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
    cols = make_edge_table(spec)
    cols["w"] = np.random.default_rng(12).uniform(
        0.5, 2.0, spec.num_edges).astype(np.float32)
    q = RecursiveQuery(engine, 10, 2, EngineCaps(4096, 8192),
                       direction=direction, workload=workload,
                       weight_col="w")
    before = spmm_ops.LAUNCHES
    for root in (0, 17, 2999):
        got = run_query(q, dataset_from_numpy(cols, 3000, cuda), root)
        want = run_query(q, dataset_from_numpy(cols, 3000, "cpu"), root)
        for field in ("positions", "count", "depth", "overflow",
                      "row_depths"):
            assert torch.equal(getattr(got, field).cpu(),
                               getattr(want, field)), field
        for k in want.values:
            assert torch.equal(got.values[k].cpu(), want.values[k]), k
        g, w = got.vertex_values.cpu(), want.vertex_values
        if workload in ("aggregate_sum", "aggregate_mul"):
            assert torch.equal(g.isfinite(), w.isfinite())
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6,
                                       equal_nan=True)
        else:
            assert torch.equal(g, w)
    launched = spmm_ops.LAUNCHES - before
    if engine == "bitmap" and workload == "aggregate_sum":
        assert launched > 0
    else:
        assert launched == 0
