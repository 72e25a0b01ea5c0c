"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one; the
file imports neither jax nor repro, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Kernels and plain versions get the same inputs; a gather does no
arithmetic, so they must agree exactly.
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
