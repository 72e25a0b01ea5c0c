"""The port's plain ``frontier_pull`` against the JAX Pallas kernel
(``pull_contrib_pallas`` through ``frontier_pull_fused``, interpret mode)
and the JAX ``frontier_pull_ref``, on random graphs, frontiers and
visited sets in the manner of tests/test_kernels.py, with ``from``/``to``
values outside [0, V) and an empty edge list.

The (V,) next-frontier masks must be exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.csr import build_csr
from repro.kernels.frontier_pull import frontier_pull_fused, frontier_pull_ref
from repro_torch.core.csr import build_csr as port_build_csr
from repro_torch.kernels.frontier_pull import ops as fp_ops
from repro_torch.kernels.frontier_pull import \
    frontier_pull_ref as port_frontier_pull_ref

# one vertex and edge count for the random cases, so the interpret-mode
# Pallas kernel compiles once
NUM_VERTICES, NUM_EDGES = 40, 300


def check_case(src, dst, frontier, visited):
    """The reference's kernel, its plain version, the port's plain version
    and the port's wrapper on CPU tensors all agree exactly."""
    v = frontier.shape[0]
    rcsr = build_csr(jnp.asarray(dst), v)
    args = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(frontier),
            jnp.asarray(visited))
    want = np.asarray(frontier_pull_ref(rcsr, *args))
    np.testing.assert_array_equal(
        np.asarray(frontier_pull_fused(rcsr, *args)), want)

    prcsr = port_build_csr(torch.from_numpy(dst), v)
    pargs = [torch.from_numpy(a) for a in (src, dst, frontier, visited)]
    before = fp_ops.LAUNCHES
    for fn in (port_frontier_pull_ref, fp_ops.frontier_pull_fused):
        got = fn(prcsr, *pargs)
        assert got.dtype == torch.bool and got.shape == (v,)
        np.testing.assert_array_equal(got.numpy(), want)
    assert fp_ops.LAUNCHES == before       # no kernel ran on the CPU
    return want


@pytest.mark.parametrize("seed", range(12))
def test_frontier_pull_random(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, NUM_VERTICES, NUM_EDGES).astype(np.int32)
    dst = rng.integers(0, NUM_VERTICES, NUM_EDGES).astype(np.int32)
    frontier = rng.random(NUM_VERTICES) < 0.3
    visited = (rng.random(NUM_VERTICES) < 0.4) | frontier
    check_case(src, dst, frontier, visited)


@pytest.mark.parametrize("seed", range(4))
def test_frontier_pull_out_of_range_ids(seed):
    """``from``/``to`` values below 0 and at or above V clip onto vertex 0
    or V-1 per entry; build_csr keeps such entries in ``perm``."""
    rng = np.random.default_rng(100 + seed)
    lo, hi = -5, NUM_VERTICES + 5
    src = rng.integers(lo, hi, NUM_EDGES).astype(np.int32)
    dst = rng.integers(lo, hi, NUM_EDGES).astype(np.int32)
    frontier = rng.random(NUM_VERTICES) < 0.5
    frontier[[0, NUM_VERTICES - 1]] = True
    visited = rng.random(NUM_VERTICES) < 0.2
    visited[[0, NUM_VERTICES - 1]] = False
    want = check_case(src, dst, frontier, visited)
    assert want[0] and want[NUM_VERTICES - 1]


def test_frontier_pull_no_edges():
    none = np.zeros((0,), np.int32)
    frontier = np.ones(8, bool)
    assert not check_case(none, none, frontier, np.zeros(8, bool)).any()


def test_frontier_pull_everything_visited():
    rng = np.random.default_rng(5)
    src = rng.integers(0, NUM_VERTICES, NUM_EDGES).astype(np.int32)
    dst = rng.integers(0, NUM_VERTICES, NUM_EDGES).astype(np.int32)
    full = np.ones(NUM_VERTICES, bool)
    assert not check_case(src, dst, full, full).any()


def test_frontier_pull_cuda_launcher_rejects_cpu_tensors():
    from repro_torch.kernels.frontier_pull import frontier_pull_cuda
    idx = torch.zeros((4,), dtype=torch.int32)
    bits = torch.zeros((3,), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        frontier_pull_cuda(idx, idx, idx, bits, bits)
