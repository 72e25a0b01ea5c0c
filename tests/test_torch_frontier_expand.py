"""The port's plain ``frontier_expand`` against the JAX Pallas kernel
(``frontier_expand_fused``, interpret mode) and the JAX engine's
``expand_frontier``, on random graphs and frontiers in the manner of
tests/test_kernels.py, plus the edge cases of ``csr.py``: no valid target,
``total == capacity``, ``total > capacity``, degree-0 and ``-1`` targets,
and the shapes that split the card kernel's tiles (``expand_case``) against
the JAX engine's plain ``expand_frontier``.

Positions, total and overflow must be exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.csr import build_csr, expand_frontier
from repro.kernels.frontier_expand import frontier_expand_fused
from repro_torch.core.csr import build_csr as port_build_csr
from repro_torch.core.csr import expand_frontier as port_expand_frontier
from repro_torch.kernels.frontier_expand import \
    frontier_expand_fused as port_frontier_expand_fused
from repro_torch.kernels.frontier_expand import EXPAND_CASES, expand_case
from test_torch_engine import release_reference_executables  # noqa: F401

# one edge count and frontier size for every seed, and capacities from a
# short list, so the interpret-mode Pallas kernel compiles a few times only
NUM_EDGES, FRONTIER = 300, 30
CAPACITIES = (24, 128, 316)


def check_case(src, num_vertices, targets, valid, capacity):
    """All four expansions of one level agree exactly."""
    csr = build_csr(jnp.asarray(src), num_vertices)
    jt, jv = jnp.asarray(targets), jnp.asarray(valid)
    want = [np.asarray(x) for x in expand_frontier(csr, jt, jv, capacity)]
    pallas = [np.asarray(x)
              for x in frontier_expand_fused(csr, jt, jv, capacity)]

    pcsr = port_build_csr(torch.from_numpy(src), num_vertices)
    pt, pv = torch.from_numpy(targets), torch.from_numpy(valid)
    for fn in (port_expand_frontier, port_frontier_expand_fused):
        got = [x.numpy() for x in fn(pcsr, pt, pv, capacity)]
        assert got[0].dtype == np.int32 and got[0].shape == (capacity,)
        for g, w, p in zip(got, want, pallas):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)
    return int(want[1]), bool(want[2])


@pytest.mark.parametrize("seed", range(15))
def test_frontier_expand_random(seed):
    rng = np.random.default_rng(seed)
    v = int(rng.integers(4, 60))
    src = rng.integers(0, v, NUM_EDGES).astype(np.int32)
    targets = rng.integers(-1, v, FRONTIER).astype(np.int32)
    valid = rng.random(FRONTIER) < 0.8
    check_case(src, v, targets, valid, CAPACITIES[seed % len(CAPACITIES)])


# the edge cases share one frontier size and capacity (one Pallas compile);
# the frontier is larger than the capacity, and unused slots are invalid
EDGE_FRONTIER, EDGE_CAPACITY = 12, 8


def edge_case(targets, valid):
    """Expand ``targets`` over a star graph: vertex 0 has 5 out-edges,
    vertex 1 has 3, vertex 2 none.  Returns (min(total, cap), overflow)."""
    src = np.array([1, 0, 0, 1, 0, 3, 0, 1, 0], np.int32)
    t = np.full(EDGE_FRONTIER, -1, np.int32)
    t[:len(targets)] = targets
    m = np.zeros(EDGE_FRONTIER, bool)
    m[:len(valid)] = valid
    return check_case(src, 4, t, m, EDGE_CAPACITY)


def test_frontier_expand_no_valid_target():
    assert edge_case([0, 1, 0], [0, 0, 0]) == (0, False)


def test_frontier_expand_total_equals_capacity():
    assert edge_case([0, 1, 2], [1, 1, 1]) == (8, False)


def test_frontier_expand_total_above_capacity():
    assert edge_case([0, 1, 0], [1, 1, 1]) == (8, True)


def test_frontier_expand_degree_zero_and_negative_targets():
    assert edge_case([2, -1, 1, 2, -1, 1], [1, 1, 1, 1, 0, 1]) == (6, False)


def test_frontier_expand_frontier_larger_than_capacity():
    assert edge_case([1] * EDGE_FRONTIER, [1] * EDGE_FRONTIER) == (8, True)


# the reference's plain version raises at F = 0 and E = 0 (a gather from an
# empty array); tests/test_torch_cuda.py holds the kernel to the port's
# plain version there
TILE_CASES = [c for c in EXPAND_CASES if c not in ("f0", "e0")]


@pytest.mark.parametrize("case", TILE_CASES)
def test_frontier_expand_tile_cases_match_reference(case):
    """F beside the 2,048-target scan tile, a zero-degree run longer than a
    tile, a hub whose range spans several 256-slot output tiles, a total on
    an output tile edge, cuts, out-of-range valid targets and F = 1: the
    port's plain version and its CPU wrapper equal the JAX engine's plain
    ``expand_frontier``."""
    src, v, targets, valid, capacity = expand_case(case)
    csr = build_csr(jnp.asarray(src), v)
    want = [np.asarray(x) for x in expand_frontier(
        csr, jnp.asarray(targets), jnp.asarray(valid), capacity)]
    pcsr = port_build_csr(torch.from_numpy(src), v)
    pt, pv = torch.from_numpy(targets), torch.from_numpy(valid)
    for fn in (port_expand_frontier, port_frontier_expand_fused):
        got = [x.numpy() for x in fn(pcsr, pt, pv, capacity)]
        assert got[0].dtype == np.int32 and got[0].shape == (capacity,)
        assert got[1].dtype == np.int32 and got[2].dtype == np.bool_
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
