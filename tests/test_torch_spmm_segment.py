"""The port's plain ``spmm_segment`` and its wrapper on CPU tensors against
the JAX Pallas kernel (``spmm_segment(..., use_pallas=True)``, interpret
mode), the JAX ``spmm_segment_ref`` and ``gcn_norm_spmm``, at the shapes of
tests/test_kernels.py, with ``src == N`` padding and empty segments.
Every ``dst`` stays in range: there the Pallas kernel clamps where its
plain version drops (a reference caveat).

The shared tile cases (``spmm_tile_case``: hubs beside the card
kernel's tile starts and hub threshold, medium rows, dropped edges, empty
inputs) go through the port's plain version, its wrapper and
``spmm_segment_sorted`` against the JAX ``spmm_segment_ref`` at D = 1, 17
and 128, one small hub against the Pallas kernel too; the launcher's
host-side tile plan is checked without a card.

Tolerance ``rtol = 1e-5, atol = 1e-5`` (tests/test_semiring.py's for the
kernel against its plain version): the Pallas kernel sums a row in sorted
edge order from its first term, the plain versions add into zeros.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.spmm_segment import (gcn_norm_spmm, spmm_segment,
                                        spmm_segment_ref)
from repro_torch.kernels.spmm_segment import ops as spmm_ops
from repro_torch.kernels.spmm_segment import \
    spmm_segment_ref as port_spmm_segment_ref
from repro_torch.kernels.spmm_segment.ref import SPMM_CASES, spmm_tile_case
from repro_torch.kernels.spmm_segment.spmm_segment import (SHORT_ROW,
                                                           tile_plan,
                                                           tile_scratch)
from test_torch_engine import release_reference_executables  # noqa: F401

SHAPES = [(10, 30, 4), (50, 200, 17), (30, 100, 128)]
TOL = dict(rtol=1e-5, atol=1e-5)


def inputs(n, e, d, seed):
    """Random features and weights; every 7th source is the padding N and
    destinations cover only the lower two thirds of the rows, so the rest
    are empty segments."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    src[::7] = n
    dst = rng.integers(0, max(1, 2 * n // 3), e).astype(np.int32)
    w = rng.standard_normal(e).astype(np.float32)
    return x, src, dst, w


def port_results(x, src, dst, w, n):
    """The port's plain version, its wrapper, and the sorted half of the
    wrapper, on CPU tensors: no kernel launches."""
    t = [torch.from_numpy(a) for a in (x, src, dst, w)]
    before = spmm_ops.LAUNCHES
    seg = spmm_ops.segments(t[2], n)
    out = [port_spmm_segment_ref(*t, n), spmm_ops.spmm_segment(*t, n),
           spmm_ops.spmm_segment_sorted(t[0], t[1][seg.order], seg.seg,
                                        t[3][seg.order], seg.offsets)]
    assert spmm_ops.LAUNCHES == before
    return [o.numpy() for o in out]


@pytest.mark.parametrize("n,e,d", SHAPES)
def test_spmm_segment_matches_reference(n, e, d):
    x, src, dst, w = inputs(n, e, d, n * e + d)
    args = [jnp.asarray(a) for a in (x, src, dst, w)]
    want = np.asarray(spmm_segment_ref(*args, n))
    kernel = np.asarray(spmm_segment(*args, n, use_pallas=True,
                                     interpret=True))
    np.testing.assert_allclose(kernel, want, **TOL)
    for got in port_results(x, src, dst, w, n):
        assert got.shape == (n, d) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, kernel, **TOL)
        assert not got[2 * n // 3 + 1:].any()      # empty segments are 0

    # unit weights (None), and the symmetric-normalized variant
    want = np.asarray(spmm_segment(*args[:3], None, n))
    got = spmm_ops.spmm_segment(*[torch.from_numpy(a)
                                  for a in (x, src, dst)], None, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ok = src < n                 # gcn_norm_spmm takes real sources only
    args = [jnp.asarray(a[ok]) if a is not x else jnp.asarray(a)
            for a in (x, src, dst)]
    want = np.asarray(gcn_norm_spmm(*args, n, use_pallas=True,
                                    interpret=True))
    got = spmm_ops.gcn_norm_spmm(*[torch.from_numpy(np.array(a))
                                   for a in args], n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_spmm_segment_no_edges():
    n, d = 6, 3
    x = np.ones((n, d), np.float32)
    none = np.zeros((0,), np.int32)
    want = np.asarray(spmm_segment_ref(jnp.asarray(x), jnp.asarray(none),
                                       jnp.asarray(none),
                                       jnp.zeros((0,), jnp.float32), n))
    assert not want.any()
    for got in port_results(x, none, none, np.zeros((0,), np.float32), n):
        np.testing.assert_array_equal(got, want)


def test_segments_order_and_offsets():
    """A stable order by destination; row v owns offsets[v]:offsets[v+1];
    a destination outside [0, num_out) falls outside every row, and the
    plain versions drop it."""
    dst = torch.tensor([3, -1, 0, 3, 5, 0, 2], dtype=torch.int32)
    seg = spmm_ops.segments(dst, 4)
    assert seg.order.tolist() == [1, 2, 5, 6, 0, 3, 4]
    assert seg.offsets.dtype == torch.int32
    assert seg.offsets.tolist() == [1, 3, 3, 4, 6]
    x = torch.arange(8, dtype=torch.float32)[:, None]
    src = torch.arange(7, dtype=torch.int32)
    w = torch.ones(7)
    out = port_spmm_segment_ref(x, src, dst, w, 4)
    assert out[:, 0].tolist() == [2.0 + 5.0, 0.0, 6.0, 0.0 + 3.0]
    assert torch.equal(spmm_ops.spmm_segment_sorted(
        x, src[seg.order], seg.seg, w[seg.order], seg.offsets), out)


def test_spmm_segment_cuda_launcher_rejects_cpu_tensors():
    from repro_torch.kernels.spmm_segment import spmm_segment_cuda
    x = torch.zeros((4, 2))
    idx = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        spmm_segment_cuda(x, idx, torch.zeros(3), idx)


@pytest.mark.parametrize("d", [1, 17, 128])
@pytest.mark.parametrize("case", SPMM_CASES)
def test_spmm_tile_cases_match_reference(case, d):
    """Every shared tile case, hubs and dropped edges included: the port's
    plain version, its CPU wrapper and the sorted half equal the JAX
    plain version within TOL, and rows with no live edge are 0."""
    x, src, dst, w, n_out = spmm_tile_case(case, d)
    want = np.asarray(spmm_segment_ref(
        *[jnp.asarray(a) for a in (x, src, dst, w)], n_out))
    live = (dst >= 0) & (dst < n_out) & (src < x.shape[0])
    empty = np.bincount(dst[live], minlength=n_out) == 0
    for got in port_results(x, src, dst, w, n_out):
        assert got.shape == (n_out, d) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)
        assert not got[empty].any()


def test_spmm_small_hub_matches_pallas_kernel():
    """A hub of 520 edges (above H = 512 at D = 16) among 40 short rows:
    the port's versions against the interpret-mode Pallas kernel."""
    rng = np.random.default_rng(19)
    n, d, n_out = 50, 16, 40
    assert 520 > tile_plan(600, d).hub_edges
    dst = np.concatenate([np.repeat(np.arange(n_out),
                                    rng.integers(0, 4, n_out)),
                          np.full(520, 7)]).astype(np.int32)
    src = rng.integers(0, n + 1, dst.shape[0]).astype(np.int32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(dst.shape[0]).astype(np.float32)
    kernel = np.asarray(spmm_segment(
        *[jnp.asarray(a) for a in (x, src, dst, w)], n_out, use_pallas=True,
        interpret=True))
    for got in port_results(x, src, dst, w, n_out):
        np.testing.assert_allclose(got, kernel, **TOL)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8, 16, 17, 32, 64, 128, 1000])
def test_tile_plan_covers_every_edge(d):
    """The launcher's plan at every width: P a power of two above the
    short-row length, H = 2P (every hub holds two tile starts), tile
    starts k * P for k < T covering [0, E) exactly when E > H and none
    otherwise, scratch of T * (D + 1) words ((T, D) partials and (T,) tile
    rows), and no thread walking more than 64 edges of a tile with its
    prefix (< 2P) or of a medium row (<= H)."""
    slots = 256 // min(32, 1 << (d - 1).bit_length())
    for e in (0, 1, 255, 256, 511, 512, 513, 2047, 2048, 4096, 4097,
              8192, 8193, 10 ** 6, 2 ** 31 - 1):
        p, h, t = tile_plan(e, d)
        assert p > SHORT_ROW and p & (p - 1) == 0 and h == 2 * p
        assert -(-h // slots) <= 64
        if e > h:
            assert (t - 1) * p < e <= t * p
        else:
            assert t == 0
        if e <= 10 ** 6:
            plan, scratch = tile_scratch(e, d, "cpu")
            assert plan == (p, h, t)
            assert scratch.shape == (t * (d + 1),)      # partials, tile_row
            assert scratch.dtype == torch.float32
