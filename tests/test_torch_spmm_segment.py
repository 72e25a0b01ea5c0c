"""The port's plain ``spmm_segment`` and its wrapper on CPU tensors against
the JAX Pallas kernel (``spmm_segment(..., use_pallas=True)``, interpret
mode), the JAX ``spmm_segment_ref`` and ``gcn_norm_spmm``, at the shapes of
tests/test_kernels.py, with ``src == N`` padding and empty segments.
Every ``dst`` stays in range: there the Pallas kernel clamps where its
plain version drops (a reference caveat).

Tolerance ``rtol = 1e-5, atol = 1e-5`` (tests/test_semiring.py's for the
kernel against its plain version): the kernel sums a row in sorted edge
order from its first term, the plain versions add into zeros.
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
