"""The gradients of the two kernels on the training path, on the CPU:
``spmm_segment`` (``kernels/spmm_segment/ops.py``, :class:`SpmmSegment`)
and ``late_gather`` (``kernels/late_gather/ops.py``, :class:`LateGather`).

Both run their plain versions here, in both directions, so these tests
hold the backward's logic: ``spmm_segment``'s backward is the same sum
over the edges grouped by source, and ``late_gather``'s a scatter-add
into the table's rows.  In float64, ``torch.autograd.gradcheck`` holds
each against finite differences, on padded sources (N, and negative
ones), dropped destinations (below 0 and past ``num_out``), rows with no
edge and hub rows (``spmm_tile_case``), and on wrapped, repeated and
out-of-range positions; and each gradient agrees with the reference's
``jax.grad`` of its plain function on the same inputs, in float64, within
``rtol = 1e-12``, ``atol = 1e-12`` (the same sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.embedding_bag.ops import \
    fixed_hot_lookup as ref_fixed_hot_lookup
from repro.kernels.late_gather.ref import late_gather_ref as ref_gather
from repro.kernels.spmm_segment.ref import spmm_segment_ref as ref_spmm
from repro_torch.kernels.embedding_bag.ops import fixed_hot_lookup
from repro_torch.kernels.late_gather import ops as lg_ops
from repro_torch.kernels.spmm_segment import ops as spmm_ops
from repro_torch.kernels.spmm_segment.ref import spmm_tile_case
from repro_torch.models import gnn
from test_torch_engine import release_reference_executables  # noqa: F401

F64 = torch.float64
TOL = dict(rtol=1e-12, atol=1e-12)
# padded sources, dropped destinations, rows with no edge, hubs of one
# and of many tiles, E = 0 and no output row
CASES = ("padded_hub", "dropped", "hub_kp", "hub_many_tiles", "e0",
         "empty_out", "medium_s1")
# the reference's jax.grad has no gradient of a sum into no row
JAX_CASES = tuple(c for c in CASES if c != "empty_out")
DIM = 3


def sorted_case(case, dim=DIM):
    x, src, dst, w, num_out = spmm_tile_case(case, dim)
    s = spmm_ops.segments(torch.from_numpy(dst), num_out)
    src_t = torch.from_numpy(src)
    return (torch.from_numpy(x).to(F64), src_t[s.order], s.seg,
            torch.from_numpy(w).to(F64)[s.order], s.offsets, num_out,
            (x, src, dst, w))


@pytest.mark.parametrize("grouped", [False, True], ids=["in_backward",
                                                         "given"])
@pytest.mark.parametrize("case", CASES)
def test_spmm_segment_gradcheck(case, grouped):
    x, src, seg, w, offsets, _, _ = sorted_case(case)
    t = (spmm_ops.transpose_grouping(src, seg, w, x.shape[0]) if grouped
         else None)
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: spmm_ops.spmm_segment_sorted(x, src, seg, w, offsets,
                                               transposed=t),
        (x,), fast_mode=True)


def test_spmm_segment_gradcheck_negative_sources():
    """A source below 0 is padding as N is: no gradient reaches any row."""
    rng = np.random.default_rng(0)
    n, num_out, e = 9, 6, 40
    src = torch.from_numpy(rng.integers(-3, n + 3, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(-2, num_out + 2, e).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal(e))
    s = spmm_ops.segments(dst, num_out)
    x = torch.from_numpy(rng.standard_normal((n, 4))).requires_grad_(True)
    args = (src[s.order], s.seg, w[s.order], s.offsets)
    assert torch.autograd.gradcheck(
        lambda x: spmm_ops.spmm_segment_sorted(x, *args), (x,))


@pytest.mark.parametrize("case", JAX_CASES)
def test_spmm_segment_grad_matches_jax(case):
    x, src, seg, w, offsets, num_out, host = sorted_case(case)
    x_np, src_np, dst_np, w_np = host
    cot = np.random.default_rng(1).standard_normal((num_out, DIM))
    with jax.enable_x64(True):
        want = np.asarray(jax.grad(lambda x: jnp.sum(ref_spmm(
            x, jnp.asarray(src_np), jnp.asarray(dst_np),
            jnp.asarray(w_np, jnp.float64), num_out) * cot))(
                jnp.asarray(x_np, jnp.float64)))
    x.requires_grad_(True)
    out = spmm_ops.spmm_segment_sorted(x, src, seg, w, offsets)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), want, **TOL)


def test_sort_edges_groups_the_transpose_once():
    """``sort_edges(..., transpose=True)`` holds the grouping
    ``SpmmSegment`` would build in its backward; a forward whose features
    need no gradient builds none."""
    rng = np.random.default_rng(2)
    n, e = 50, 300
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    edges = gnn.sort_edges(src, dst, n, transpose=True)
    want = spmm_ops.transpose_grouping(edges.src, edges.seg, edges.ones, n)
    for a, b in zip(edges.transposed, want):
        assert torch.equal(a, b)
    assert gnn.sort_edges(src, dst, n).transposed is None
    # each source's edges are its out-edges, in destination order
    for u in (0, 7, 49):
        lo, hi = edges.transposed.offsets[u:u + 2].tolist()
        got = edges.transposed.src[lo:hi].tolist()
        assert got == sorted(dst[src == u].tolist())


def test_spmm_segment_refuses_what_has_no_gradient():
    x, src, seg, w, offsets, _, _ = sorted_case("medium_s1")
    with pytest.raises(ValueError, match="weights"):
        spmm_ops.spmm_segment_sorted(x, src, seg, w.requires_grad_(True),
                                     offsets)
    w = w.detach()
    lanes = torch.stack([x, x]).requires_grad_(True)
    with pytest.raises(ValueError, match="one-lane"):
        spmm_ops.spmm_segment_sorted(lanes, src, seg, w, offsets)
    mask = torch.ones(lanes.shape[:2], dtype=torch.bool)
    with pytest.raises(ValueError, match="one-lane"):
        spmm_ops.spmm_segment_sorted(lanes, src, seg, w, offsets, mask)
    with torch.no_grad():      # no gradient needed: the lane call runs
        out = spmm_ops.spmm_segment_sorted(lanes, src, seg, w, offsets, mask)
    assert out.shape[0] == 2


ROWS, WIDTH = 11, 4
# in range, wrapped once from the end, repeated, past the end (the
# sentinel R and more), below -R
POSITIONS = np.array([0, 3, 3, -1, -11, 10, 11, 25, -12, -30, 5, -6, 3],
                     np.int32)


def test_late_gather_gradcheck():
    table = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (ROWS, WIDTH))).requires_grad_(True)
    pos = torch.from_numpy(POSITIONS)
    assert torch.autograd.gradcheck(lambda t: lg_ops.late_gather(t, pos),
                                    (table,))
    out = lg_ops.late_gather(table, pos)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ \
        .startswith("LateGather")


def test_late_gather_grad_matches_jax():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((ROWS, WIDTH))
    cot = rng.standard_normal((POSITIONS.shape[0], WIDTH))
    with jax.enable_x64(True):
        want = np.asarray(jax.grad(lambda t: jnp.sum(
            jnp.nan_to_num(ref_gather(t, jnp.asarray(POSITIONS))) * cot))(
                jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    lg_ops.late_gather(t, torch.from_numpy(POSITIONS)).backward(
        torch.from_numpy(cot))
    np.testing.assert_allclose(t.grad.numpy(), want, **TOL)
    # rows no position reaches get nothing
    hit = {int(p) % ROWS for p in POSITIONS if -ROWS <= p < ROWS}
    for r in set(range(ROWS)) - hit:
        assert not t.grad[r].any()


def test_fixed_hot_lookup_grad_matches_jax():
    """DeepFM's lookup, (B, K) ids, through ``late_gather``'s gradient."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((ROWS, WIDTH))
    ids = rng.integers(0, ROWS + 2, (6, 3)).astype(np.int32)
    cot = rng.standard_normal((6, 3, WIDTH))
    with jax.enable_x64(True):
        want = np.asarray(jax.grad(lambda t: jnp.sum(
            ref_fixed_hot_lookup(t, jnp.asarray(ids)) * cot))(
                jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_(True)
    fixed_hot_lookup(t, torch.from_numpy(ids)).backward(
        torch.from_numpy(cot))
    np.testing.assert_allclose(t.grad.numpy(), want, **TOL)


def test_late_gather_columns_carry_each_gradient():
    """Several tables at one set of positions: each its own gradient (an
    int table needs none)."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((ROWS, 2))).requires_grad_(True)
    b = torch.from_numpy(rng.integers(0, 9, (ROWS, 1)).astype(np.int32))
    pos = torch.from_numpy(POSITIONS)
    got_a, got_b = lg_ops.late_gather_columns([a, b], pos)
    assert got_a.grad_fn is not None and got_b.grad_fn is None
    assert torch.equal(got_b, lg_ops.late_gather(b, pos))
    got_a.sum().backward()
    want = torch.zeros(ROWS, 2, dtype=F64)
    for p in POSITIONS:
        if -ROWS <= p < ROWS:
            want[int(p) % ROWS] += 1
    assert torch.equal(a.grad, want)
