"""The port's plain ``embedding_bag`` and its wrappers on CPU tensors against
the JAX Pallas kernel (``embedding_bag(..., use_pallas=True)``, interpret
mode) and the JAX ``embedding_bag_ref``, at tests/test_kernels.py's sweep
(d in {1, 7, 10, 128, 200}, weighted or not, unsorted segments, empty
bags, the mean combiner), and ``fixed_hot_lookup`` against the
reference's.

Negative indices and segment ids outside [0, num_bags) are compared with
``embedding_bag_ref`` only: there the Pallas kernel clamps a segment id
into the last bag and overwrites it, where its plain version drops it (a
reference caveat the port does not copy).

The shared layout cases (``bag_layout_case``: every layout of the card
kernel, bags of 0, 1, K - 1, K, K + 1, 39 and 3,000 entries, a table at a
storage offset) go through the port's three CPU routes against the JAX
``embedding_bag_ref``; an index below -R contributes zero in the port,
where ``jnp.take`` fills NaN, so the JAX side gets such an entry as index
0 with weight 0 (the same zero term, counted by ``mean`` as both count
it).  Their clean variants (no negative index, no dropped entry) also go
through the interpret-mode Pallas kernel.

Tolerance ``rtol = 1e-5, atol = 1e-5``: the Pallas kernel sums a bag in
sorted order from a sentinel row, the plain versions add into zeros in
their own order.  A gather does no arithmetic, so ``fixed_hot_lookup`` is
exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.embedding_bag import (embedding_bag, embedding_bag_ref,
                                         fixed_hot_lookup)
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import \
    embedding_bag_ref as port_embedding_bag_ref
from repro_torch.kernels.embedding_bag import bag_layout
from repro_torch.kernels.embedding_bag.ref import (BAG_LAYOUT_CASES,
                                                   bag_layout_case,
                                                   layout_table)
from repro_torch.kernels.spmm_segment.ops import segments
from test_torch_engine import release_reference_executables  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
R, I, B = 40, 70, 9
EMPTY = (4, 8)        # bags that get no entry


def inputs(d, weighted, seed):
    """tests/test_kernels.py's shapes: 70 indices in [0, R + 3) (the last
    three are padding) into 9 bags, unsorted, bags 4 and 8 empty."""
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((R, d)).astype(np.float32)
    idx = rng.integers(0, R + 3, I).astype(np.int32)
    bags = [b for b in range(B) if b not in EMPTY]
    seg = rng.choice(bags, I).astype(np.int32)
    w = rng.standard_normal(I).astype(np.float32) if weighted else None
    return tab, idx, seg, w


def jax_args(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def torch_args(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def port_results(tab, idx, seg, w, num_bags=B, combiner="sum", t=None):
    """The port's plain version, its wrapper and the wrapper's sorted half,
    on CPU tensors (the table ``t`` where given, else ``tab``): no kernel
    launches."""
    tt, i, s, ww = torch_args(tab, idx, seg, w)
    t = tt if t is None else t
    before = eb_ops.LAUNCHES
    sg = segments(s, num_bags)
    out = [port_embedding_bag_ref(t, i, s, num_bags, ww, combiner=combiner),
           eb_ops.embedding_bag(t, i, s, num_bags, ww, combiner=combiner),
           eb_ops.embedding_bag_sorted(
               t, i[sg.order], sg.seg, None if ww is None else ww[sg.order],
               sg.offsets, combiner=combiner)]
    assert eb_ops.LAUNCHES == before
    return [o.numpy() for o in out]


@pytest.mark.parametrize("d", [1, 7, 10, 128, 200])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(d, weighted):
    tab, idx, seg, w = inputs(d, weighted, d * 2 + weighted)
    args = jax_args(tab, idx, seg, w)
    want = np.asarray(embedding_bag_ref(*args[:3], B, args[3]))
    kernel = np.asarray(embedding_bag(*args[:3], B, args[3],
                                      use_pallas=True))
    np.testing.assert_allclose(kernel, want, **TOL)
    for got in port_results(tab, idx, seg, w):
        assert got.shape == (B, d) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, kernel, **TOL)
        assert not got[list(EMPTY)].any()             # empty bags are 0


@pytest.mark.parametrize("d,weighted", [(1, False), (10, True), (128, True)])
def test_embedding_bag_mean_matches_reference(d, weighted):
    tab, idx, seg, w = inputs(d, weighted, 100 + d)
    args = jax_args(tab, idx, seg, w)
    want = np.asarray(embedding_bag(*args[:3], B, args[3], combiner="mean"))
    kernel = np.asarray(embedding_bag(*args[:3], B, args[3],
                                      combiner="mean", use_pallas=True))
    np.testing.assert_allclose(kernel, want, **TOL)
    for got in port_results(tab, idx, seg, w, combiner="mean"):
        np.testing.assert_allclose(got, want, **TOL)


def test_embedding_bag_mean_combiner():
    """tests/test_kernels.py's case: bag 0 averages two rows of the
    identity, bag 2 is empty and stays zero."""
    tab = np.eye(6, dtype=np.float32)
    idx = np.asarray([0, 1, 2, 3], np.int32)
    seg = np.asarray([0, 0, 1, 1], np.int32)
    for combiner in ("mean", "sum"):
        want = np.asarray(embedding_bag(*jax_args(tab, idx, seg), 3,
                                        combiner=combiner, use_pallas=True))
        got = eb_ops.embedding_bag(*torch_args(tab, idx, seg), 3,
                                   combiner=combiner).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    assert np.allclose(got[0], [1, 1, 0, 0, 0, 0])
    got = eb_ops.embedding_bag(*torch_args(tab, idx, seg), 3,
                               combiner="mean").numpy()
    assert np.allclose(got[0], [0.5, 0.5, 0, 0, 0, 0])
    assert not got[2].any()


def test_embedding_bag_negative_indices_and_dropped_segments():
    """``seg = [0, 0, 1, 5, -1]`` into 3 bags gives bag 2 =
    [0, 0] (the reference's plain version drops 5 and -1; its Pallas path
    would give [6, 7]), and a negative index in [-R, 0) reads row R + i."""
    tab = np.arange(12, dtype=np.float32).reshape(6, 2)
    seg = np.asarray([0, 0, 1, 5, -1], np.int32)
    for idx in ([0, 1, 2, 3, 4], [-1, -6, 2, 7, -3], [5, -2, -6, 0, 6]):
        idx = np.asarray(idx, np.int32)
        for w in (None, np.asarray([1.5, -2, 0.25, 3, 4], np.float32)):
            for combiner in ("sum", "mean"):
                want = np.asarray(embedding_bag(*jax_args(tab, idx, seg), 3,
                                                *jax_args(w),
                                                combiner=combiner))
                for got in port_results(tab, idx, seg, w, 3, combiner):
                    np.testing.assert_allclose(got, want, **TOL)
    got = eb_ops.embedding_bag(*torch_args(tab, np.arange(5, dtype=np.int32),
                                           seg), 3).numpy()
    assert got.tolist() == [[2.0, 4.0], [4.0, 5.0], [0.0, 0.0]]
    got = eb_ops.embedding_bag(*torch_args(
        tab, np.asarray([-1, -6], np.int32), np.asarray([0, 1], np.int32)),
        2).numpy()
    assert got.tolist() == [[10.0, 11.0], [0.0, 1.0]]


@pytest.mark.parametrize("seed", range(4))
def test_embedding_bag_random_out_of_range_matches_plain_reference(seed):
    """Indices in [-R, R + 5) and segment ids in [-2, B + 2), weighted:
    equal to ``embedding_bag_ref``."""
    rng = np.random.default_rng(seed)
    d = int(rng.integers(1, 20))
    tab = rng.standard_normal((R, d)).astype(np.float32)
    idx = rng.integers(-R, R + 5, I).astype(np.int32)
    seg = rng.integers(-2, B + 2, I).astype(np.int32)
    w = rng.standard_normal(I).astype(np.float32)
    want = np.asarray(embedding_bag_ref(*jax_args(tab, idx, seg), B,
                                        jnp.asarray(w)))
    for got in port_results(tab, idx, seg, w):
        np.testing.assert_allclose(got, want, **TOL)


def test_embedding_bag_no_entries():
    tab = np.ones((5, 3), np.float32)
    none = np.zeros((0,), np.int32)
    for got in port_results(tab, none, none, None, 4, "mean"):
        assert got.shape == (4, 3) and not got.any()


@pytest.mark.parametrize("b,k", [(4, 5), (8, 39)])
def test_fixed_hot_lookup_matches_reference(b, k):
    rng = np.random.default_rng(b * k)
    tab = rng.standard_normal((30, 8)).astype(np.float32)
    ids = rng.integers(0, 30, (b, k)).astype(np.int32)
    want = np.asarray(fixed_hot_lookup(*jax_args(tab, ids), use_pallas=True))
    np.testing.assert_array_equal(
        want, np.asarray(fixed_hot_lookup(*jax_args(tab, ids))))
    got = eb_ops.fixed_hot_lookup(*torch_args(tab, ids))
    assert got.shape == (b, k, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_embedding_bag_rejects_unknown_combiner():
    t, i = torch.zeros((3, 2)), torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="combiner"):
        eb_ops.embedding_bag(t, i, i, 2, combiner="max")


def test_embedding_bag_cuda_launcher_rejects_cpu_tensors():
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    tab = torch.zeros((4, 2))
    idx = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_cuda(tab, idx, None, torch.zeros((2,),
                                                       dtype=torch.int32))


def jax_layout_args(tab, idx, seg, w):
    """The JAX reference's arguments for a layout case: an index below -R
    becomes index 0 with weight 0 (the port's zero term)."""
    below = idx < -tab.shape[0]
    ones = np.ones(idx.shape, np.float32) if w is None else w
    return jax_args(tab, np.where(below, 0, idx).astype(np.int32), seg,
                    np.where(below, 0, ones).astype(np.float32))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", BAG_LAYOUT_CASES)
def test_embedding_bag_layout_cases_match_reference(case, weighted,
                                                    combiner):
    tab, idx, seg, w, b, offset = bag_layout_case(case)
    w = w if weighted else None
    t = layout_table(tab, offset)
    assert t.is_contiguous() and t.storage_offset() == int(offset)
    want = np.asarray(embedding_bag(*jax_layout_args(tab, idx, seg, w)[:3],
                                    b, jax_layout_args(tab, idx, seg, w)[3],
                                    combiner=combiner))
    assert np.isfinite(want).all()
    for got in port_results(tab, idx, seg, w, b, combiner, t):
        assert got.shape == (b, tab.shape[1]) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **TOL)
        assert not got[[0, b - 1]].any()               # empty bags are 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", BAG_LAYOUT_CASES)
def test_embedding_bag_clean_layout_cases_match_pallas(case, weighted):
    tab, idx, seg, w, b, offset = bag_layout_case(case, clean=True)
    w = w if weighted else None
    args = jax_args(tab, idx, seg, w)
    want = np.asarray(embedding_bag_ref(*args[:3], b, args[3]))
    kernel = np.asarray(embedding_bag(*args[:3], b, args[3],
                                      use_pallas=True))
    np.testing.assert_allclose(kernel, want, **TOL)
    for got in port_results(tab, idx, seg, w, b,
                            t=layout_table(tab, offset)):
        np.testing.assert_allclose(got, kernel, **TOL)


def test_bag_layout_cases_cover_the_kernel_layouts():
    """The cases reach every vector width, 1-4 accumulators a lane, one
    and several bags a warp, the column split, and batch sizes K = 8 and
    4; the offset view of an aligned base takes the scalar path."""
    seen = set()
    for case in BAG_LAYOUT_CASES:
        tab, _, seg, _, b, offset = bag_layout_case(case)
        t = layout_table(tab, offset)
        layout = bag_layout(tab.shape[1], t.data_ptr())
        assert layout == bag_layout(tab.shape[1], 4 if offset else 0)
        if offset:
            assert layout.vec == 1
        sizes = np.bincount(seg[(seg >= 0) & (seg < b)], minlength=b)
        k = layout.batch
        assert sizes[:7].tolist() == [0, 1, k - 1, k, k + 1, 39, 3000]
        seen.add(layout[:2] + layout[3:])
    assert {v for v, *_ in seen} == {1, 2, 4}
    assert {c for _, _, c, _, _ in seen} == {1, 2, 3, 4}
    assert any(s > 1 for *_, s, _ in seen)
    assert {k for *_, k in seen} == {4, 8}


@pytest.mark.parametrize("dim,ptr,want", [
    (1, 0, (1, 1, 32, 1, 1, 8)),
    (2, 8, (2, 1, 32, 1, 1, 8)),
    (2, 4, (1, 2, 16, 1, 1, 8)),
    (10, 0, (2, 5, 6, 1, 1, 8)),
    (10, 4, (1, 10, 3, 1, 1, 8)),
    (16, 16, (4, 4, 8, 1, 1, 8)),
    (16, 8, (2, 8, 4, 1, 1, 8)),
    (17, 0, (1, 17, 1, 1, 1, 8)),
    (128, 0, (4, 32, 1, 1, 1, 8)),
    (128, 4, (1, 32, 1, 4, 1, 4)),
    (200, 0, (4, 32, 1, 2, 1, 4)),
    (512, 0, (4, 32, 1, 4, 1, 4)),
    (516, 0, (4, 32, 1, 4, 2, 4)),
    (129, 0, (1, 32, 1, 4, 2, 4)),
])
def test_bag_layout_choice(dim, ptr, want):
    """float4 needs D % 4 == 0 and a 16-byte aligned table, float2 D % 2
    == 0 and 8 bytes; U <= 32 units take U lanes and floor(32 / U) bags a
    warp; up to 128 units 32 lanes with ceil(U / 32) accumulators; wider
    rows are cut into slices of 128 units."""
    assert tuple(bag_layout(dim, ptr)) == want


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_empty_table_raises_index_error_like_reference(weighted, combiner):
    """An empty table (R = 0) and at least one index: the reference's
    plain ``embedding_bag`` raises IndexError (``jnp.take`` from an empty
    axis), and so do the port's three CPU routes, without a launch; with
    no index the result is still zero bags."""
    tab = np.zeros((0, 4), np.float32)
    idx = np.array([0, 2, -1], np.int32)
    seg = np.array([0, 1, 1], np.int32)
    w = np.ones(3, np.float32) if weighted else None
    with pytest.raises(IndexError):
        embedding_bag(*jax_args(tab, idx, seg), 2,
                      None if w is None else jnp.asarray(w),
                      combiner=combiner)
    before = eb_ops.LAUNCHES
    t_tab, t_idx, t_seg = torch_args(tab, idx, seg)
    t_w = None if w is None else torch.from_numpy(w)
    s = segments(t_seg, 2)
    for call in (
            lambda: eb_ops.embedding_bag(t_tab, t_idx, t_seg, 2, t_w,
                                         combiner=combiner),
            lambda: port_embedding_bag_ref(t_tab, t_idx, t_seg, 2, t_w,
                                           combiner=combiner),
            lambda: eb_ops.embedding_bag_sorted(
                t_tab, t_idx[s.order], s.seg,
                None if t_w is None else t_w[s.order], s.offsets,
                combiner=combiner)):
        with pytest.raises(IndexError):
            call()
    assert eb_ops.LAUNCHES == before
    none = torch.zeros((0,), dtype=torch.int32)
    got = eb_ops.embedding_bag(t_tab, none, none, 2, combiner=combiner)
    assert got.shape == (2, 4) and not got.any()
