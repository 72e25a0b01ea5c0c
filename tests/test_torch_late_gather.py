"""The port's plain ``late_gather`` and ``late_gather_columns`` against the
JAX Pallas kernel (interpret mode, as tests/test_kernels.py runs it) and
the JAX oracle.

Inputs are made with numpy from a seed and handed to both packages.  A
gather does no arithmetic, so equality is exact, bit for bit (the
tolerance is 0).  A position in [-R, 0) counts from the end once in both
JAX paths and in the port; below -R the two JAX paths disagree (NaN
against row 0), and the port gives a zero row.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.embedding_bag.ops import \
    fixed_hot_lookup as jax_fixed_hot_lookup
from repro.kernels.late_gather import late_gather_pallas, late_gather_ref
from repro.kernels.late_gather.ops import late_gather as jax_late_gather
from repro_torch.core.table import ColumnTable
from repro_torch.kernels.embedding_bag.ops import fixed_hot_lookup
from repro_torch.kernels.late_gather import late_gather as port_late_gather
from repro_torch.kernels.late_gather import late_gather_columns
from repro_torch.kernels.late_gather.ref import \
    late_gather_ref as port_late_gather_ref
from test_torch_engine import release_reference_executables  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32, np.uint32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16),
          "int32": (jnp.int32, torch.int32, np.uint32)}


def to_torch(a) -> "torch.Tensor":
    """A JAX array as a torch tensor of the same dtype and bits (numpy has
    no bfloat16 of its own, so 2-byte floats cross as raw bits)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(a, unsigned) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        signed = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return a.view(signed).numpy().view(unsigned)
    return np.asarray(a).view(unsigned)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("r,w,p", [(8, 1, 4), (64, 37, 25), (128, 128, 200),
                                   (33, 260, 7)])
def test_late_gather_matches_pallas_and_ref(dtype, r, w, p):
    jdt, tdt, unsigned = DTYPES[dtype]
    rng = np.random.default_rng(1000 * r + p)
    tab = jnp.asarray(rng.standard_normal((r, w)) * 10).astype(jdt)
    pos_np = rng.integers(0, r + 5, p).astype(np.int32)   # some sentinels
    want_pallas = late_gather_pallas(tab, jnp.asarray(pos_np))
    want_ref = late_gather_ref(tab, jnp.asarray(pos_np))

    got = port_late_gather(to_torch(tab), torch.from_numpy(pos_np))
    assert got.dtype == tdt and tuple(got.shape) == (p, w)
    np.testing.assert_array_equal(bits(got, unsigned),
                                  bits(want_pallas, unsigned))
    np.testing.assert_array_equal(bits(got, unsigned),
                                  bits(want_ref, unsigned))


def test_late_gather_int32_keeps_bits_above_2_pow_24():
    """The port gathers int32 columns in their own dtype: ids above 2^24,
    which an f32 round trip would round, come back exact."""
    tab = torch.tensor([[2 ** 24 + 1], [2 ** 31 - 1], [-(2 ** 24) - 3]],
                       dtype=torch.int32)
    pos = torch.tensor([2, 0, 1, 3, 9], dtype=torch.int32)
    got = port_late_gather(tab, pos)
    assert got[:, 0].tolist() == [-(2 ** 24) - 3, 2 ** 24 + 1, 2 ** 31 - 1,
                                  0, 0]


def test_late_gather_wrapper_takes_plain_version_on_cpu():
    from repro_torch.kernels.late_gather import ops
    before = ops.LAUNCHES
    tab = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    pos = torch.tensor([3, 4, 0, -1, -5], dtype=torch.int32)
    assert torch.equal(port_late_gather(tab, pos),
                       port_late_gather_ref(tab, pos))
    got = late_gather_columns([tab, tab[:, :1].to(torch.int32)], pos)
    assert torch.equal(got[0], port_late_gather_ref(tab, pos))
    assert got[1][:, 0].tolist() == [9, 0, 0, 9, 0]
    assert late_gather_columns([], pos) == []
    assert ops.LAUNCHES == before          # no kernel ran on the CPU


def test_late_gather_cuda_launcher_rejects_cpu_tensors():
    from repro_torch.kernels.late_gather import late_gather_cuda
    tab = torch.zeros((4, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        late_gather_cuda([tab], torch.zeros((2,), dtype=torch.int32))


def test_late_gather_cuda_launcher_rejects_more_than_32_columns():
    from repro_torch.kernels.late_gather import late_gather_cuda
    tab = torch.zeros((4, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="at most 32"):
        late_gather_cuda([tab] * 33, torch.zeros((2,), dtype=torch.int32))


def edge_positions(r: int) -> np.ndarray:
    """Every edge of the wrap rule: below -R, -R, -1, 0, R - 1, R, past R."""
    return np.array([-r - 1, -r, -1, 0, r - 1, r, r + 5], dtype=np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("r,w", [(6, 2), (64, 37), (33, 260)])
def test_late_gather_negative_positions_match_pallas_and_ref(dtype, r, w):
    """A position in [-R, 0) gathers row p + R in both JAX paths and the
    port, bit for bit; the JAX paths agree on every position >= -R, and
    below -R the port gives a zero row."""
    jdt, _, unsigned = DTYPES[dtype]
    rng = np.random.default_rng(r * w)
    tab = jnp.asarray(rng.standard_normal((r, w)) * 10).astype(jdt)
    pos_np = np.concatenate([edge_positions(r),
                             rng.integers(-r, r + 5, 40).astype(np.int32)])
    want_pallas = bits(late_gather_pallas(tab, jnp.asarray(pos_np)),
                       unsigned)
    want_ref = bits(late_gather_ref(tab, jnp.asarray(pos_np)), unsigned)
    got = bits(port_late_gather(to_torch(tab), torch.from_numpy(pos_np)),
               unsigned)
    inside = pos_np >= -r
    np.testing.assert_array_equal(want_pallas[inside], want_ref[inside])
    np.testing.assert_array_equal(got[inside], want_ref[inside])
    assert not got[~inside].any()


def mixed_columns(r: int, rng) -> list:
    """The columns of a ``take``: 1-D int32 ids above 2^24, (R, 4) and
    (R, 5) float32, (R, 3) bfloat16 (6-byte rows), as JAX arrays."""
    return [jnp.asarray(rng.integers(2 ** 24, 2 ** 31 - 1, r)
                        .astype(np.int32)),
            jnp.asarray(rng.standard_normal((r, 4)).astype(np.float32)),
            jnp.asarray(rng.standard_normal((r, 5)).astype(np.float32)),
            jnp.asarray(rng.standard_normal((r, 3))).astype(jnp.bfloat16)]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_late_gather_columns_matches_jax_per_column(use_pallas):
    """``late_gather_columns``' plain version on mixed columns equals the
    JAX ``late_gather`` run on each column alone (1-D as (R, 1)), bit for
    bit, at positions in [-R, R + 5]."""
    r = 50
    rng = np.random.default_rng(7)
    cols = mixed_columns(r, rng)
    pos_np = np.concatenate([edge_positions(r)[1:],
                             rng.integers(-r, r + 6, 60).astype(np.int32)])
    tables = [c.reshape(r, -1) for c in cols]
    got = late_gather_columns([to_torch(t) for t in tables],
                              torch.from_numpy(pos_np))
    assert len(got) == len(tables)
    for g, t in zip(got, tables):
        want = jax_late_gather(t, jnp.asarray(pos_np), use_pallas=use_pallas)
        unsigned = np.uint16 if t.dtype == jnp.bfloat16 else np.uint32
        assert g.dtype == to_torch(t).dtype
        np.testing.assert_array_equal(bits(g, unsigned), bits(want, unsigned))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_take_and_fixed_hot_lookup_match_jax_fixed_hot_lookup(dtype,
                                                              use_pallas):
    """The port's ``fixed_hot_lookup`` and ``ColumnTable.take`` with ids in
    [-R, R + 3] equal the reference's ``fixed_hot_lookup`` on its plain
    path and its Pallas path, bit for bit."""
    jdt, _, unsigned = DTYPES[dtype]
    r, d, b, k = 40, 10, 6, 9
    rng = np.random.default_rng(11)
    tab = jnp.asarray(rng.standard_normal((r, d))).astype(jdt)
    ids = rng.integers(-r, r + 4, (b, k)).astype(np.int32)
    ids[0, :4] = [-r, -1, r, r + 3]
    want = bits(jax_fixed_hot_lookup(tab, jnp.asarray(ids),
                                     use_pallas=use_pallas), unsigned)
    got = fixed_hot_lookup(to_torch(tab), torch.from_numpy(ids))
    assert tuple(got.shape) == (b, k, d)
    np.testing.assert_array_equal(bits(got, unsigned), want)
    table = ColumnTable({"emb": to_torch(tab),
                         "id": torch.arange(r, dtype=torch.int32)})
    taken = table.take(torch.from_numpy(ids.reshape(-1)))
    np.testing.assert_array_equal(
        bits(taken["emb"], unsigned).reshape(b, k, d), want)
    wrapped = np.where(ids < 0, ids + r, ids).reshape(-1)
    assert taken["id"].tolist() == np.where(wrapped < r, wrapped, 0).tolist()


@pytest.mark.parametrize("p", [1, 5])
def test_empty_table_raises_index_error_like_reference(p):
    """An empty table (R = 0) and at least one position: the reference's
    plain gather raises IndexError (``jnp.take`` from an empty axis), and
    so does every CPU route of the port, without a launch."""
    from repro_torch.kernels.late_gather import ops
    pos = np.arange(p, dtype=np.int32) - 1
    with pytest.raises(IndexError):
        jax_late_gather(jnp.zeros((0, 3), jnp.float32), jnp.asarray(pos))
    tab, tpos = torch.zeros((0, 3)), torch.from_numpy(pos)
    before = ops.LAUNCHES
    for call in (lambda: port_late_gather(tab, tpos),
                 lambda: port_late_gather_ref(tab, tpos),
                 lambda: late_gather_columns(
                     [tab, tab[:, :1].to(torch.int32)], tpos),
                 lambda: ColumnTable({"a": tab[:, 0]}).take(tpos),
                 lambda: fixed_hot_lookup(tab, tpos.reshape(1, -1))):
        with pytest.raises(IndexError):
            call()
    assert ops.LAUNCHES == before


def test_empty_table_without_positions_keeps_its_result():
    none = np.zeros((0,), np.int32)
    want = np.asarray(jax_late_gather(jnp.zeros((0, 3), jnp.float32),
                                      jnp.asarray(none)))
    assert want.shape == (0, 3)
    for got in (port_late_gather(torch.zeros((0, 3)), torch.from_numpy(none)),
                late_gather_columns([torch.zeros((0, 3))],
                                    torch.from_numpy(none))[0]):
        assert got.shape == (0, 3) and got.dtype == torch.float32
    taken = ColumnTable({"a": torch.zeros((0,), dtype=torch.int32),
                         "b": torch.zeros((0, 3))}).take(
        torch.from_numpy(none))
    assert taken["a"].shape == (0,) and taken["b"].shape == (0, 3)
