"""The port's storage layer and BFS primitives against the JAX reference:
the tree generator, ``build_csr``, ``compact_mask``, ``append_block``,
``ColumnTable.take``, ``or_combine``, ``dedup_targets`` and the fused
bidirectional expansion.  Inputs are made with numpy from a seed and handed
to both packages; integer outputs must be exactly equal, and gathered
floats too (a gather does no arithmetic).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import csr as jcsr
from repro.core import positions as jpos
from repro.core.operators import dedup_targets
from repro.core.semiring import or_combine
from repro.core.table import ColumnTable
from repro.data import treegen as jtreegen
from repro_torch.core import csr as pcsr
from repro_torch.core import positions as ppos
from repro_torch.core.operators import dedup_targets as port_dedup_targets
from repro_torch.core.semiring import or_combine as port_or_combine
from repro_torch.core.table import ColumnTable as PortColumnTable
from repro_torch.data import treegen as ptreegen
from test_torch_engine import release_reference_executables  # noqa: F401


def t(a) -> "torch.Tensor":
    return torch.from_numpy(np.array(a))


def same(got: "torch.Tensor", want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", [(3000, 10, 4, 11), (500, 6, 0, 3),
                                  (2048, 12, 2, 0)])
def test_treegen_copy_gives_reference_arrays(spec):
    cols = ptreegen.make_edge_table(ptreegen.TreeSpec(*spec))
    ref = jtreegen.make_edge_table(jtreegen.TreeSpec(*spec))
    assert sorted(cols) == sorted(ref.columns)
    for k, v in cols.items():
        want = np.asarray(ref.columns[k])
        assert v.dtype == want.dtype
        np.testing.assert_array_equal(v, want)
    src, dst = cols["from"], cols["to"]
    assert (ptreegen.bfs_reference(src, dst, 0, spec[1], spec[0])
            == jtreegen.bfs_reference(src, dst, 0, spec[1], spec[0]))


@pytest.mark.parametrize("seed", range(4))
def test_build_csr_matches_reference(seed):
    rng = np.random.default_rng(seed)
    v = int(rng.integers(3, 50))
    src = rng.integers(0, v, int(rng.integers(1, 400))).astype(np.int32)
    want = jcsr.build_csr(jnp.asarray(src), v)
    got = pcsr.build_csr(t(src), v)
    same(got.indptr, want.indptr)
    same(got.perm, want.perm)


@pytest.mark.parametrize("seed", range(3))
def test_build_csr_out_of_range_sources_match_reference(seed):
    """Sources in [-2V, 2V): negative ones count where a JAX index puts
    them, the rest outside [0, V) are left out of ``indptr``; ``perm``
    keeps every edge."""
    rng = np.random.default_rng(seed)
    v = int(rng.integers(3, 50))
    src = rng.integers(-2 * v, 2 * v, 300).astype(np.int32)
    want = jcsr.build_csr(jnp.asarray(src), v)
    got = pcsr.build_csr(t(src), v)
    same(got.indptr, want.indptr)
    same(got.perm, want.perm)


@pytest.mark.parametrize("capacity", [1, 7, 40, 64])
def test_compact_mask_matches_reference(capacity):
    mask = np.random.default_rng(capacity).random(50) < 0.4
    want = jpos.compact_mask(jnp.asarray(mask), capacity, 50)
    got = ppos.compact_mask(t(mask), capacity, 50)
    same(got.positions, want.positions)
    same(got.count, want.count)


@pytest.mark.parametrize("buf_count,block_count", [(0, 5), (10, 8), (14, 8),
                                                   (20, 3), (3, 0)])
def test_append_block_matches_reference(buf_count, block_count):
    rng = np.random.default_rng(buf_count)
    buf = rng.integers(0, 99, 20).astype(np.int32)
    blk = np.full(8, 77, np.int32)
    blk[:block_count] = rng.integers(0, 99, block_count)
    jb = jpos.PosBlock(jnp.asarray(blk), jnp.int32(block_count))
    pb = ppos.PosBlock(t(blk), torch.tensor(block_count, dtype=torch.int32))
    want = jpos.append_block(jnp.asarray(buf), jnp.int32(buf_count), jb)
    got = ppos.append_block(t(buf), torch.tensor(buf_count,
                                                 dtype=torch.int32), pb)
    for g, w in zip(got, want):
        same(g, w)


def test_column_table_take_matches_reference():
    rng = np.random.default_rng(5)
    cols = {"id": rng.permutation(40).astype(np.int32),
            "to": rng.integers(0, 2 ** 30, 40).astype(np.int32),
            "name": rng.standard_normal((40, 4)).astype(np.float32),
            "w": rng.standard_normal(40).astype(np.float32)}
    pos = np.array([0, 39, 40, 7, 41, 7, 12], np.int32)   # 40, 41: sentinels
    want = ColumnTable.from_numpy(cols).take(jnp.asarray(pos))
    got = PortColumnTable.from_numpy(cols, "cpu").take(t(pos))
    assert sorted(got) == sorted(want)
    for k in want:
        same(got[k], want[k])


@pytest.mark.parametrize("seed", range(3))
def test_or_combine_and_dedup_match_reference(seed):
    rng = np.random.default_rng(seed)
    nv, cap = 30, 40
    visited = rng.random(nv) < 0.3
    targets = rng.integers(-1, nv, cap).astype(np.int32)
    valid = rng.random(cap) < 0.8
    safe = np.clip(targets, 0, nv - 1)
    same(port_or_combine(t(visited), t(safe), t(valid)),
         or_combine(jnp.asarray(visited), jnp.asarray(safe),
                    jnp.asarray(valid)))
    want = dedup_targets(jnp.asarray(targets), jnp.asarray(valid),
                         jnp.asarray(visited))
    got = port_dedup_targets(t(targets), t(valid), t(visited))
    for g, w in zip(got, want):
        same(g, w)


@pytest.mark.parametrize("capacity", [16, 90])
def test_expand_frontier_both_matches_reference(capacity):
    rng = np.random.default_rng(capacity)
    v, e = 20, 60
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    targets = rng.integers(-1, v, 12).astype(np.int32)
    valid = rng.random(12) < 0.8
    jo, ji = (jcsr.build_csr(jnp.asarray(src), v),
              jcsr.build_csr(jnp.asarray(dst), v))
    po, pi = pcsr.build_csr(t(src), v), pcsr.build_csr(t(dst), v)
    same(pcsr.merged_indptr(po, pi), jcsr.merged_indptr(jo, ji))
    want = jcsr.expand_frontier_both(jo, ji, jcsr.merged_indptr(jo, ji),
                                     jnp.asarray(targets), jnp.asarray(valid),
                                     capacity)
    got = pcsr.expand_frontier_both(po, pi, pcsr.merged_indptr(po, pi),
                                    t(targets), t(valid), capacity)
    for g, w in zip(got, want):
        same(g, w)
