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
row's sum of absolute terms.  On the shared tile cases a row of at most
32 edges equals the plain version run on the CPU (the same order of
adds), a longer row, summed by many threads in a fixed tree, is within
1e-5 of its sum of absolute terms, and two calls give the same bits.
``embedding_bag`` sums a bag in its sorted order and the plain version's
``index_add_`` with atomics: they agree within 1e-5 of each bag's sum of
absolute terms.  On the shared layout cases (``bag_layout_case``) the
kernel equals the plain version run on the CPU bit for bit (the same
order of adds), and two calls give the same bits.  DeepFM on the card
equals the CPU run in its positions and within ``rtol = atol = 2e-5`` in
its logits (sums over fields and the MLP's dot products run in another
order; TF32 off).  A weighted ``run_query`` on the card equals the CPU run in
every integer field and value column, and in ``vertex_values`` exactly for
min and max semirings, within ``rtol = 1e-5, atol = 1e-6`` for sum and
product (the CPU and the card scatter in different orders).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import dataset_from_numpy
from repro_torch.core.csr import build_csr, expand_frontier
from repro_torch.core.engine import (EngineCaps, RecursiveQuery,
                                     dispatch_buckets, lane_eviction_count,
                                     result_lane, run_query, run_query_batch,
                                     run_query_multi)
from repro_torch.data.treegen import TreeSpec, make_edge_table
from repro_torch.configs.deepfm import SMOKE
from repro_torch.data.recsys_stream import recsys_batch, vocab_sizes
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import bag_layout
from repro_torch.kernels.embedding_bag.ref import (BAG_LAYOUT_CASES,
                                                   bag_cases,
                                                   bag_layout_case,
                                                   embedding_bag_ref,
                                                   layout_table)
from repro_torch.kernels.frontier_expand import (EXPAND_CASES, MAX_LANES,
                                                 expand_case,
                                                 expand_lanes_case,
                                                 frontier_expand_cuda)
from repro_torch.kernels.frontier_expand import ops as fe_ops
from repro_torch.kernels.frontier_pull import (PULL_CASES, build_pull_layout,
                                               frontier_pull_cuda,
                                               frontier_pull_layout_ref,
                                               pull_case, pull_lanes_case)
from repro_torch.kernels.frontier_pull import ops as fp_ops
from repro_torch.kernels.frontier_pull.ref import frontier_pull_ref
from repro_torch.core.table import ColumnTable, RowTable
from repro_torch.kernels.late_gather import late_gather_cuda
from repro_torch.kernels.late_gather import ops as lg_ops
from repro_torch.kernels.late_gather.ref import (late_gather_columns_ref,
                                                 late_gather_ref)
from repro_torch.kernels.spmm_segment import ops as spmm_ops
from repro_torch.kernels.spmm_segment.ref import (SPMM_CASES, spmm_tile_case,
                                                  spmm_segment_lanes_ref,
                                                  spmm_segment_ref)
from repro_torch.kernels.spmm_segment.spmm_segment import SHORT_ROW
from repro_torch.models import recsys


@pytest.fixture
def cuda():
    """The card; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def device_launches(call, want: int) -> dict:
    """The device launches of one ``call()`` by kernel name, from
    ``torch.profiler``.  On the H100 a session sometimes loses some or
    all of its device events, and never gains one, so a session is taken
    again (three at most) until one shows ``want``; the fullest counts,
    and a call that makes more launches still shows more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    launched = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
        if sum(seen.values()) > sum(launched.values()):
            launched = seen
        if sum(launched.values()) >= want:
            break
    return launched


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


# (dtype, width) of each column of a fused gather
LG_COLUMNS = {
    "mixed": [(torch.int32, 1), (torch.float32, 4), (torch.float32, 5),
              (torch.bfloat16, 3), (torch.bfloat16, 128), (torch.int32, 10)],
    "widths": [(torch.float32, w) for w in (1, 3, 4, 5, 10, 37, 128)],
    # row bytes 2, 6, 10, 12, 148: only 2- or 4-byte copies divide them
    "narrow": [(torch.bfloat16, 1), (torch.bfloat16, 3),
               (torch.bfloat16, 5), (torch.int32, 3), (torch.float32, 37)],
    # 16-byte rows at an address 4 bytes past the allocation: 4-byte copies
    "offset": [(torch.float32, 4), (torch.int32, 4), (torch.float32, 8)],
    "40 columns": [((torch.float32, torch.int32, torch.bfloat16)[k % 3],
                    (1, 3, 4, 5, 10)[k % 5]) for k in range(40)],
}


def lg_table(rng, dtype, r: int, w: int, offset: bool, device
             ) -> torch.Tensor:
    if dtype == torch.int32:
        tab = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (r, w))
                               .astype(np.int32))
    else:
        tab = torch.from_numpy(rng.standard_normal((r, w)) * 10).to(dtype)
    if not offset:
        return tab.to(device)
    # the same values one element past an aligned address
    flat = torch.empty(r * w + 1, dtype=dtype, device=device)
    flat[1:] = tab.reshape(-1).to(device)
    return flat[1:].view(r, w)


def as_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("p", [0, 1, 300, 5000])
@pytest.mark.parametrize("case", list(LG_COLUMNS))
def test_late_gather_columns_kernel_matches_plain(cuda, case, p):
    """The fused kernel against its plain version on the same card
    tensors, bit for bit, at positions below -R, in [-R, 0), in [0, R) and
    >= R; one launch per 32 columns, none for P = 0."""
    r = 1000
    rng = np.random.default_rng(len(case) * 100 + p)
    tabs = [lg_table(rng, dt, r, w, case == "offset", cuda)
            for dt, w in LG_COLUMNS[case]]
    pos_np = rng.integers(-r - 3, r + 6, p).astype(np.int32)
    pos_np[:min(p, 4)] = [-r - 1, -r, -1, r][:min(p, 4)]
    pos = torch.from_numpy(pos_np).to(cuda)
    before = lg_ops.LAUNCHES
    got = lg_ops.late_gather_columns(tabs, pos)
    want = late_gather_columns_ref(tabs, pos)
    torch.cuda.synchronize()
    assert lg_ops.LAUNCHES == before + (-(-len(tabs) // 32) if p else 0)
    for g, w, t in zip(got, want, tabs):
        assert g.dtype == t.dtype and g.shape == (p, t.shape[1])
        assert torch.equal(as_bits(g), as_bits(w))


def test_column_table_take_launches_once(cuda):
    """One ``take`` of a tree table's 12 output columns, negative positions
    among them, makes one launch and equals the CPU table's take."""
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=8, seed=5)
    cols = make_edge_table(spec)
    names = RecursiveQuery("precursive", 4, 8, EngineCaps(64, 64)).out_cols
    pos = torch.from_numpy(np.random.default_rng(5).integers(
        -3100, 3100, 4096).astype(np.int32))
    want = ColumnTable.from_numpy(cols, "cpu").take(pos, names)
    before = lg_ops.LAUNCHES
    got = ColumnTable.from_numpy(cols, cuda).take(pos.to(cuda), names)
    torch.cuda.synchronize()
    assert lg_ops.LAUNCHES == before + 1
    assert list(got) == list(names)
    for name in names:
        assert torch.equal(got[name].cpu(), want[name]), name


def test_late_gather_cuda_launcher_rejects_host_tensors(cuda):
    tab = torch.zeros((4, 3), dtype=torch.float32)
    pos = torch.zeros((2,), dtype=torch.int32)
    for tables, positions in (([tab], pos), ([tab.to(cuda)], pos),
                              ([tab.to(cuda), tab], pos.to(cuda))):
        with pytest.raises(ValueError, match="CUDA"):
            late_gather_cuda(tables, positions)


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


def check_expand_on_card(src, v, targets, valid, capacity, cuda):
    """The kernel route and the plain version on the same card tensors:
    all three outputs equal in value, dtype and shape, one more launch."""
    csr = build_csr(torch.from_numpy(src).to(cuda), v)
    t, m = torch.from_numpy(targets).to(cuda), torch.from_numpy(valid).to(cuda)
    want = expand_frontier(csr, t, m, capacity)
    before = fe_ops.LAUNCHES
    got = fe_ops.frontier_expand_fused(csr, t, m, capacity)
    torch.cuda.synchronize()
    assert fe_ops.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.device == w.device and g.dtype == w.dtype
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_frontier_expand_tile_cases_on_card(cuda, case):
    """F beside the 2,048-target scan tile, a zero-degree run longer than a
    tile, a hub across output tiles, a total on an output tile edge, cuts,
    out-of-range valid targets, F = 1, F = 0 and E = 0."""
    check_expand_on_card(*expand_case(case), cuda)


@pytest.mark.parametrize("seed", range(4))
def test_frontier_expand_large_random_on_card(cuda, seed):
    """Random frontiers up to F = 2^18 + 3 over a 2^20-vertex graph; seed
    0 is the engine's shape, F = 2^18 + 3 into capacity 2^18."""
    rng = np.random.default_rng(seed + 60)
    v = 1 << 20
    e = int(rng.integers(1 << 20, 1 << 22))
    f = (1 << 18) + 3 if seed == 0 else int(rng.integers(1, (1 << 18) + 4))
    src = rng.integers(0, v, e).astype(np.int32)
    targets = rng.integers(-1, v + 1, f).astype(np.int32)
    valid = rng.random(f) < 0.8
    cap = 1 << 18 if seed == 0 else int(rng.integers(0, 6 * f))
    check_expand_on_card(src, v, targets, valid, cap, cuda)


def test_frontier_expand_three_device_launches(cuda):
    """One call on the card is three device launches, counted by
    torch.profiler, and no torch op but the outputs' allocations."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(str(func))
            return func(*args, **(kwargs or {}))

    src, v, targets, valid, capacity = expand_case("f4097")
    csr = build_csr(torch.from_numpy(src).to(cuda), v)
    t, m = torch.from_numpy(targets).to(cuda), torch.from_numpy(valid).to(cuda)
    fe_ops.frontier_expand_fused(csr, t, m, capacity)
    torch.cuda.synchronize()
    with Ops() as ops:
        fe_ops.frontier_expand_fused(csr, t, m, capacity)
    assert ops.seen == {"aten.empty.memory_format"}
    launched = device_launches(
        lambda: fe_ops.frontier_expand_fused(csr, t, m, capacity), 3)
    assert sum(launched.values()) == 3, launched
    for name in ("frontier_degree_sums", "frontier_scan_ends",
                 "frontier_expand_slots"):
        assert any(name in k for k in launched), (name, launched)


def test_frontier_expand_cuda_launcher_rejects(cuda):
    """Host tensors, inputs split across devices and wrong dtypes raise."""
    csr = build_csr(torch.tensor([0, 1, 1, 2], dtype=torch.int32), 3)
    t = torch.tensor([0, 1, 2], dtype=torch.int32)
    m = torch.ones(3, dtype=torch.bool)
    indptr, perm = csr.indptr.to(cuda), csr.perm.to(cuda)
    with pytest.raises(ValueError, match="CUDA"):
        frontier_expand_cuda(csr.indptr, csr.perm, t, m, 4)
    with pytest.raises(ValueError, match="CUDA"):
        frontier_expand_cuda(indptr, perm, t, m.to(cuda), 4)
    with pytest.raises(TypeError, match="int32"):
        frontier_expand_cuda(indptr, perm, t.long().to(cuda), m.to(cuda), 4)
    with pytest.raises(TypeError, match="bool"):
        frontier_expand_cuda(indptr, perm, t.to(cuda),
                             m.to(torch.uint8).to(cuda), 4)
    with pytest.raises(ValueError, match="CUDA"):
        fe_ops.frontier_expand_fused(csr, t.to(cuda), m.to(cuda), 4)


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


@pytest.mark.parametrize("case", PULL_CASES)
def test_frontier_pull_cases_on_card(cuda, case):
    """Each shared case: the kernel over a layout built on the card equals
    both plain versions bit for bit, one LAUNCHES step per call with the
    layout reused, and the call without a layout builds its own (no launch
    without edges)."""
    src, dst, frontier, visited = pull_case(case)
    v = frontier.shape[0]
    host = [torch.from_numpy(a) for a in (src, dst, frontier, visited)]
    want = frontier_pull_ref(build_csr(host[1], v), *host)
    card = [a.to(cuda) for a in host]
    rcsr = build_csr(card[1], v)
    layout = build_pull_layout(rcsr, card[0], card[1], v)
    assert torch.equal(frontier_pull_layout_ref(layout, *card[2:]).cpu(),
                       want)
    before = fp_ops.LAUNCHES
    got = [fp_ops.frontier_pull_fused(rcsr, *card, layout=layout)
           for _ in range(2)]
    got.append(fp_ops.frontier_pull_fused(rcsr, *card))
    torch.cuda.synchronize()
    assert fp_ops.LAUNCHES == before + 3 * (src.shape[0] > 0)
    for g in got:
        assert g.dtype == torch.bool and torch.equal(g.cpu(), want)


@pytest.mark.parametrize("case,kernels", [("random", 1), ("hub_last", 2)])
def test_frontier_pull_device_launches(cuda, case, kernels):
    """One call is the rows kernel alone, or with the tiles kernel when the
    layout has hub tiles, counted by torch.profiler: no memset."""
    src, dst, frontier, visited = (torch.from_numpy(a).to(cuda)
                                   for a in pull_case(case))
    rcsr = build_csr(dst, frontier.shape[0])
    layout = build_pull_layout(rcsr, src, dst, frontier.shape[0])

    def call():
        return fp_ops.frontier_pull_fused(rcsr, src, dst, frontier, visited,
                                          layout=layout)
    call()
    torch.cuda.synchronize()
    launched = device_launches(call, kernels)
    assert sum(launched.values()) == kernels, launched
    assert not any("memset" in k.lower() for k in launched), launched
    names = ("frontier_pull_rows", "frontier_pull_tiles")[:kernels]
    for name in names:
        assert any(name in k for k in launched), (name, launched)


def test_dataset_builds_each_pull_layout_once_on_card(cuda):
    """``run_query`` with a direction-optimizing engine builds the
    direction's layout on the card once and reuses it: the next query
    finds the same tensors."""
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=1, seed=11)
    ds = dataset_from_numpy(make_edge_table(spec), 3000, cuda)
    for direction, root in (("outbound", 0), ("inbound", 2999)):
        q = RecursiveQuery("diropt", 10, 1, EngineCaps(4096, 8192),
                           direction=direction)
        run_query(q, ds, root)
        layout = ds.pull_layouts[direction]
        assert layout.ptr.device.type == "cuda"
        run_query(q, ds, root)
        assert ds.pull_layouts[direction] is layout
        assert ds.context(direction).pull_layout is layout
    assert set(ds.pull_layouts) == {"outbound", "inbound"}


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


LANES = (1, 3, 8, 32)


def lane_frontiers(rng, v, lanes, f):
    """(L, F) targets and flags: lane 0 holds the hub (vertex 0) among
    random targets, lane 1 (when there is one) none valid, the rest
    random."""
    targets = rng.integers(-1, v, (lanes, f)).astype(np.int32)
    valid = rng.random((lanes, f)) < 0.8
    targets[0, f // 2], valid[0, f // 2] = 0, True
    if lanes > 1:
        valid[1] = False
    return targets, valid


@pytest.mark.parametrize("lanes", LANES)
def test_frontier_expand_lanes_match_plain(cuda, lanes):
    """(L, F) lanes over one graph whose vertex 0 owns 3,000 extra edges
    (a hub across output tiles), with an empty lane beside the hub's: the
    kernel equals the plain version and each lane's one-lane call in all
    three outputs, with one LAUNCHES step for every lane; at L = 1 the
    2-D call equals the 1-D one."""
    rng = np.random.default_rng(lanes)
    v, e, f = 5000, 20000, 2600
    src = np.concatenate([rng.integers(0, v, e), np.zeros(3000, np.int64)])
    csr = build_csr(torch.from_numpy(src.astype(np.int32)).to(cuda), v)
    targets, valid = lane_frontiers(rng, v, lanes, f)
    t, m = torch.from_numpy(targets).to(cuda), torch.from_numpy(valid).to(cuda)
    cap = 9000                        # the hub's lane overflows
    want = expand_frontier(csr, t, m, cap)
    before = fe_ops.LAUNCHES
    got = fe_ops.frontier_expand_fused(csr, t, m, cap)
    torch.cuda.synchronize()
    assert fe_ops.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
    assert bool(got[2][0]) and (lanes == 1 or int(got[1][1]) == 0)
    for i in range(lanes):
        one = frontier_expand_cuda(csr.indptr, csr.perm, t[i].contiguous(),
                                   m[i].contiguous(), cap)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_frontier_expand_lane_cases_on_card(cuda, case):
    """Each tile case stacked as four lanes (itself, an empty lane, itself
    reversed, every other target): the kernel equals the plain version
    on every lane."""
    src, v, targets, valid, capacity = expand_lanes_case(case)
    csr = build_csr(torch.from_numpy(src).to(cuda), v)
    t, m = torch.from_numpy(targets.copy()).to(cuda), \
        torch.from_numpy(valid.copy()).to(cuda)
    want = expand_frontier(csr, t, m, capacity)
    got = fe_ops.frontier_expand_fused(csr, t, m, capacity)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)


def hub_pull_input(rng, lanes):
    """A graph of V = 3,000 whose vertex 5 owns 2,000 extra in-entries (8
    hub tiles), and (L, V) planes: lane 0 has vertex 5 open with only its
    last in-neighbor in the frontier, lane 1 (when there is one) an empty
    frontier, the rest random."""
    v, e = 3000, 12000
    nbr = rng.integers(0, v, 2000)
    src = np.concatenate([rng.integers(0, v, e), nbr]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, v, e),
                          np.full(2000, 5)]).astype(np.int32)
    frontier = rng.random((lanes, v)) < 0.2
    visited = (rng.random((lanes, v)) < 0.4) | frontier
    frontier[0] = False
    frontier[0, nbr[-1]] = True
    visited[0] = True
    visited[0, 5] = False
    if lanes > 1:
        frontier[1] = False
    return src, dst, frontier, visited


@pytest.mark.parametrize("lanes", LANES)
def test_frontier_pull_lanes_match_plain(cuda, lanes):
    """(L, V) planes over one layout with hub tiles, an empty frontier
    beside the hub's lane: the kernel equals both plain versions and each
    lane's one-lane call; at L = 1 the 2-D call equals the 1-D one."""
    rng = np.random.default_rng(lanes + 10)
    src, dst, frontier, visited = (torch.from_numpy(a).to(cuda)
                                   for a in hub_pull_input(rng, lanes))
    v = frontier.shape[-1]
    rcsr = build_csr(dst, v)
    layout = build_pull_layout(rcsr, src, dst, v)
    assert layout.tile_vtx.shape[0] >= 8
    want = frontier_pull_ref(rcsr, src, dst, frontier, visited)
    before = fp_ops.LAUNCHES
    got = fp_ops.frontier_pull_fused(rcsr, src, dst, frontier, visited,
                                     layout=layout)
    torch.cuda.synchronize()
    assert fp_ops.LAUNCHES == before + 1
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(frontier_pull_layout_ref(layout, frontier, visited),
                       want)
    assert bool(got[0, 5]) and int(got[0].sum()) == 1
    for i in range(lanes):
        one = frontier_pull_cuda(layout,
                                 frontier[i].contiguous().view(torch.uint8),
                                 visited[i].contiguous().view(torch.uint8))
        assert torch.equal(got[i], one.view(torch.bool))


@pytest.mark.parametrize("case", PULL_CASES)
def test_frontier_pull_lane_cases_on_card(cuda, case):
    """Each pull case stacked as four lanes (itself, an empty frontier,
    the frontier moved on by one, everything else open): the kernel
    equals the plain version on every lane."""
    src, dst, frontier, visited = (torch.from_numpy(a.copy()).to(cuda)
                                   for a in pull_lanes_case(case))
    v = frontier.shape[-1]
    rcsr = build_csr(dst, v)
    layout = build_pull_layout(rcsr, src, dst, v)
    want = frontier_pull_ref(rcsr, src, dst, frontier, visited)
    got = fp_ops.frontier_pull_fused(rcsr, src, dst, frontier, visited,
                                     layout=layout)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_lane_launchers_refuse_too_many_lanes(cuda):
    """One lane more than gridDim.y allows raises before any launch; the
    most it allows runs."""
    csr = build_csr(torch.tensor([0, 1, 1, 2], dtype=torch.int32,
                                 device=cuda), 3)
    for lanes, ok in ((MAX_LANES, True), (MAX_LANES + 1, False)):
        t = torch.zeros((lanes, 1), dtype=torch.int32, device=cuda)
        m = torch.ones((lanes, 1), dtype=torch.bool, device=cuda)
        if ok:
            pos, count, _ = frontier_expand_cuda(csr.indptr, csr.perm, t, m,
                                                 2)
            torch.cuda.synchronize()
            assert count.tolist() == [1] * lanes
            continue
        with pytest.raises(ValueError, match="lanes"):
            frontier_expand_cuda(csr.indptr, csr.perm, t, m, 2)
    src = torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda)
    dst = torch.tensor([1, 2, 0], dtype=torch.int32, device=cuda)
    layout = build_pull_layout(build_csr(dst, 3), src, dst, 3)
    planes = torch.zeros((MAX_LANES + 1, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="lanes"):
        frontier_pull_cuda(layout, planes, planes)


def test_lane_calls_keep_their_device_launches(cuda):
    """Eight lanes make the device launches one lane makes: 3 for the
    expansion, 1 or 2 for the pull (with hub tiles), no memset."""
    rng = np.random.default_rng(7)
    src, dst, frontier, visited = (torch.from_numpy(a).to(cuda)
                                   for a in hub_pull_input(rng, 8))
    v = frontier.shape[-1]
    rcsr = build_csr(dst, v)
    layout = build_pull_layout(rcsr, src, dst, v)
    csr = build_csr(src, v)
    t, m = (torch.from_numpy(a).to(cuda) for a in lane_frontiers(rng, v, 8,
                                                                  500))
    calls = {3: lambda: fe_ops.frontier_expand_fused(csr, t, m, 4000),
             2: lambda: fp_ops.frontier_pull_fused(rcsr, src, dst, frontier,
                                                   visited, layout=layout)}
    for kernels, call in calls.items():
        call()
        torch.cuda.synchronize()
        launched = device_launches(call, kernels)
        assert sum(launched.values()) == kernels, launched
        assert not any("memset" in k.lower() for k in launched), launched


BATCH_ROOTS = [0, 1, 17, 2999, -2, 3003, 0]


@pytest.mark.parametrize("direction", ["outbound", "inbound", "both"])
@pytest.mark.parametrize("engine", ENGINES)
def test_run_query_batch_on_card_matches_per_root(cuda, engine, direction):
    """Every lane of a card batch equals the card's run of its root, and
    each kernel is called at most once a level for all lanes."""
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
    ds = dataset_from_numpy(make_edge_table(spec), 3000, cuda)
    q = RecursiveQuery(engine, 10, 2, EngineCaps(4096, 8192),
                       direction=direction)
    run_query(q, ds, 0)
    before = (fe_ops.LAUNCHES, fp_ops.LAUNCHES)
    got = run_query_batch(q, ds, BATCH_ROOTS)
    torch.cuda.synchronize()
    levels = int(got.depth.max())
    assert fe_ops.LAUNCHES - before[0] <= levels
    assert fp_ops.LAUNCHES - before[1] <= levels
    for i, root in enumerate(BATCH_ROOTS):
        lane, want = result_lane(got, i), run_query(q, ds, root)
        for field in ("positions", "count", "depth", "overflow",
                      "row_depths", "level_dirs"):
            g, w = getattr(lane, field), getattr(want, field)
            assert (g is None and w is None) or torch.equal(g, w), \
                (root, field)
        for k in want.values:
            assert torch.equal(lane.values[k], want.values[k]), (root, k)


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


@pytest.mark.parametrize("d", [1, 4, 17, 128])
@pytest.mark.parametrize("case", SPMM_CASES)
def test_spmm_segment_tile_cases_on_card(cuda, case, d):
    x, src, dst, w, n_out = spmm_tile_case(case, d)
    x, src, dst, w = (torch.from_numpy(a) for a in (x, src, dst, w))
    want = spmm_segment_ref(x, src, dst, w, n_out)
    scale = spmm_segment_ref(x.abs(), src, dst, w.abs(), n_out)
    short = spmm_ops.segments(dst, n_out).offsets.diff() <= SHORT_ROW
    args = [t.to(cuda) for t in (x, src, dst, w)]
    before = spmm_ops.LAUNCHES
    got = spmm_ops.spmm_segment(*args, n_out)
    again = spmm_ops.spmm_segment(*args, n_out)
    torch.cuda.synchronize()
    assert spmm_ops.LAUNCHES == before + (2 if n_out * d else 0)
    assert got.shape == (n_out, d) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    got = got.cpu()
    assert torch.equal(got[short], want[short])
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-5).all())


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


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["smoke", "b", "c"])
def test_embedding_bag_kernel_matches_plain(cuda, case, weighted, combiner):
    tab, idx, seg, w, b = bag_cases(case)
    tab, idx, seg, w = (t.to(cuda) for t in (tab, idx, seg, w))
    w = w if weighted else None
    want = embedding_bag_ref(tab, idx, seg, b, w, combiner=combiner)
    scale = embedding_bag_ref(tab.abs(), idx, seg, b,
                              None if w is None else w.abs(),
                              combiner=combiner)
    before = eb_ops.LAUNCHES
    got = eb_ops.embedding_bag(tab, idx, seg, b, w, combiner=combiner)
    torch.cuda.synchronize()
    assert eb_ops.LAUNCHES == before + 1
    assert got.shape == (b, tab.shape[1]) and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    empty = 4 if case == "smoke" else 1000
    assert not got[empty].any()


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", BAG_LAYOUT_CASES)
def test_embedding_bag_layout_cases_on_card(cuda, case, weighted, combiner):
    tab, idx, seg, w, b, offset = bag_layout_case(case)
    idx, seg, w = (torch.from_numpy(a) for a in (idx, seg, w))
    w = w if weighted else None
    want_cpu = embedding_bag_ref(layout_table(tab, offset), idx, seg, b, w,
                                 combiner=combiner)
    t = layout_table(tab, offset, cuda)
    assert t.storage_offset() == int(offset)
    if offset:
        assert bag_layout(t.shape[1], t.data_ptr()).vec == 1
    i, s, ww = (None if a is None else a.to(cuda) for a in (idx, seg, w))
    want = embedding_bag_ref(t, i, s, b, ww, combiner=combiner)
    scale = embedding_bag_ref(t.abs(), i, s, b,
                              None if ww is None else ww.abs(),
                              combiner=combiner)
    sg = spmm_ops.segments(s, b)
    si, sw = i[sg.order], None if ww is None else ww[sg.order]
    before = eb_ops.LAUNCHES
    got = eb_ops.embedding_bag(t, i, s, b, ww, combiner=combiner)
    again = eb_ops.embedding_bag(t, i, s, b, ww, combiner=combiner)
    assert eb_ops.LAUNCHES == before + 2
    via_sorted = eb_ops.embedding_bag_sorted(t, si, sg.seg, sw, sg.offsets,
                                             combiner=combiner)
    assert eb_ops.LAUNCHES == before + 3
    torch.cuda.synchronize()
    assert got.shape == (b, tab.shape[1]) and got.dtype == torch.float32
    bits = got.view(torch.int32)
    assert torch.equal(bits, again.view(torch.int32))
    assert torch.equal(bits, via_sorted.view(torch.int32))
    assert torch.equal(bits.cpu(), want_cpu.view(torch.int32))
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    assert not got[[0, b - 1]].any()


def test_embedding_bag_kernel_refuses_other_dtypes(cuda):
    tab, idx, seg, _, b = bag_cases("smoke")
    with pytest.raises(ValueError, match="float32"):
        eb_ops.embedding_bag(tab.to(cuda, torch.bfloat16), idx.to(cuda),
                             seg.to(cuda), b)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_deepfm_on_card_matches_cpu(cuda, table_dtype, monkeypatch):
    """SMOKE widths: serve_scores, deepfm_forward and retrieval_scores on
    the card against the CPU run from the same parameters.  Retrieval
    scores are in the table's dtype: with a bfloat16 table they may round
    to neighbouring bfloat16 values (rtol 2^-7)."""
    import dataclasses
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(SMOKE, table_dtype=table_dtype)
    params = recsys.init_deepfm(cfg, torch.Generator().manual_seed(3), "cpu")
    on_card = {k: (v.to(cuda) if k != "mlp" else
                   [{n: t.to(cuda) for n, t in lp.items()} for lp in v])
               for k, v in params.items()}
    batch = recsys_batch(0, 0, 64, vocabs=vocab_sizes(cfg.vocab_scale))
    args = [torch.from_numpy(a) for a in (batch["dense"], batch["sparse"],
                                          recsys.field_offsets(cfg))]
    card_args = [a.to(cuda) for a in args]
    assert torch.equal(recsys.featurize(cfg, *card_args).cpu(),
                       recsys.featurize(cfg, *args))
    before = lg_ops.LAUNCHES
    got = recsys.serve_scores(on_card, cfg, *card_args)
    torch.cuda.synchronize()
    assert lg_ops.LAUNCHES == before + 1
    torch.testing.assert_close(got.cpu(),
                               recsys.serve_scores(params, cfg, *args),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(
        recsys.deepfm_forward(on_card, cfg, *card_args).cpu(),
        recsys.deepfm_forward(params, cfg, *args), rtol=2e-5, atol=2e-5)
    cand = torch.arange(0, recsys.total_rows(cfg), 7, dtype=torch.int32)
    one = [a[:1] for a in args[:2]] + [args[2]]
    torch.testing.assert_close(
        recsys.retrieval_scores(on_card, cfg, *[a.to(cuda) for a in one],
                                cand.to(cuda)).cpu().float(),
        recsys.retrieval_scores(params, cfg, *one, cand).float(),
        rtol=2e-5 if table_dtype == "float32" else 2 ** -7, atol=2e-5)


def test_empty_table_raises_before_any_launch_on_card(cuda):
    """An empty table (R = 0) and at least one position or index raises
    IndexError on the card route of ``late_gather`` and ``embedding_bag``,
    as the reference does, and launches nothing."""
    tab = torch.zeros((0, 4), device=cuda)
    idx = torch.tensor([0, 1, -1], dtype=torch.int32, device=cuda)
    seg = torch.tensor([0, 0, 1], dtype=torch.int32, device=cuda)
    before = lg_ops.LAUNCHES, eb_ops.LAUNCHES
    s = spmm_ops.segments(seg, 2)
    for call in (lambda: lg_ops.late_gather(tab, idx),
                 lambda: lg_ops.late_gather_columns([tab, tab[:, :1]], idx),
                 lambda: ColumnTable({"a": tab[:, 0]}).take(idx),
                 lambda: eb_ops.fixed_hot_lookup(tab, idx.reshape(1, -1)),
                 lambda: eb_ops.embedding_bag(tab, idx, seg, 2),
                 lambda: eb_ops.embedding_bag(tab, idx, seg, 2,
                                              combiner="mean"),
                 lambda: eb_ops.embedding_bag_sorted(tab, idx[s.order], s.seg,
                                                     None, s.offsets)):
        with pytest.raises(IndexError):
            call()
    torch.cuda.synchronize()
    assert (lg_ops.LAUNCHES, eb_ops.LAUNCHES) == before
    none = torch.zeros((0,), dtype=torch.int32, device=cuda)
    assert lg_ops.late_gather(tab, none).shape == (0, 4)
    assert not eb_ops.embedding_bag(tab, none, none, 2).any()


# ---------------------------------------------------------------------------
# the row table's gather and the paper's tuple-based and row-store engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [7, 47])
def test_take_rows_kernel_matches_plain(cuda, width):
    """``RowTable.take_rows`` through the kernel, bit-equal to its plain
    version, at the row table's widths (no payload column, and 8): real
    positions, the sentinel R, wrapped positions in [-R, 0), positions
    below -R (a zero row) and none at all."""
    rng = np.random.default_rng(width)
    r = 3001
    data = torch.from_numpy(rng.standard_normal((r, width)).astype(
        np.float32))
    table = RowTable(data.to(cuda), tuple(f"c{i}" for i in range(width)))
    pos = rng.integers(0, r, 4096).astype(np.int32)
    pos[::7] = r
    pos[1::11] = -rng.integers(1, r + 1, pos[1::11].shape[0])
    pos[2::13] = -r - 1 - rng.integers(0, 50, pos[2::13].shape[0])
    for p in (pos, pos[:0], np.array([r, -r, r - 1], np.int32)):
        before = lg_ops.LAUNCHES
        got = table.take_rows(torch.from_numpy(p).to(cuda))
        torch.cuda.synchronize()
        want = late_gather_ref(data, torch.from_numpy(p))
        assert got.shape == (p.shape[0], width)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
        assert lg_ops.LAUNCHES - before == (1 if p.shape[0] else 0)


def test_take_rows_of_empty_table_raises_on_card(cuda):
    table = RowTable(torch.zeros((0, 7), device=cuda),
                     tuple(f"c{i}" for i in range(7)))
    before = lg_ops.LAUNCHES
    with pytest.raises(IndexError):
        table.take_rows(torch.zeros((3,), dtype=torch.int32, device=cuda))
    assert table.take_rows(torch.zeros((0,), dtype=torch.int32,
                                       device=cuda)).shape == (0, 7)
    assert lg_ops.LAUNCHES == before


def test_row_table_builds_on_card_as_on_cpu(cuda):
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
    cols = make_edge_table(spec)
    on_card = dataset_from_numpy(cols, 3000, cuda)
    on_card.ensure_rows()
    on_cpu = dataset_from_numpy(cols, 3000, "cpu")
    on_cpu.ensure_rows()
    assert on_card.rows.layout == on_cpu.rows.layout
    assert on_card.rows.data.is_contiguous()
    assert torch.equal(on_card.rows.data.cpu(), on_cpu.rows.data)


PAPER_CELLS = ([(e, d) for e in ("trecursive", "trecursive_rewrite")
                for d in ("outbound", "inbound", "both")]
               + [(e, "outbound") for e in ("rowstore", "rowstore_index",
                                            "rowstore_rewrite",
                                            "rowstore_index_rewrite")])


@pytest.mark.parametrize("engine,direction", PAPER_CELLS)
def test_paper_engines_on_card_match_cpu(cuda, engine, direction):
    """The tuple-based and row-store engines on the card equal their CPU
    runs bit for bit, every value column in its dtype (float32 on the row
    store), and the IndexJoin engines run ``frontier_expand`` once a
    level outside the fused ``both`` view."""
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
    cols = make_edge_table(spec)
    ds, ds_cpu = (dataset_from_numpy(cols, 3000, d) for d in (cuda, "cpu"))
    q = RecursiveQuery(engine, 10, 2, EngineCaps(4096, 8192),
                       direction=direction)
    for root in (0, 17, 2999):
        before = fe_ops.LAUNCHES, lg_ops.LAUNCHES
        got = run_query(q, ds, root)
        torch.cuda.synchronize()
        want = run_query(q, ds_cpu, root)
        levels = int(want.depth)
        index_join = engine in ("trecursive", "trecursive_rewrite",
                                "rowstore_index", "rowstore_index_rewrite")
        assert fe_ops.LAUNCHES - before[0] == (
            levels if index_join and direction != "both" else 0)
        assert lg_ops.LAUNCHES - before[1] == \
            levels + 1 + engine.endswith("_rewrite")
        for field in ("positions", "count", "depth", "overflow",
                      "row_depths"):
            g, w = getattr(got, field), getattr(want, field)
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), \
                (root, field)
        assert sorted(got.values) == sorted(want.values)
        for k in want.values:
            g, w = got.values[k], want.values[k]
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w), (root, k)


MULTI_ROOTS = [0, 1, 17, 2999, -2, 3003, 0, 42]


@pytest.mark.parametrize("direction", ["outbound", "inbound", "both"])
def test_run_query_multi_on_card_matches_cpu(cuda, direction):
    """MS-BFS on the card equals the CPU run on every field, each lane
    equals the card's ``diropt`` on its root, and the call launches
    ``late_gather`` once (the take of every lane's rows) and no traversal
    kernel (the word sweep is plain PyTorch)."""
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
    cols = make_edge_table(spec)
    ds, ds_cpu = (dataset_from_numpy(cols, 3000, d) for d in (cuda, "cpu"))
    q = RecursiveQuery("multiquery", 10, 2, EngineCaps(4096, 8192),
                       direction=direction)
    run_query_multi(q, ds, MULTI_ROOTS)
    torch.cuda.synchronize()
    before = fe_ops.LAUNCHES, fp_ops.LAUNCHES, lg_ops.LAUNCHES
    got = run_query_multi(q, ds, MULTI_ROOTS)
    torch.cuda.synchronize()
    assert (fe_ops.LAUNCHES - before[0], fp_ops.LAUNCHES - before[1],
            lg_ops.LAUNCHES - before[2]) == (0, 0, 1)
    want = run_query_multi(q, ds_cpu, MULTI_ROOTS)
    for field in ("positions", "count", "depth", "overflow", "row_depths"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), field
    assert got.level_dirs is None and got.vertex_values is None
    for k in want.values:
        assert torch.equal(got.values[k].cpu(), want.values[k]), k
    dq = RecursiveQuery("diropt", 10, 2, EngineCaps(4096, 8192),
                        direction=direction)
    for i, root in enumerate(MULTI_ROOTS):
        lane, one = result_lane(got, i), run_query(dq, ds, root)
        for field in ("positions", "count", "depth", "overflow",
                      "row_depths"):
            assert torch.equal(getattr(lane, field), getattr(one, field)), \
                (root, field)


def test_msbfs_eviction_on_card(cuda):
    """The bucket executor on the card: only the MS-BFS lane that
    overflows its bucket's result cap is evicted, and it equals the card's
    ``diropt`` at the fallback caps; the other lanes keep their rows."""
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
    ds = dataset_from_numpy(make_edge_table(spec), 3000, cuda)
    small, fallback = EngineCaps(4096, 64), EngineCaps(4096, 8192)
    q = RecursiveQuery("multiquery", 10, 2, small)
    roots = (0, 2999, 17, 1)
    lanes = run_query_multi(q, ds, roots).overflow.tolist()
    assert lanes[0] and not all(lanes)

    bucket = types.SimpleNamespace(indices=(0, 1, 2, 3), roots=roots,
                                   caps=small)

    def dispatch(i, b, caps):
        return run_query_multi(dataclasses.replace(q, caps=caps), ds,
                               list(b.roots))
    before = lane_eviction_count()
    out = dispatch_buckets([bucket], dispatch, fallback_caps=fallback)
    assert lane_eviction_count() - before == sum(lanes)
    for i, root in enumerate(roots):
        caps = fallback if lanes[i] else small
        one = run_query(RecursiveQuery("diropt", 10, 2, caps), ds, root)
        assert out[i].count.is_cuda
        for field in ("positions", "count", "depth", "overflow",
                      "row_depths"):
            assert torch.equal(getattr(out[i], field), getattr(one, field)), \
                (root, field)


@pytest.mark.parametrize("d", [1, 4, 17, 128])
@pytest.mark.parametrize("case", SPMM_CASES)
def test_spmm_segment_lanes_match_plain(cuda, case, d):
    """Three lanes of one tile case in one call, each with its own x and
    source mask (the second masking every source off): the lane-axis plain
    version run on the CPU equals the kernel on rows of at most 32 edges
    and is within 1e-5 of the absolute sums elsewhere; each lane equals
    the one-lane call on its masked sources bit for bit, and one lane with
    its mask equals it too.  One launch a call for all lanes."""
    x, src, dst, w, n_out = spmm_tile_case(case, d)
    x, src, dst, w = (torch.from_numpy(a) for a in (x, src, dst, w))
    n = x.shape[0]
    rng = np.random.default_rng(SPMM_CASES.index(case) + 100 * d)
    xs = torch.stack([x, -x, 2 * x])
    mask = torch.from_numpy(rng.random((3, n)) < 0.6)
    mask[1] = False
    seg = spmm_ops.segments(dst, n_out)
    s_src, s_seg, s_w = src[seg.order], seg.seg, w[seg.order]
    want = spmm_segment_lanes_ref(xs, s_src, s_seg, s_w, n_out, mask)
    scale = spmm_segment_lanes_ref(xs.abs(), s_src, s_seg, s_w.abs(), n_out,
                                   mask)
    short = seg.offsets.diff() <= SHORT_ROW
    on = [t.to(cuda) for t in (xs, s_src, s_seg, s_w, seg.offsets, mask)]
    before = spmm_ops.LAUNCHES
    got = spmm_ops.spmm_segment_sorted(*on)
    torch.cuda.synchronize()
    assert spmm_ops.LAUNCHES == before + (1 if n_out * d else 0)
    assert got.shape == (3, n_out, d) and got.dtype == torch.float32
    xs_c, src_c, seg_c, w_c, off_c, mask_c = on
    for lane in range(3):
        masked = torch.where(mask_c[lane][src_c.clamp(0, n - 1).long()],
                             src_c, n)
        one = spmm_ops.spmm_segment_sorted(xs_c[lane], masked, seg_c, w_c,
                                           off_c)
        alone = spmm_ops.spmm_segment_sorted(
            xs_c[lane:lane + 1].contiguous(), src_c, seg_c, w_c, off_c,
            mask_c[lane:lane + 1].contiguous())[0]
        assert torch.equal(got[lane].view(torch.int32),
                           one.view(torch.int32)), lane
        assert torch.equal(alone.view(torch.int32), one.view(torch.int32))
    assert not got[1].any()                               # the empty lane
    got = got.cpu()
    assert torch.equal(got[:, short], want[:, short])
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-5).all())


def test_spmm_segment_lanes_refuse_too_many_lanes(cuda):
    """One lane more than gridDim.y allows raises before any launch; no
    lane is no launch."""
    from repro_torch.kernels.spmm_segment.spmm_segment import MAX_LANES \
        as SPMM_MAX_LANES
    src = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    w = torch.ones((2,), dtype=torch.float32, device=cuda)
    offsets = torch.tensor([0, 1, 2], dtype=torch.int32, device=cuda)
    x = torch.ones((SPMM_MAX_LANES + 1, 2, 1), device=cuda)
    with pytest.raises(ValueError, match="lanes"):
        spmm_ops.spmm_segment_sorted(x, src, src, w, offsets)
    before = spmm_ops.LAUNCHES
    out = spmm_ops.spmm_segment_sorted(x[:0], src, src, w, offsets)
    assert out.shape == (0, 2, 1) and spmm_ops.LAUNCHES == before
    out = spmm_ops.spmm_segment_sorted(x[:SPMM_MAX_LANES], src, src, w,
                                       offsets)
    torch.cuda.synchronize()
    assert bool((out == 1).all())


# One lane-axis call over the hub case, counted by device_launches in a
# process of its own; prints the counts by kernel name as JSON.
SPMM_LANE_LAUNCHES = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from test_torch_cuda import device_launches
from repro_torch.kernels.spmm_segment import ops as spmm_ops
from repro_torch.kernels.spmm_segment.ref import spmm_tile_case
cuda = torch.device("cuda")
x, src, dst, w, n_out = spmm_tile_case("hub_many_tiles", 1)
x, src, dst, w = (torch.from_numpy(a).to(cuda) for a in (x, src, dst, w))
seg = spmm_ops.segments(dst, n_out)
s_src, s_w = src[seg.order], w[seg.order]
xs = x[None].expand(8, -1, -1).contiguous()
mask = torch.ones((8, x.shape[0]), dtype=torch.bool, device=cuda)
def call():
    return spmm_ops.spmm_segment_sorted(xs, s_src, seg.seg, s_w,
                                        seg.offsets, mask)
call()
torch.cuda.synchronize()
print(json.dumps(device_launches(call, 2)))
"""


def test_spmm_lane_call_keeps_its_device_launches(cuda):
    """Eight lanes over the hub case make the device launches one lane
    makes: the rows kernel and the hub fixup, no memset.  Counted in a
    process of its own: in a process that has run the rest of this file,
    torch.profiler never records this rows kernel (PERF.md §7), although
    the lane tests above see its output."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    import repro_torch
    env = dict(os.environ,
               PYTHONPATH=str(Path(repro_torch.__file__).parents[1]))
    done = subprocess.run(
        [sys.executable, "-c", SPMM_LANE_LAUNCHES,
         str(Path(__file__).parent)],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    launched = json.loads(done.stdout.strip().splitlines()[-1])
    assert sum(launched.values()) == 2, launched
    assert any("spmm_segment_rows" in k for k in launched), launched
    assert not any("memset" in k.lower() for k in launched), launched


WEIGHTED_SEMIRINGS = [(e, d, s) for e, d in WEIGHTED for s in SEMIRINGS]


@pytest.mark.parametrize("engine,direction,workload", WEIGHTED_SEMIRINGS)
def test_weighted_batch_on_card_matches_per_root(cuda, engine, direction,
                                                 workload):
    """Every lane of a weighted card batch equals the card's run of its
    root: bit for bit, except that a (sum, ×) or (mul, ×) walk both ways,
    where a vertex takes several arrivals a level, is within rtol 1e-5,
    atol 1e-6 (the card's scatters add with atomics).  ``spmm_segment``
    and ``frontier_expand`` are called at most once a level for all
    lanes, and the (sum, ×) ``bitmap`` batch does call the former."""
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
    cols = make_edge_table(spec)
    cols["w"] = np.random.default_rng(12).uniform(
        0.5, 2.0, spec.num_edges).astype(np.float32)
    ds = dataset_from_numpy(cols, 3000, cuda)
    q = RecursiveQuery(engine, 10, 2, EngineCaps(4096, 8192),
                       direction=direction, workload=workload,
                       weight_col="w")
    run_query(q, ds, 0)
    before = spmm_ops.LAUNCHES, fe_ops.LAUNCHES
    got = run_query_batch(q, ds, BATCH_ROOTS)
    torch.cuda.synchronize()
    levels = int(got.depth.max())
    spmm, fe = spmm_ops.LAUNCHES - before[0], fe_ops.LAUNCHES - before[1]
    assert spmm <= levels and fe <= levels
    assert (spmm > 0) == ((engine, workload) == ("bitmap", "aggregate_sum"))
    close = direction == "both" and workload in ("aggregate_sum",
                                                 "aggregate_mul")
    for i, root in enumerate(BATCH_ROOTS):
        lane, want = result_lane(got, i), run_query(q, ds, root)
        for field in ("positions", "count", "depth", "overflow",
                      "row_depths"):
            assert torch.equal(getattr(lane, field), getattr(want, field)), \
                (root, field)
        for k in want.values:
            assert torch.equal(lane.values[k], want.values[k]), (root, k)
        g, w = lane.vertex_values, want.vertex_values
        if close:
            assert torch.equal(g.isfinite(), w.isfinite())
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6,
                                       equal_nan=True)
        else:
            assert torch.equal(g, w), root


@pytest.mark.parametrize("engine,direction", PAPER_CELLS)
def test_value_batch_on_card_matches_per_root(cuda, engine, direction):
    """Every lane of a tuple or row-store card batch equals the card's run
    of its root bit for bit; ``late_gather`` runs once a level for all
    lanes, once for the seed blocks and once more for a rewrite's join,
    and ``frontier_expand`` at most once a level."""
    spec = TreeSpec(num_vertices=3000, height=10, payload_cols=2, seed=11)
    ds = dataset_from_numpy(make_edge_table(spec), 3000, cuda)
    q = RecursiveQuery(engine, 10, 2, EngineCaps(4096, 8192),
                       direction=direction)
    run_query(q, ds, 0)
    before = fe_ops.LAUNCHES, lg_ops.LAUNCHES
    got = run_query_batch(q, ds, BATCH_ROOTS)
    torch.cuda.synchronize()
    levels = int(got.depth.max())
    assert fe_ops.LAUNCHES - before[0] <= levels
    assert lg_ops.LAUNCHES - before[1] == \
        levels + 1 + engine.endswith("_rewrite")
    for i, root in enumerate(BATCH_ROOTS):
        lane, want = result_lane(got, i), run_query(q, ds, root)
        for field in ("positions", "count", "depth", "overflow",
                      "row_depths"):
            g, w = getattr(lane, field), getattr(want, field)
            assert g.dtype == w.dtype and torch.equal(g, w), (root, field)
        for k in want.values:
            g, w = lane.values[k], want.values[k]
            assert g.dtype == w.dtype and torch.equal(g, w), (root, k)
