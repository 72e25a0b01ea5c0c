"""The port's GNN forward passes (``repro_torch.models.gnn``), graph
generators (``repro_torch.data.graphgen``) and configs against the JAX
reference, on the CPU.

The generators are numpy on both sides, so their arrays are equal exactly.
The reference's ``init_gnn`` parameters cross by
``convert.gnn_params_from_numpy``; ``gnn_forward``'s logits are then held
against the reference's within ``rtol = atol = 1e-4``: the matmuls and
the segment sums add in another order in the two packages, and GatedGCN's
16 residual layers at ``CONFIG`` width carry those roundings through
every layer.  Each arch runs at ``SMOKE`` width, GatedGCN and GraphSAGE
also at ``CONFIG`` width on a graph of a few hundred edges, and GraphSAGE
against both of the reference's aggregation paths (``use_pallas=True``
runs its Pallas kernel in interpret mode, on one small graph).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as ref_registry
from repro.configs.base import GNNConfig as RefGNNConfig
from repro.data import graphgen as ref_graphgen
from repro.models import gnn as ref
from repro_torch.configs import registry as port_registry
from repro_torch.configs.base import GNNConfig
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.data import graphgen as port_graphgen
from repro_torch.kernels.spmm_segment import ops as spmm_ops
from repro_torch.models import gnn as port
from test_torch_engine import release_reference_executables  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("gatedgcn", "graphsage-reddit", "egnn", "gat-cora")
FULL, MOLECULE = "ogb_products", "molecule"


def configs(arch, smoke):
    port_cfg, family = port_registry.get_config(arch, smoke)
    ref_cfg, ref_family = ref_registry.get_config(arch, smoke)
    assert family == ref_family == "gnn"
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, port_cfg


def graph_of(arch, shape):
    """A seeded graph of the smoke shape ``shape``: numpy src, dst, feats
    and, for EGNN, coords."""
    dims = port_registry.SMOKE_GNN_SHAPES[shape]
    if dims["kind"] == "molecule":
        g = port_graphgen.make_molecule_batch(dims["batch"], dims["n_nodes"],
                                              dims["n_edges"], dims["d_feat"],
                                              seed=1)
    else:
        g = port_graphgen.make_graph(dims["n_nodes"], dims["n_edges"],
                                     dims["d_feat"], dims["n_classes"],
                                     seed=3)
    graph = {"src": g.src, "dst": g.dst, "feats": g.feats}
    if arch == "egnn":
        graph["coords"] = np.random.default_rng(9).standard_normal(
            (g.num_vertices, 3)).astype(np.float32)
    return graph, dims["d_feat"], dims["n_classes"]


_FORWARD = jax.jit(ref.gnn_forward, static_argnums=(1,),
                   static_argnames=("use_pallas",))


def ref_forward(cfg, graph, d_feat, n_classes, seed=0, use_pallas=False):
    params = ref.init_gnn(jax.random.PRNGKey(seed), cfg, d_feat, n_classes)
    logits = _FORWARD(params, cfg, {k: jnp.asarray(v)
                                    for k, v in graph.items()},
                      use_pallas=use_pallas)
    return params, np.asarray(logits)


def port_forward(params, cfg, graph):
    tparams = gnn_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")
    return port.gnn_forward(tparams, cfg, {k: torch.from_numpy(v)
                                           for k, v in graph.items()})


@pytest.mark.parametrize("arch,shape", [
    ("gatedgcn", FULL), ("gatedgcn", MOLECULE), ("graphsage-reddit", FULL),
    ("egnn", MOLECULE), ("gat-cora", FULL)])
def test_smoke_width_logits(arch, shape):
    """Each arch at SMOKE width on a smoke shape's graph (EGNN on the
    molecule batch, with coordinates)."""
    ref_cfg, cfg = configs(arch, True)
    graph, d_feat, n_classes = graph_of(arch, shape)
    params, want = ref_forward(ref_cfg, graph, d_feat, n_classes)
    got = port_forward(params, cfg, graph)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("arch", ["gatedgcn", "graphsage-reddit"])
def test_config_width_logits(arch):
    """The published widths (GatedGCN: 16 layers of 70; GraphSAGE: 2 of
    128) on a 100-vertex, 400-edge R-MAT graph."""
    ref_cfg, port_cfg = configs(arch, False)
    g = port_graphgen.make_graph(100, 400, 20, 6, seed=4)
    graph = {"src": g.src, "dst": g.dst, "feats": g.feats}
    params, want = ref_forward(ref_cfg, graph, 20, 6, seed=2)
    got = port_forward(params, port_cfg, graph)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_graphsage_against_the_pallas_path():
    """GraphSAGE against the reference with its Pallas ``spmm_segment`` in
    interpret mode, and the two reference paths against each other."""
    ref_cfg, port_cfg = configs("graphsage-reddit", True)
    g = port_graphgen.make_graph(40, 120, 6, 3, seed=6)
    graph = {"src": g.src, "dst": g.dst, "feats": g.feats}
    params, plain = ref_forward(ref_cfg, graph, 6, 3)
    _, pallas = ref_forward(ref_cfg, graph, 6, 3, use_pallas=True)
    got = port_forward(params, port_cfg, graph).numpy()
    np.testing.assert_allclose(pallas, plain, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_sage_layer_equals_the_spmm_segment_wrapper():
    """``sage_layer`` on edges :func:`sort_edges` sorted once equals the
    layer assembled from the ``spmm_segment`` wrapper (which sorts on
    every call); nothing launches on the CPU."""
    g = port_graphgen.make_graph(60, 300, 8, 3, seed=2)
    p = port.init_sage_layer(torch.Generator().manual_seed(0), 8, 8, "cpu")
    h = torch.from_numpy(g.feats)
    src, dst = torch.from_numpy(g.src), torch.from_numpy(g.dst)
    before = spmm_ops.LAUNCHES
    got = port.sage_layer(p, h, src, dst, 60, port.sort_edges(src, dst, 60))
    deg = torch.bincount(dst, minlength=60).clamp(min=1).to(torch.float32)
    mean = spmm_ops.spmm_segment(h, src, dst, None, 60) / deg[:, None]
    want = torch.relu(h @ p["self"]["w"] + p["self"]["b"]
                      + mean @ p["nbr"]["w"] + p["nbr"]["b"])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(port.sage_layer(p, h, src, dst, 60), got,
                               rtol=0, atol=0)
    assert spmm_ops.LAUNCHES == before


def test_segment_softmax_with_an_empty_segment():
    """Segments 1 and 4 have no entry (JAX's segment_max gives -inf
    there, which the reference takes as 0) and segment 3 a single one;
    the (E, H) form is the per-head softmax."""
    scores = np.asarray([1.0, 2.0, 3.0, -1.0, 0.0, 5.0], np.float32)
    seg = np.asarray([0, 0, 2, 2, 2, 3], np.int32)
    want = np.asarray(ref.segment_softmax(jnp.asarray(scores),
                                          jnp.asarray(seg), 5))
    got = port.segment_softmax(torch.from_numpy(scores),
                               torch.from_numpy(seg), 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    two = np.stack([scores, -2 * scores], 1)
    got2 = port.segment_softmax(torch.from_numpy(two),
                                torch.from_numpy(seg), 5)
    for hh in range(2):
        want_h = np.asarray(ref.segment_softmax(jnp.asarray(two[:, hh]),
                                                jnp.asarray(seg), 5))
        np.testing.assert_allclose(got2[:, hh].numpy(), want_h, rtol=1e-6,
                                   atol=1e-7)


def test_egnn_invariance():
    """EGNN's node features are invariant, and its coordinates equivariant,
    under a rotation and translation of the input coordinates."""
    rng = np.random.default_rng(0)
    n, e, d = 20, 60, 8
    h = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    lp = port.init_egnn_layer(torch.Generator().manual_seed(1), d, "cpu")
    h1, x1 = port.egnn_layer(lp, h, x, src, dst, n)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q = torch.from_numpy(q.astype(np.float32))
    t = torch.tensor([1.0, -2.0, 0.5])
    h2, x2 = port.egnn_layer(lp, h, x @ q + t, src, dst, n)
    torch.testing.assert_close(h1, h2, atol=2e-4, rtol=0)
    torch.testing.assert_close(x1 @ q + t, x2, atol=2e-4, rtol=0)


def test_node_xent():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((30, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 30).astype(np.int32)
    mask = (rng.random(30) < 0.5).astype(np.float32)
    for m in (None, mask):
        want = float(ref.node_xent(jnp.asarray(logits), jnp.asarray(labels),
                                   None if m is None else jnp.asarray(m)))
        got = float(port.node_xent(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   None if m is None else torch.from_numpy(m)))
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_gnn_matches_the_reference_tree(arch):
    """The port's own ``init_gnn`` gives the reference's tree: the same
    keys, list lengths, shapes and dtypes, and the same draws from the
    same generator seed."""
    ref_cfg, port_cfg = configs(arch, True)
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        ref.init_gnn(jax.random.PRNGKey(0), ref_cfg, 10, 3))

    def init(seed):
        return port.init_gnn(port_cfg, 10, 3,
                             torch.Generator().manual_seed(seed), "cpu")
    got = init(0)
    shapes = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        got)
    assert shapes == want
    again = init(0)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(again)))


def test_configs_and_shapes_equal_the_reference():
    for arch in ARCHS:
        for smoke in (False, True):
            configs(arch, smoke)
    assert dataclasses.fields(GNNConfig) and \
        [(f.name, f.default) for f in dataclasses.fields(GNNConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(RefGNNConfig)]
    for name in ("GNN_SHAPES", "SMOKE_GNN_SHAPES", "RECSYS_SHAPES",
                 "SMOKE_RECSYS_SHAPES"):
        assert getattr(port_registry, name) == getattr(ref_registry, name)
    cfg, family = port_registry.get_config("deepfm")
    want, _ = ref_registry.get_config("deepfm")
    assert family == "recsys"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


@pytest.mark.parametrize("case", ["rmat", "graph", "directed", "molecule"])
def test_graphgen_arrays_equal(case):
    """The same seed gives the same arrays, bit for bit."""
    if case == "rmat":
        args = ("rmat_edges", (3000, 20000), dict(seed=7))
    elif case == "graph":
        args = ("make_graph", (300, 1500, 24, 5), dict(seed=3))
    elif case == "directed":
        args = ("make_graph", (257, 1001, 4), dict(seed=1, undirected=False))
    else:
        args = ("make_molecule_batch", (8, 12, 30, 8), dict(seed=2))
    name, pos, kw = args
    got = getattr(port_graphgen, name)(*pos, **kw)
    want = getattr(ref_graphgen, name)(*pos, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
