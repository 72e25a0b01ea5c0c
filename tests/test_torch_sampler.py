"""The port's neighbour sampler (``repro_torch.data.sampler``) and the
sampled-block forward against the JAX reference, on the CPU.

Fed the reference's own draws (rebuilt here with the reference's key
splits: one ``split`` a hop, ``randint(sub, (n, f), 0, 2^30)``), the
port's ``sample_block`` gives the reference's layers exactly, and
``gather_block_features`` its features exactly (gathers do no
arithmetic).  ``sage_block_forward`` on such a block is held against the
reference's within ``rtol = atol = 1e-4`` (tests/test_torch_gnn.py's
tolerance: matmuls and sums add in another order).  On its own draws,
from a ``torch.Generator``, the port keeps the reference sampler tests'
properties: every sampled node is an out-neighbour of its parent, an
isolated vertex samples itself, and the draws are a function of the
generator's seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.csr import build_csr as ref_build_csr
from repro.data import sampler as ref
from repro.models import gnn as ref_gnn
from repro_torch.configs import registry as port_registry
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.core.csr import build_csr
from repro_torch.data import graphgen
from repro_torch.data import sampler as port
from repro_torch.models import gnn as port_gnn
from test_torch_engine import release_reference_executables  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
V, E, D_FEAT = 300, 2400, 8
FANOUTS = (5, 3)
SEEDS = 16


@pytest.fixture(scope="module")
def graph():
    """The reference sampler tests' graph, with a few vertices left
    without an out-edge, as numpy arrays and as each package's CSR."""
    g = graphgen.make_graph(V, E, d_feat=D_FEAT, seed=5)
    keep = g.src % 37 != 1          # vertices 1, 38, 75, ... lose their edges
    src, dst = g.src[keep], g.dst[keep]
    ref_csr = ref_build_csr(jnp.asarray(src), V)
    port_csr = build_csr(torch.from_numpy(src), V)
    return src, dst, g.feats, ref_csr, port_csr


def reference_draws(key, n: int, fanouts):
    """The draws the reference's ``sample_block`` makes from ``key``."""
    draws = []
    for f in fanouts:
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.randint(sub, (n, f), 0, 1 << 30)))
        n *= f
    return draws


def seeds_of(n):
    # every 9th seed an isolated vertex (1 + 37k)
    return np.asarray([1 + 37 * (i // 9 % 8) if i % 9 == 0 else 3 * i + 2
                       for i in range(n)], np.int32)


def test_csr_equals_the_reference(graph):
    _, _, _, ref_csr, port_csr = graph
    np.testing.assert_array_equal(port_csr.indptr.numpy(),
                                  np.asarray(ref_csr.indptr))
    np.testing.assert_array_equal(port_csr.perm.numpy(),
                                  np.asarray(ref_csr.perm))


@pytest.mark.parametrize("key_seed,fanouts", [(0, FANOUTS), (3, (4,)),
                                              (11, (2, 3, 2))])
def test_layers_equal_with_the_reference_draws(graph, key_seed, fanouts):
    src, dst, feats, ref_csr, port_csr = graph
    seeds = seeds_of(SEEDS)
    key = jax.random.PRNGKey(key_seed)
    want = ref.sample_block(key, ref_csr, jnp.asarray(dst),
                            jnp.asarray(seeds), fanouts)
    draws = [torch.tensor(d) for d in reference_draws(key, SEEDS, fanouts)]
    got = port.sample_block(None, port_csr, torch.from_numpy(dst),
                            torch.from_numpy(seeds), fanouts, draws=draws)
    assert len(got) == len(want) == len(fanouts) + 1
    for layer, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.int32, layer
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got_f = port.gather_block_features(torch.from_numpy(feats), got)
    want_f = ref.gather_block_features(jnp.asarray(feats), want)
    for a, b in zip(got_f, want_f):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sage_block_forward(graph):
    """The smoke GraphSAGE on a block sampled with the reference's draws:
    the same logits within TOL."""
    src, dst, feats, ref_csr, port_csr = graph
    cfg, _ = port_registry.get_config("graphsage-reddit", smoke=True)
    fanouts = tuple(cfg.sample_sizes)
    seeds = seeds_of(SEEDS)
    key = jax.random.PRNGKey(4)
    layers = ref.sample_block(key, ref_csr, jnp.asarray(dst),
                              jnp.asarray(seeds), fanouts)
    block = {"layer_feats": ref.gather_block_features(jnp.asarray(feats),
                                                      layers)}
    params = ref_gnn.init_gnn(jax.random.PRNGKey(1), cfg, D_FEAT, 5)
    want = np.asarray(ref_gnn.sage_block_forward(params, cfg, block))
    port_layers = port.sample_block(
        None, port_csr, torch.from_numpy(dst), torch.from_numpy(seeds),
        fanouts, draws=[torch.tensor(d) for d in
                        reference_draws(key, SEEDS, fanouts)])
    tparams = gnn_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")
    got = port_gnn.sage_block_forward(tparams, cfg, {
        "layer_feats": port.gather_block_features(torch.from_numpy(feats),
                                                  port_layers)})
    assert tuple(got.shape) == want.shape == (SEEDS, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_own_draws_are_adjacent_and_isolated_vertices_loop(graph):
    src, dst, _, _, port_csr = graph
    adj = {}
    for s, d in zip(src, dst):
        adj.setdefault(int(s), set()).add(int(d))
    seeds = seeds_of(32)
    layers = port.sample_block(torch.Generator().manual_seed(1), port_csr,
                               torch.from_numpy(dst),
                               torch.from_numpy(seeds), (4, 2))
    assert [layer.shape[0] for layer in layers] == [32, 128, 256]
    for parents, children, f in ((layers[0], layers[1], 4),
                                 (layers[1], layers[2], 2)):
        kids = children.numpy().reshape(-1, f)
        isolated = 0
        for p, row in zip(parents.numpy().tolist(), kids):
            options = adj.get(p, set())
            if options:
                assert set(row.tolist()) <= options
            else:
                isolated += 1
                assert (row == p).all()     # self-loop fallback
        assert parents is layers[1] or isolated >= 4


def test_isolated_vertex_self_loop():
    csr = build_csr(torch.tensor([0, 0], dtype=torch.int32), 5)
    layers = port.sample_block(torch.Generator().manual_seed(0), csr,
                               torch.tensor([1, 2], dtype=torch.int32),
                               torch.tensor([4], dtype=torch.int32), (3,))
    assert (layers[1] == 4).all()


def test_deterministic_in_the_generator_seed(graph):
    _, dst, _, _, port_csr = graph
    seeds = torch.from_numpy(seeds_of(8))
    dst = torch.from_numpy(dst)

    def run(seed):
        return port.sample_block(torch.Generator().manual_seed(seed),
                                 port_csr, dst, seeds, (4, 2))
    a, b, c = run(7), run(7), run(8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a[1:], c[1:]))


def test_draws_are_checked(graph):
    _, dst, _, _, port_csr = graph
    seeds = torch.from_numpy(seeds_of(4))
    with pytest.raises(ValueError):
        port.sample_block(None, port_csr, torch.from_numpy(dst), seeds,
                          (2, 2), draws=[torch.zeros((4, 2), dtype=torch.int32)])
    with pytest.raises(ValueError):
        port.sample_block(None, port_csr, torch.from_numpy(dst), seeds,
                          (2,), draws=[torch.zeros((4, 3), dtype=torch.int32)])
