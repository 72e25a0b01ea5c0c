"""The port's train and serve cells (``repro_torch.launch.steps``) against
the reference's (``repro.launch.steps``), on the CPU, for every smoke cell
of the GNN and recsys families (``configs.registry.cells(smoke=True)``;
the LM cells are held in ``tests/test_torch_launch_train.py``).

Each cell is built by both packages (the same seeded graphs and batches:
the generators are numpy on both sides) and the port starts from the
reference's parameters and AdamW state, carried across by ``convert``.
For three steps, each package runs one step from the reference's state
of that step (the reference's step jitted once a cell), and:

- the losses agree within 1e-5 relative and the gradients' global norms
  within 1e-5 relative;
- each step's gradients agree within ``rtol = atol = 1e-4`` of each
  leaf's largest (``tests/test_torch_gnn.py``'s tolerance: the matmuls
  and segment sums add in another order).  Both packages' gradients are
  read off their new first moments, ``g = (mu' - b1 mu) / (1 - b1)``
  times the clipping's inverse scale, so the comparison runs through
  each package's own step function end to end.

Post-step parameters are not compared: AdamW's first update is close to
``lr * sign(g)``, so a parameter whose gradient is near zero can move by
up to ``lr`` on float noise alone (``tests/test_torch_optim.py`` holds the
optimizer on equal gradients).  The minibatch cells take the reference's
draws (``reference_draws``).  Serve and retrieval cells agree within
``rtol = atol = 2e-5``, the reference's DeepFM tolerance.  The GNN loss
descends on the port as in ``tests/test_models_gnn_recsys.py``.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import steps as ref_steps
from repro_torch.configs.base import GNNConfig
from repro_torch.configs.registry import ARCHS, cells
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.data.graphgen import make_graph
from repro_torch.launch import steps as port_steps
from repro_torch.models import gnn
from repro_torch.optim import AdamW, constant
from repro_torch.optim.tree import leaves
from test_torch_engine import release_reference_executables  # noqa: F401
from test_torch_sampler import reference_draws

STEPS = 3
GRAD_TOL = 1e-4
REL = 1e-5
SERVE_TOL = dict(rtol=2e-5, atol=2e-5)
SMOKE_CELLS = [(c.arch, c.shape) for c in cells(smoke=True)
               if c.family in ("gnn", "recsys")]
TRAIN_CELLS = [(a, s) for a, s in SMOKE_CELLS
               if not s.startswith(("serve", "retrieval"))]
SERVE_CELLS = [(a, s) for a, s in SMOKE_CELLS if (a, s) not in TRAIN_CELLS]


@pytest.fixture(scope="module")
def ref_cell():
    """(arch, shape) -> the reference's concrete smoke cell and its jitted
    step, each built once."""
    built = {}

    def get(arch, shape):
        if (arch, shape) not in built:
            plan = ref_steps.build_cell(arch, shape, smoke=True,
                                        concrete=True)
            built[arch, shape] = plan, jax.jit(plan.fn)
        return built[arch, shape]
    return get


def grads_from_moments(mu_new, mu_old, gnorm, b1):
    """The unclipped gradient, off an AdamW step's first moments."""
    unclip = max(1.0, float(gnorm))
    return [(np.asarray(a, np.float64) - b1 * np.asarray(b, np.float64))
            / (1 - b1) * unclip
            for a, b in zip(mu_new, mu_old)]


def test_every_family_cell_is_covered():
    assert {a for a, _ in SMOKE_CELLS} == {
        a for a, (family, _) in ARCHS.items() if family in ("gnn", "recsys")}
    assert len(SMOKE_CELLS) == 20


@pytest.mark.parametrize("arch,shape", TRAIN_CELLS)
def test_train_cell_matches_reference(arch, shape, ref_cell):
    plan, ref_fn = ref_cell(arch, shape)
    port_plan = port_steps.build_cell(arch, shape, smoke=True, device="cpu")
    batch = port_plan.args[2:]
    b1 = port_steps.make_optimizer().b1
    minibatch = len(plan.args) == 5
    kwargs = {}
    if minibatch:
        seeds = np.asarray(plan.args[3])
        fanout = tuple(ref_steps.shapes_for("gnn", smoke=True)[shape]
                       ["fanout"])
        draws = reference_draws(jax.random.PRNGKey(int(plan.args[4])),
                                seeds.shape[0], fanout)
        kwargs["draws"] = [torch.tensor(d) for d in draws]
        np.testing.assert_array_equal(batch[1].numpy(), seeds)
    # the same data in both cells
    for a, b in zip(leaves(tree_to_numpy(list(batch))),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(np.asarray,
                                               list(plan.args[2:])))):
        np.testing.assert_array_equal(a, b)
    params, state = plan.args[0], plan.args[1]
    losses = []
    for step in range(STEPS):
        host = jax.tree_util.tree_map(np.asarray, (params, state))
        p_params = tree_from_numpy(host[0], "cpu")
        p_state = tree_from_numpy(host[1], "cpu")
        new_params, new_state, m = ref_fn(params, state, *plan.args[2:])
        _, got_state, got_m = port_plan.fn(p_params, p_state, *batch,
                                           **kwargs)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        assert abs(float(got_m["loss"]) - loss) <= REL * abs(loss), step
        assert abs(float(got_m["grad_norm"]) - gnorm) <= REL * gnorm, step
        want = grads_from_moments(jax.tree_util.tree_leaves(new_state["mu"]),
                                  jax.tree_util.tree_leaves(host[1]["mu"]),
                                  gnorm, b1)
        got = grads_from_moments(leaves(tree_to_numpy(got_state["mu"])),
                                 jax.tree_util.tree_leaves(host[1]["mu"]),
                                 float(got_m["grad_norm"]), b1)
        for i, (g, w) in enumerate(zip(got, want)):
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g, w, rtol=GRAD_TOL,
                                       atol=GRAD_TOL * scale,
                                       err_msg=f"step {step} leaf {i}")
        assert int(got_state["step"]) == step + 1
        losses.append(loss)
        params, state = new_params, new_state
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_serve_cell_matches_reference(arch, shape, ref_cell):
    plan, ref_fn = ref_cell(arch, shape)
    port_plan = port_steps.build_cell(arch, shape, smoke=True, device="cpu")
    want = np.asarray(ref_fn(*plan.args))
    params = tree_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                    plan.args[0]), "cpu")
    got = port_plan.fn(params, *port_plan.args[1:])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **SERVE_TOL)


@pytest.mark.parametrize("kind,block", [("gatedgcn", False),
                                        ("graphsage", False),
                                        ("graphsage", True), ("gat", False)])
def test_gnn_loss_descends(kind, block):
    """The reference's ``test_gnn_loss_descends`` on the port, and
    GraphSAGE's sampled-block step (the graph's first 40 vertices, each
    with its first 3 out-edges' heads as its children)."""
    g = make_graph(200, 1200, d_feat=12, num_classes=4, seed=8)
    cfg = GNNConfig(name=kind, kind=kind, n_layers=2, d_hidden=16,
                    n_heads=2, d_feat=12, num_classes=4,
                    sample_sizes=(3, 3))
    p = gnn.init_gnn(cfg, 12, 4, torch.Generator().manual_seed(0), "cpu")
    opt = AdamW(lr=constant(5e-3), weight_decay=0.0)
    st = opt.init(p)
    feats = torch.from_numpy(g.feats)
    labels = torch.from_numpy(g.labels)
    if block:
        order = np.argsort(g.src, kind="stable")
        kids = {}
        for s, d in zip(g.src[order], g.dst[order]):
            kids.setdefault(int(s), []).append(int(d))
        seeds = [v for v in range(200) if len(kids.get(v, ())) >= 3][:40]
        hop1 = [c for v in seeds for c in kids[v][:3]]
        hop2 = [c for v in hop1 for c in (kids.get(v, []) + [v] * 3)[:3]]
        layers = [torch.tensor(x) for x in (seeds, hop1, hop2)]
        batch = {"layer_feats": [feats[t] for t in reversed(layers)],
                 "labels": labels[layers[0]]}
    else:
        batch = {"src": torch.from_numpy(g.src),
                 "dst": torch.from_numpy(g.dst), "feats": feats,
                 "labels": labels}
    step = gnn.make_gnn_train_step(cfg, opt, block=block)
    first = None
    for _ in range(30):
        p, st, m = step(p, st, batch)
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < first * 0.8
