"""The port's optimizers, schedules and clipping (``repro_torch.optim``)
against the JAX reference's (``repro.optim``), on the CPU.

Both packages update the same numpy parameters with the same numpy
gradients for 5 steps; params, moments (or velocity) and the global norm
agree within ``rtol = atol = 1e-6`` (float32 arithmetic in the same order
of operations, but XLA and PyTorch may fuse a multiply-add differently),
with the gradients' norm above ``max_grad_norm`` (clipping active) and
below it.  The schedules are float32 arithmetic on the step and agree
exactly at steps 0, 1, the warmup, the warmup + 1 and the total.  The
reference's own behaviour tests (``tests/test_optim.py``) are mirrored.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as ref
from repro_torch import optim as port
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.optim.tree import leaves, tree_map, value_and_grad
from test_torch_engine import release_reference_executables  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
STEPS = 5


def params_np(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(3, 4), "layers": [{"b": f(5), "k": f(2, 2)}, {"b": f(5)}],
            "s": np.float32(0.5) * np.ones((), np.float32)}


def grads_np(step, scale):
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
        params_np())


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def close(got, want):
    for g, w in zip(leaves(tree_to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


OPTS = {
    "adamw": (lambda: ref.AdamW(lr=ref.linear_warmup_cosine(0.1, 2, 10),
                                weight_decay=0.1),
              lambda: port.AdamW(lr=port.linear_warmup_cosine(0.1, 2, 10),
                                 weight_decay=0.1)),
    "sgd": (lambda: ref.sgd_momentum(lr=ref.cosine_decay(0.05, 10)),
            lambda: port.sgd_momentum(lr=port.cosine_decay(0.05, 10))),
}


@pytest.mark.parametrize("scale", [0.05, 3.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_update_matches_reference(name, scale):
    make_ref, make_port = OPTS[name]
    r_opt, p_opt = make_ref(), make_port()
    r_params = jax.tree_util.tree_map(jnp.asarray, params_np())
    p_params = to_torch(params_np())
    r_state = r_opt.init(r_params)
    p_state = p_opt.init(p_params)
    clipped = []
    for step in range(STEPS):
        g = grads_np(step, scale)
        r_params, r_state, r_norm = r_opt.update(
            r_params, jax.tree_util.tree_map(jnp.asarray, g), r_state)
        p_params, p_state, p_norm = p_opt.update(p_params, to_torch(g),
                                                 p_state)
        np.testing.assert_allclose(float(p_norm), float(r_norm), **TOL)
        clipped.append(float(r_norm) > r_opt.max_grad_norm)
        close(p_params, r_params)
        close(p_state, r_state)
        assert p_state["step"].dtype == torch.int32
        assert int(p_state["step"]) == step + 1
    assert all(clipped) == (scale > 1) and any(clipped) == (scale > 1)


def test_update_from_a_converted_state():
    """A reference state carried across by ``tree_from_numpy``
    continues as the reference does."""
    r_opt, p_opt = OPTS["adamw"][0](), OPTS["adamw"][1]()
    r_params = jax.tree_util.tree_map(jnp.asarray, params_np())
    r_state = r_opt.init(r_params)
    for step in range(2):
        g = jax.tree_util.tree_map(jnp.asarray, grads_np(step, 1.0))
        r_params, r_state, _ = r_opt.update(r_params, g, r_state)
    p_params = to_torch(jax.tree_util.tree_map(np.asarray, r_params))
    p_state = tree_from_numpy(
        jax.tree_util.tree_map(np.asarray, r_state), "cpu")
    g = grads_np(2, 1.0)
    r_params, r_state, _ = r_opt.update(
        r_params, jax.tree_util.tree_map(jnp.asarray, g), r_state)
    p_params, p_state, _ = p_opt.update(p_params, to_torch(g), p_state)
    close(p_params, r_params)
    close(p_state, r_state)


SCHEDULES = {
    "constant": (lambda: ref.constant(0.3), lambda: port.constant(0.3), 0,
                 100),
    "cosine": (lambda: ref.cosine_decay(0.7, 90, 0.05),
               lambda: port.cosine_decay(0.7, 90, 0.05), 0, 90),
    "warmup_cosine": (lambda: ref.linear_warmup_cosine(3e-4, 200, 10_000),
                      lambda: port.linear_warmup_cosine(3e-4, 200, 10_000),
                      200, 10_000),
    "warmup_cosine_short": (lambda: ref.linear_warmup_cosine(1.0, 10, 100),
                            lambda: port.linear_warmup_cosine(1.0, 10, 100),
                            10, 100),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    make_ref, make_port, warmup, total = SCHEDULES[name]
    r, p = make_ref(), make_port()
    for s in sorted({0, 1, warmup, warmup + 1, total}):
        want = np.float32(r(jnp.asarray(s, jnp.int32)))
        got = p(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.numpy() == want, (name, s, float(got), float(want))


def test_global_norm_and_clip_match_reference():
    tree = grads_np(0, 2.0)
    r_clip, r_norm = ref.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), 1.0)
    p_clip, p_norm = port.clip_by_global_norm(to_torch(tree), 1.0)
    np.testing.assert_allclose(float(p_norm), float(r_norm), **TOL)
    np.testing.assert_allclose(float(port.global_norm(to_torch(tree))),
                               float(ref.global_norm(tree)), **TOL)
    close(p_clip, r_clip)


# --- the reference's tests/test_optim.py, on the port ---

def _quadratic_params():
    return {"w": torch.tensor([3.0, -2.0, 5.0]), "b": torch.tensor(4.0)}


def _loss(p):
    return torch.sum(p["w"] ** 2) + p["b"] ** 2


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_converges_quadratic(name):
    p = _quadratic_params()
    opt = (port.AdamW(lr=port.constant(0.1), weight_decay=0.0)
           if name == "adamw" else port.sgd_momentum(lr=port.constant(0.05)))
    st = opt.init(p)
    for _ in range(200):
        _, g = value_and_grad(_loss, p)
        p, st, _ = opt.update(p, g, st)
    assert float(_loss(p)) < 1e-3


def test_clip_by_global_norm():
    tree = {"a": torch.ones(4) * 3.0, "b": torch.ones((2, 2)) * 4.0}
    clipped, g = port.clip_by_global_norm(tree, 1.0)
    assert abs(float(port.global_norm(clipped)) - 1.0) < 1e-5
    assert float(g) > 1.0
    small, _ = port.clip_by_global_norm({"a": torch.tensor([0.1])}, 1.0)
    assert abs(float(small["a"][0]) - 0.1) < 1e-7   # untouched below max


def test_schedules():
    s = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    warm = port.linear_warmup_cosine(1.0, warmup=10, total_steps=100)
    assert float(warm(s(0))) == 0.0
    assert abs(float(warm(s(10))) - 1.0) < 1e-6
    assert float(warm(s(90))) < float(warm(s(20)))
    cd = port.cosine_decay(1.0, 100, final_frac=0.1)
    assert abs(float(cd(s(0))) - 1.0) < 1e-6
    assert abs(float(cd(s(100))) - 0.1) < 1e-6


def test_adamw_weight_decay_shrinks():
    p = {"w": torch.tensor([10.0])}
    opt = port.AdamW(lr=port.constant(0.1), weight_decay=0.5)
    st = opt.init(p)
    p2, _, _ = opt.update(p, {"w": torch.tensor([0.0])}, st)
    assert float(p2["w"][0]) < 10.0
    assert float(p["w"][0]) == 10.0          # the old tree is left as it was


def test_value_and_grad_leaves_params_alone():
    p = _quadratic_params()
    loss, g = value_and_grad(_loss, p)
    assert float(loss) == 9 + 4 + 25 + 16
    torch.testing.assert_close(g["w"], 2 * p["w"])
    assert not p["w"].requires_grad and g["w"].grad_fn is None
