"""DeepFM training on the port (``repro_torch.models.recsys``) against the
JAX reference, on the CPU: ``_dedup_positions`` and the lazy positional
step ``make_deepfm_train_step_lazy``.

``_dedup_positions`` sorts the positions and segment-sums their values:
the unique positions (and the ``num_rows`` sentinels past them) equal
the reference's exactly, the sums within ``rtol = atol = 1e-6`` (one add
per repeat, in the same sorted order).  The lazy step, from the same
converted parameters and state at the smoke config, gives the
reference's loss and gnorm, and every row of the table, the first-order
weights and their moments within ``rtol = atol = 1e-6`` (the rows it
touches), or exactly (the rows it does not), over two steps, and the
dense parameters and their moments within the same tolerance.  The
optimizer's ``eps`` is 1e-3 here: with the default 1e-8, an update
divides a gradient by its own magnitude plus 1e-8, and some embedding
entries' gradients are about 1e-8, summed in another order by the two
packages, so those entries' updates differ by more than 1e-6 on float
noise alone (``tests/test_torch_optim.py`` holds the default ``eps`` on
equal gradients).  The dense train step is held against
the reference in ``tests/test_torch_train_cells.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as ref_get_config
from repro.data.recsys_stream import recsys_batch, vocab_sizes
from repro.models import recsys as ref
from repro.optim import AdamW as RefAdamW, constant as ref_constant
from repro_torch.configs.registry import get_config
from repro_torch.convert import (deepfm_params_from_numpy,
                                 tree_from_numpy, tree_to_numpy)
from repro_torch.models import recsys as port
from repro_torch.optim import AdamW, constant
from repro_torch.optim.tree import leaves
from test_torch_engine import release_reference_executables  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
BATCH = 64
LR = 1e-2
EPS = 1e-3


@pytest.mark.parametrize("width", [0, 3])
def test_dedup_positions_match_reference(width):
    rng = np.random.default_rng(width)
    pos = (rng.zipf(1.3, 500) % 97).astype(np.int32)     # many repeats
    shape = (500, width) if width else (500,)
    vals = rng.standard_normal(shape).astype(np.float32)
    want_pos, want_agg = ref._dedup_positions(jnp.asarray(pos),
                                              jnp.asarray(vals), 97)
    got_pos, got_agg = port._dedup_positions(torch.from_numpy(pos),
                                             torch.from_numpy(vals), 97)
    assert got_pos.dtype == torch.int32
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_allclose(got_agg.numpy(), np.asarray(want_agg), **TOL)
    n_unique = len(np.unique(pos))
    assert (got_pos.numpy()[n_unique:] == 97).all()
    assert not got_agg[n_unique:].any()


@pytest.fixture(scope="module")
def smoke():
    cfg, _ = get_config("deepfm", smoke=True)
    ref_cfg, _ = ref_get_config("deepfm", smoke=True)
    params = ref.init_deepfm(jax.random.PRNGKey(0), ref_cfg)
    offsets = ref.field_offsets(ref_cfg)
    batches = []
    for step in range(2):
        d = recsys_batch(0, step, BATCH, vocabs=vocab_sizes(cfg.vocab_scale))
        d["offsets"] = offsets
        batches.append(d)
    return cfg, ref_cfg, jax.tree_util.tree_map(np.asarray, params), batches


def test_lazy_step_matches_reference(smoke):
    cfg, ref_cfg, params_np, batches = smoke
    r_opt = RefAdamW(lr=ref_constant(LR), weight_decay=0.1, eps=EPS)
    p_opt = AdamW(lr=constant(LR), weight_decay=0.1, eps=EPS)
    r_step = jax.jit(ref.make_deepfm_train_step_lazy(ref_cfg, r_opt))
    p_step = port.make_deepfm_train_step_lazy(cfg, p_opt)
    r_params = jax.tree_util.tree_map(jnp.asarray, params_np)
    r_state = r_opt.init(r_params)
    rows = params_np["table"].shape[0]
    for batch in batches:
        p_params = deepfm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, r_params), "cpu")
        p_state = tree_from_numpy(
            jax.tree_util.tree_map(np.asarray, r_state), "cpu")
        touched = np.zeros(rows, bool)
        pos = np.asarray(ref.featurize(
            ref_cfg, jnp.asarray(batch["dense"]), jnp.asarray(batch["sparse"]),
            jnp.asarray(batch["offsets"])))
        touched[pos.reshape(-1)] = True
        old = (tree_to_numpy(p_params), tree_to_numpy(p_state))
        r_params, r_state, r_m = r_step(
            r_params, r_state, {k: jnp.asarray(v) for k, v in batch.items()})
        got_p, got_s, got_m = p_step(
            p_params, p_state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        np.testing.assert_allclose(float(got_m["loss"]),
                                   float(r_m["loss"]), **TOL)
        np.testing.assert_allclose(float(got_m["grad_norm"]),
                                   float(r_m["grad_norm"]), **TOL)
        assert int(got_s["step"]) == int(r_state["step"])
        for got, want, before in (
                (got_p, r_params, old[0]), (got_s["mu"], r_state["mu"],
                                            old[1]["mu"]),
                (got_s["nu"], r_state["nu"], old[1]["nu"])):
            for name in ("table", "first_order"):
                g = got[name].numpy()
                w = np.asarray(want[name])
                np.testing.assert_allclose(g[touched], w[touched], **TOL)
                np.testing.assert_array_equal(g[~touched],
                                              before[name][~touched])
            for a, b in zip(leaves({"mlp": got["mlp"], "bias": got["bias"]}),
                            jax.tree_util.tree_leaves(
                                {"mlp": want["mlp"], "bias": want["bias"]})):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        # the lazy step leaves its inputs as they were
        for a, b in zip(leaves(p_params), leaves(old[0])):
            np.testing.assert_array_equal(a.numpy(), b)


def test_lazy_step_has_no_sharded_form(smoke):
    cfg = smoke[0]
    with pytest.raises(NotImplementedError, match="item 11"):
        port.make_deepfm_train_step_lazy(cfg, AdamW(lr=constant(LR)),
                                         mesh=object())


@pytest.mark.parametrize("lazy", [False, True], ids=["dense", "lazy"])
def test_deepfm_loss_descends(smoke, lazy):
    """The reference's ``test_deepfm_loss_descends``, on both steps."""
    cfg, _, params_np, batches = smoke
    params = deepfm_params_from_numpy(params_np, "cpu")
    opt = AdamW(lr=constant(LR), weight_decay=0.0)
    make = (port.make_deepfm_train_step_lazy if lazy
            else port.make_deepfm_train_step)
    step = make(cfg, opt)
    st = opt.init(params)
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    first = None
    for _ in range(30):
        params, st, m = step(params, st, batch)
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < first * 0.9
