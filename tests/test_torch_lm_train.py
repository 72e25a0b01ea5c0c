"""LM training on the port (``repro_torch.models.transformer
.make_train_step``, ``forward(..., remat=)``, the chunked loss's gradient,
the attention's gradients) against the JAX reference and plain versions,
on the CPU, at the SMOKE configs.

The reference's step is ``make_train_step`` with
``launch.steps.make_optimizer``'s AdamW, compiled once per config and
dtype with XLA's excess precision off (``strict_jit``).  For three steps,
each package runs one step from the reference's state of that step on
``lm_batch(0, step, 2, 32, 128)``; the weights are the reference's
``init_lm(PRNGKey(0))``, carried across by ``convert``.  Both packages'
gradients are read off their new first moments, ``g = (mu' - b1 mu) /
(1 - b1)`` times the clipping's inverse scale, so the comparison runs
through each package's own step function end to end.  Tolerances:

- float32: the loss (and its two parts, the cross-entropy and the MoE's
  aux loss) within ``LOSS_RTOL`` = 1e-6 relative, the global
  gradient norm within 1e-5 relative, every gradient and every updated
  parameter within ``GRAD_TOL`` = 1e-4 of the leaf's largest (rtol the
  same);
- bfloat16 (qwen2 and deepseek, the configs' own dtype): the loss and
  its parts within 1e-2 relative and each leaf within ``BF16_TOL`` =
  1/16 of its largest, the tolerance of two bfloat16 layers in
  ``tests/test_torch_lm.py``; an updated parameter may
  also differ by twice the step's learning rate, since AdamW's first
  update is close to ``lr * sign(g)`` and a gradient within bfloat16
  noise of zero (a bias that starts at zero) can take either sign on
  either side.  In deepseek's MoE a token
  whose k-th and (k+1)-th router probabilities nearly tie (margin under
  ``NEAR_TIE``, ``tests/test_torch_lm.py``'s rule) can go to another
  expert on one side; where the port's routing had such a token, the
  MoE's own leaves (router and experts) are left out and the rest held.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import steps as ref_steps
from repro.models import transformer as ref
from repro_torch.convert import lm_params_from_numpy, tree_from_numpy
from repro_torch.data.tokens import lm_batch
from repro_torch.kernels.late_gather import ops as lg_ops
from repro_torch.kernels.late_gather.ref import late_gather_ref
from repro_torch.launch import steps as port_steps
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port
from repro_torch.optim import AdamW, constant
from repro_torch.optim.tree import leaves, paths, value_and_grad
from test_torch_engine import release_reference_executables  # noqa: F401
from test_torch_lm import RouteSpy
from test_torch_lm_layers import (LM_ARCHS, one_torch_thread,  # noqa: F401
                                  release_strict_executables, smoke,
                                  strict_jit)

STEPS = 3
B, S = 2, 32
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 1e-2}
NORM_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = 1e-4
BF16_TOL = 1 / 16
TRAIN_CASES = [(a, "float32") for a in LM_ARCHS] + [
    ("qwen2-0.5b", "bfloat16"), ("deepseek-v2-lite-16b", "bfloat16")]
MOE_KEYS = ("router", "w1", "w2", "w3")      # the MoE's own leaves
_INIT_LM = jax.jit(ref.init_lm, static_argnums=(1,))
_REF_STEPS = {}


def ref_step(ref_cfg):
    """The reference's train step for ``ref_cfg``, one closure a config,
    so ``strict_jit`` compiles it once."""
    key = dataclasses.astuple(ref_cfg)
    if key not in _REF_STEPS:
        _REF_STEPS[key] = strict_jit(ref.make_train_step(
            ref_cfg, ref_steps.make_optimizer()))
    return _REF_STEPS[key]


@pytest.fixture(scope="module", autouse=True)
def release_ref_steps():
    yield
    _REF_STEPS.clear()


def batch_at(step, b=B, s=S, vocab=128):
    return lm_batch(0, step, b, s, vocab)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def grads_from_moments(mu_new, mu_old, gnorm, b1):
    """The unclipped gradient, off an AdamW step's first moments (the
    clipping's max norm is 1)."""
    unclip = max(1.0, float(gnorm))
    return [(np.asarray(a, np.float64) - b1 * np.asarray(b, np.float64))
            / (1 - b1) * unclip for a, b in zip(mu_new, mu_old)]


def leaf_names(tree):
    return ["/".join(str(k) for k in path) for path, _ in paths(tree)]


def check_leaves(got, want, names, tol, what, skip=(), atol=0.0):
    """Each leaf within ``tol`` of its largest (rtol the same) plus
    ``atol``; returns the largest error over its leaf's largest."""
    worst = 0.0
    for g, w, name in zip(got, want, names):
        if any(k in name.split("/") for k in skip):
            continue
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.isfinite(g).all(), (what, name)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale + atol,
                                   err_msg=f"{what} {name}")
        worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


def f32_leaves(tree):
    return [np.asarray(jnp.asarray(x).astype(jnp.float32))
            for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("arch,dtype", TRAIN_CASES)
def test_train_step_matches_reference(arch, dtype, monkeypatch):
    ref_cfg, port_cfg = smoke(arch, dtype)
    params = _INIT_LM(jax.random.PRNGKey(0), ref_cfg)
    opt = ref_steps.make_optimizer()
    state = opt.init(params)
    step_fn = ref_step(ref_cfg)
    port_step = port.make_train_step(port_cfg, port_steps.make_optimizer())
    b1 = opt.b1
    names = leaf_names(lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu"))
    spy = RouteSpy(monkeypatch)
    for step in range(STEPS):
        batch = batch_at(step)
        host = jax.tree_util.tree_map(np.asarray, (params, state))
        p_params = lm_params_from_numpy(host[0], "cpu")
        p_state = tree_from_numpy(host[1], "cpu")
        spy.near.clear()
        got_p, got_state, got_m = port_step(p_params, p_state,
                                            torch_batch(batch))
        near = any(bool(m.any()) for m in spy.near)
        params, state, m = step_fn(params, state,
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        assert set(got_m) == set(m) == {"loss", "grad_norm", "xent", "aux"}
        for k in ("loss", "xent", "aux"):
            np.testing.assert_allclose(float(got_m[k]), float(m[k]),
                                       rtol=LOSS_RTOL[dtype], atol=1e-12,
                                       err_msg=k)
        np.testing.assert_allclose(float(got_m["grad_norm"]), gnorm,
                                   rtol=NORM_RTOL[dtype])
        skip = MOE_KEYS if (near and dtype == "bfloat16") else ()
        tol = GRAD_TOL if dtype == "float32" else BF16_TOL
        mu_old = jax.tree_util.tree_leaves(host[1]["mu"])
        want = grads_from_moments(jax.tree_util.tree_leaves(state["mu"]),
                                  mu_old, gnorm, b1)
        got = grads_from_moments([t.numpy() for t in
                                  leaves(got_state["mu"])], mu_old,
                                 float(got_m["grad_norm"]), b1)
        check_leaves(got, want, names, tol, f"step {step} gradient", skip)
        lr = float(opt.lr(jnp.int32(step + 1))) if dtype == "bfloat16" \
            else 0.0
        check_leaves([t.to(torch.float32).numpy() for t in leaves(got_p)],
                     f32_leaves(params), names, tol,
                     f"step {step} parameter", skip, atol=2 * lr)
        assert int(got_state["step"]) == int(state["step"]) == step + 1
        assert np.isfinite(loss)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_is_bit_equal(arch, dtype):
    """A step with ``remat`` (each layer recomputed in the backward) equals
    one without it bit for bit: parameters, moments and metrics."""
    _, cfg = smoke(arch, dtype)
    params = port.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = port_steps.make_optimizer()
    batch = torch_batch(batch_at(0))
    outs = [port.make_train_step(dataclasses.replace(cfg, remat=r), opt)(
        params, opt.init(params), batch) for r in (True, False)]
    (pa, sa, ma), (pb, sb, mb) = outs
    for a, b in zip(leaves([pa, sa]), leaves([pb, sb])):
        assert torch.equal(a, b)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_train_step_frees_its_tensors_without_the_cyclic_collector():
    """A step's gradients and outputs are freed when their last reference
    goes, with the cyclic collector off: no reference cycle holds them
    (``unflatten`` once held every leaf in one), so a training loop's old
    steps do not pile up on the card.  The first recomputed call of a
    process is made before (its lazy imports keep that call's frames)."""
    _, cfg = smoke("deepseek-v2-lite-16b", "float32")
    params = port.init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    opt = port_steps.make_optimizer()
    batch = torch_batch(batch_at(3))
    step = port.make_train_step(cfg, opt)
    step(params, opt.init(params), batch)
    gc.collect()
    gc.disable()
    try:
        _, grads = value_and_grad(lambda p: port.lm_loss(p, batch, cfg)[0],
                                  params)
        refs = [weakref.ref(t) for t in leaves(grads)]
        out = step(params, opt.init(params), batch)
        refs += [weakref.ref(t) for t in leaves(list(out[:2]))]
        del grads, out
        assert not any(r() is not None for r in refs)
    finally:
        gc.enable()


def whole_logits_loss(params, batch, cfg):
    """``lm_loss`` with the (B, S, V) logits made whole at once."""
    h, aux = port.forward(params, batch["tokens"], cfg)
    logits = (h @ params["unembed"].to(h.dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    xent = torch.mean(lse - gold)
    return xent + aux, {"xent": xent, "aux": aux}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_chunked_loss_gradient_matches_whole_logits(arch):
    """The chunked cross-entropy (each chunk recomputed in the backward)
    against the whole-logits loss: value and every gradient within 1e-6
    of the leaf's largest, float32."""
    _, cfg = smoke(arch, "float32")
    params = port.init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = torch_batch(batch_at(1))
    (loss, parts), grads = value_and_grad(port.lm_loss, params, batch, cfg,
                                          has_aux=True)
    (want, _), want_g = value_and_grad(whole_logits_loss, params, batch, cfg,
                                       has_aux=True)
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    check_leaves([t.numpy() for t in leaves(grads)],
                 [t.numpy() for t in leaves(want_g)], leaf_names(params),
                 1e-6, "chunked loss gradient")
    # the loss value keeps its bits with the gradient off
    with torch.no_grad():
        plain, plain_parts = port.lm_loss(params, batch, cfg)
    assert torch.equal(plain, loss)
    assert torch.equal(plain_parts["xent"], parts["xent"])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi3.5-moe-42b",
                                  "deepseek-v2-lite-16b"])
def test_late_gather_gradient_matches_the_plain_gather(arch, monkeypatch):
    """The step's gradients through ``late_gather`` (the token lookup, the
    MoE's dispatch and combine: ``LateGather``'s ``index_add_`` backward)
    against the same step with the plain gather and its own autograd
    (``index_select``), float32, within 1e-6 of each leaf's largest."""
    _, cfg = smoke(arch, "float32")
    params = port.init_lm(cfg, torch.Generator().manual_seed(2), "cpu")
    batch = torch_batch(batch_at(2))
    calls = []
    gather = lg_ops.LateGather.apply

    def counted(table, positions):
        calls.append(tuple(table.shape))
        return gather(table, positions)

    monkeypatch.setattr(lg_ops.LateGather, "apply", counted)
    loss, grads = value_and_grad(lambda p: port.lm_loss(p, batch, cfg)[0],
                                 params)
    moe = cfg.moe is not None
    # the lookup, then dispatch and combine a MoE layer, twice under remat
    assert len(calls) == 1 + (4 * cfg.n_layers if moe else 0)
    monkeypatch.setattr(port, "late_gather", late_gather_ref)
    monkeypatch.setattr(port_layers, "late_gather", late_gather_ref)
    want_loss, want = value_and_grad(
        lambda p: port.lm_loss(p, batch, cfg)[0], params)
    assert torch.equal(loss, want_loss)
    check_leaves([t.numpy() for t in leaves(grads)],
                 [t.numpy() for t in leaves(want)], leaf_names(params),
                 1e-6, "late_gather gradient")


# ---------------------------------------------------------------------------
# attention gradients against plain softmax attention
# ---------------------------------------------------------------------------

def plain_attention(q, k, v, *, causal, q_start, kv_len, window):
    """Softmax attention with every score at once, float64."""
    b, hkv, g, sq, dk = q.shape
    skv = k.shape[2]
    s = torch.einsum("bhgqd,bhcd->bhgqc", q, k) * dk ** -0.5
    qp = q_start + torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    valid = kp < kv_len
    if causal:
        valid = valid & (qp >= kp)
    if window is not None:
        valid = valid & (qp - kp < window)
    s = s.masked_fill(~valid, -torch.inf)
    return torch.einsum("bhgqc,bhcd->bhgqd", torch.softmax(s, -1), v)


GRAD_ATTN_CASES = {
    # name: (Sq, Skv, q_start, kv_len, causal, chunk, window)
    "prefill": (24, 24, 0, 24, True, 16, None),
    "prefill_window": (24, 24, 0, 24, True, 16, 5),
    "one_chunk": (9, 9, 0, 9, True, 16, None),
    "offset_padded": (3, 40, 30, 33, True, 16, 7),
    "noncausal": (5, 20, 0, 13, False, 8, None),
}


def attention_inputs(sq, skv, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .requires_grad_(True)
            for shape in ((2, 2, 3, sq, 16), (2, 2, skv, 16),
                          (2, 2, skv, 12))]


def check_attention_grads(got, inputs, want_fn, what):
    cot = torch.from_numpy(np.random.default_rng(99).standard_normal(
        tuple(got.shape)).astype(np.float32))
    grads = torch.autograd.grad(got, inputs, cot)
    wide = [t.detach().double().requires_grad_(True) for t in inputs]
    want = want_fn(*wide)
    np.testing.assert_allclose(got.detach().double().numpy(),
                               want.detach().numpy(), rtol=1e-5, atol=1e-5)
    want_g = torch.autograd.grad(want, wide, cot.double())
    for name, g, w in zip("qkv", grads, want_g):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.double().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale,
                                   err_msg=f"{what} d{name}")


@pytest.mark.parametrize("case", list(GRAD_ATTN_CASES))
def test_chunked_attention_gradient(case):
    sq, skv, q_start, kv_len, causal, chunk, window = GRAD_ATTN_CASES[case]
    q, k, v = attention_inputs(sq, skv, 4)
    kw = dict(causal=causal, q_start=q_start, kv_len=kv_len, window=window)
    got = port_layers.chunked_attention(q, k, v, chunk=chunk, **kw)
    check_attention_grads(got, [q, k, v],
                          lambda q, k, v: plain_attention(q, k, v, **kw),
                          case)


@pytest.mark.parametrize("window", [None, 6])
def test_blocked_causal_attention_gradient(window):
    q, k, v = attention_inputs(40, 40, 5)
    got = port_layers.blocked_causal_attention(q, k, v, q_block=16, chunk=8,
                                               window=window)
    check_attention_grads(
        got, [q, k, v],
        lambda q, k, v: plain_attention(q, k, v, causal=True, q_start=0,
                                        kv_len=40, window=window),
        f"blocked window={window}")


def test_attention_keeps_its_bits_with_the_gradient_off():
    """The serving path (no gradient recorded) and the recorded path give
    the same bits."""
    q, k, v = attention_inputs(24, 24, 6)
    kw = dict(causal=True, chunk=16, q_start=0, kv_len=24, window=5)
    recorded = port_layers.chunked_attention(q, k, v, **kw)
    with torch.no_grad():
        plain = port_layers.chunked_attention(q, k, v, **kw)
    assert torch.equal(recorded.detach(), plain)


# ---------------------------------------------------------------------------
# the reference's own descent test, on the port
# ---------------------------------------------------------------------------

def tiny_configs():
    """``tests/test_models_lm.py``'s TINY, TINY_MOE and TINY_MLA."""
    from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig
    tiny = LMConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, vocab=97, attn_chunk=16,
                    loss_chunk=8, dtype="float32")
    moe = dataclasses.replace(
        tiny, n_kv_heads=4,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared=1, d_expert=32,
                      capacity_factor=8.0))
    mla = dataclasses.replace(
        moe, mla=MLAConfig(kv_lora_rank=32, rope_head_dim=8,
                           nope_head_dim=16, v_head_dim=16))
    return {"gqa": tiny, "moe": moe, "mla-moe": mla}


@pytest.mark.parametrize("name", ["gqa", "moe", "mla-moe"])
def test_loss_descends_on_fixed_batch(name):
    cfg = tiny_configs()[name]
    params = port.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = AdamW(lr=constant(3e-3), weight_decay=0.0)
    state = opt.init(params)
    step = port.make_train_step(cfg, opt)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    first = None
    for _ in range(25):
        params, state, m = step(params, state, batch)
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < first * 0.7, (first, float(m["loss"]))
