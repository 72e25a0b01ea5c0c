"""The port's decoder-only LMs (``repro_torch.models.transformer``) and LM
serving (``repro_torch.launch.serve.serve_batch``) against the JAX
reference, on the CPU, at every SMOKE config in float32 and in the
configs' bfloat16.

The reference's ``init_lm`` weights cross by
``convert.lm_params_from_numpy``; tokens come from ``lm_batch`` (numpy,
the same on both sides).  Each reference function is compiled once per
config and shape with XLA's excess precision off (``strict_jit``, shared
with ``tests/test_torch_lm_layers.py``).  Tolerances, relative to the
largest magnitude of the reference's output (``scale``):

- float32: within ``F32_TOL`` = 1e-4 of scale over the two layers and the
  cache; the greedy tokens of ``serve_batch`` equal;
- bfloat16: within ``BF16_TOL`` = 1/16 of scale (eight bfloat16 steps at
  the largest magnitude, after two layers of rounding in another order);
  the loss within 1e-2 relative.  In the MoE archs a bfloat16 step of
  difference upstream can move a token to another expert where its k-th
  and (k+1)-th router probabilities tie or nearly tie; a token row
  beyond the tolerance must be such a token: one whose port-side routing
  had a top-k margin under ``NEAR_TIE`` = 1/32 (relative) in some layer.
  Every other row is held to the tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as ref_serve
from repro.models import transformer as ref
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.tokens import lm_batch
from repro_torch.kernels.late_gather import ops as lg_ops
from repro_torch.launch import serve as port_serve
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port
from test_torch_engine import release_reference_executables  # noqa: F401
from test_torch_lm_layers import (LM_ARCHS, f64,  # noqa: F401
                                  one_torch_thread,
                                  release_strict_executables, smoke,
                                  strict_jit, to_torch)

F32_TOL = 1e-4
BF16_TOL = 1 / 16
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
NEAR_TIE = 1 / 32
DTYPES = ("float32", "bfloat16")
B, S = 2, 32
_INIT_LM = jax.jit(ref.init_lm, static_argnums=(1,))


@pytest.fixture(scope="module")
def model():
    """(arch, dtype, **changes) -> (reference config, port config,
    reference params, port params), the weights from PRNGKey(0), made once
    per arch."""
    weights = {}

    def get(arch, dtype, **changes):
        ref_cfg, port_cfg = smoke(arch, dtype, **changes)
        if arch not in weights:
            p = _INIT_LM(jax.random.PRNGKey(0), ref_cfg)
            weights[arch] = p, lm_params_from_numpy(
                jax.tree_util.tree_map(np.asarray, p), "cpu")
        return (ref_cfg, port_cfg) + weights[arch]
    return get


def tokens(seed=0, b=B, s=S, vocab=128):
    return lm_batch(seed, 0, b, s, vocab)


class RouteSpy:
    """Records, for each of the port's ``moe_route`` calls, the tokens
    whose k-th and (k+1)-th router probabilities are within NEAR_TIE of
    each other (relative to the k-th)."""

    def __init__(self, monkeypatch):
        self.near = []
        inner = port_layers.moe_route

        def spy(p, xt, cfg):
            route = inner(p, xt, cfg)
            k = cfg.moe.top_k
            ps = torch.sort(route.probs, dim=-1, descending=True).values
            margin = (ps[:, k - 1] - ps[:, k]) / ps[:, k - 1]
            self.near.append((margin < NEAR_TIE).numpy())
            return route

        monkeypatch.setattr(port_layers, "moe_route", spy)

    def tokens(self, n: int) -> np.ndarray:
        """(n,) bool: the token had a near tie in some call of n tokens."""
        calls = [m for m in self.near if m.shape[0] == n]
        return np.any(calls, axis=0) if calls else np.zeros(n, bool)


def check(got, want, dtype, what, near=None):
    """``got`` within the dtype's tolerance of ``want`` (the leading axes
    are token rows); rows beyond it allowed only where ``near`` (bool,
    per row) marks a near tie in the port's routing."""
    got, want = f64(got), f64(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    tol = (F32_TOL if dtype == "float32" else BF16_TOL) * scale
    err = np.abs(got - want)
    rows = err.reshape(near.shape + (-1,)).max(-1) if near is not None \
        else None
    bad = (rows > tol) if rows is not None else err > tol
    allowed = near if (near is not None and dtype == "bfloat16") else \
        np.zeros_like(bad)
    assert not (bad & ~allowed).any(), (
        f"{what}: max error {float(err.max())} > {tol} (scale {scale}) "
        f"at rows {np.argwhere(bad & ~allowed)[:8].tolist()}")
    return float(err.max())


def is_moe(cfg):
    return cfg.moe is not None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_loss(model, arch, dtype, monkeypatch):
    ref_cfg, port_cfg, rp, tp = model(arch, dtype)
    batch = tokens()
    spy = RouteSpy(monkeypatch)
    h, aux = port.forward(tp, torch.from_numpy(batch["tokens"]), port_cfg)
    want_h, want_aux = strict_jit(ref.forward, cfg=ref_cfg)(
        rp, jnp.asarray(batch["tokens"]))
    near = spy.tokens(B * S).reshape(B, S) if is_moe(port_cfg) else None
    assert h.dtype == getattr(torch, dtype)
    check(h, want_h, dtype, "hidden", near)
    np.testing.assert_allclose(float(aux), float(want_aux),
                               rtol=LOSS_RTOL[dtype])
    loss, parts = port.lm_loss(tp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, port_cfg)
    want_loss, want_parts = strict_jit(ref.lm_loss, cfg=ref_cfg)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL[dtype])
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(parts[k]), float(want_parts[k]),
                                   rtol=LOSS_RTOL[dtype])


def _prefill_and_decode(model, arch, dtype, monkeypatch, steps=3,
                        max_len=S + 4, **changes):
    """Prefill S tokens into a cache of ``max_len`` and decode ``steps``
    tokens on both sides, checking the logits and the caches at each
    step."""
    ref_cfg, port_cfg, rp, tp = model(arch, dtype, **changes)
    batch = tokens(seed=1)
    spy = RouteSpy(monkeypatch)
    launches = lg_ops.LAUNCHES
    logits, cache = port.prefill(tp, torch.from_numpy(batch["tokens"]),
                                 port_cfg, max_len=max_len)
    want, wcache = strict_jit(ref.prefill, cfg=ref_cfg, max_len=max_len)(
        rp, jnp.asarray(batch["tokens"]))
    moe = is_moe(port_cfg)
    near = spy.tokens(B * S).reshape(B, S) if moe else None
    # the cache positions a near-tie token wrote, from layer 1 on
    cache_near = np.zeros((B, max_len), bool) if moe else None
    if moe:
        cache_near[:, :S] = near
    assert logits.dtype == torch.float32 and cache.length == S
    assert int(wcache.length) == S
    check(logits, want, dtype, "prefill logits",
          near.any(1) if moe else None)
    _check_cache(cache, wcache, dtype, cache_near, "prefill")
    decode = strict_jit(ref.decode_step, cfg=ref_cfg)
    nxt = batch["labels"][:, -1]
    for i in range(steps):
        spy.near.clear()
        logits, cache = port.decode_step(tp, torch.from_numpy(nxt), cache,
                                         port_cfg)
        want, wcache = decode(rp, jnp.asarray(nxt), wcache)
        step_near = None
        if moe:
            step_near = spy.tokens(B)
            cache_near[:, min(S + i, max_len - 1)] |= step_near
            step_near = step_near | near.any(1)
        check(logits, want, dtype, f"decode {i} logits", step_near)
        assert cache.length == int(wcache.length) == S + i + 1
        nxt = (nxt * 7 + 3 + i) % port_cfg.vocab
    _check_cache(cache, wcache, dtype, cache_near, "decode")
    assert lg_ops.LAUNCHES == launches         # CPU: no kernel launch
    return cache


def _check_cache(cache, wcache, dtype, near, what):
    """Both caches, layer by layer; where ``near`` ((B, Smax) bool) marks
    a position written by a near-tie token, it may differ from layer 1 on
    (that token's layer-0 output moved it)."""
    for got, want in ((cache.a, wcache.a), (cache.b, wcache.b)):
        assert got.dtype == to_torch(want).dtype
        g, w = f64(got), f64(want)
        for layer in range(g.shape[0]):
            check(g[layer], w[layer], dtype, f"{what} cache layer {layer}",
                  near if layer > 0 else None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode(model, arch, dtype, monkeypatch):
    _prefill_and_decode(model, arch, dtype, monkeypatch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("changes", [
    {"attn_q_block": 8}, {"prefill_via_cache": True}, {"attn_window": 5}],
    ids=["attn_q_block", "prefill_via_cache", "attn_window"])
def test_prefill_variants(model, arch, changes, monkeypatch):
    """The q-blocked triangular prefill, the legacy prefill against the
    padded cache and a sliding window, in float32 (the streaming prefill
    runs the forward's attention)."""
    _prefill_and_decode(model, arch, "float32", monkeypatch, steps=2,
                        **changes)


@pytest.mark.parametrize("arch", ["stablelm-12b", "deepseek-v2-lite-16b"])
def test_cache_writes_past_its_end(model, arch, monkeypatch):
    """A cache exactly as long as the prompt: each decode step writes past
    its end and lands at Smax - 1 (``dynamic_update_slice`` clamps), with
    the query still at its own position; then a streaming block of 4
    tokens at length S + 2 lands at Smax - 4 (``_block_fwd``'s write)."""
    cache = _prefill_and_decode(model, arch, "float32", monkeypatch,
                                steps=2, max_len=S)
    assert cache.length == S + 2 and cache.a.shape[2] == S
    ref_cfg, port_cfg, rp, tp = model(arch, "float32")
    toks = tokens(seed=3)["tokens"]
    _, wcache = strict_jit(ref.prefill, cfg=ref_cfg, max_len=S)(
        rp, jnp.asarray(toks))
    wcache = wcache._replace(length=jnp.int32(S + 2))
    _, pcache = port.prefill(tp, torch.from_numpy(toks), port_cfg,
                             max_len=S)
    pcache = pcache._replace(length=S + 2)
    block = tokens(seed=4, s=4)["tokens"]
    want, wcache = strict_jit(ref._block_fwd, cfg=ref_cfg)(
        rp, jnp.asarray(block), cache=wcache)
    got, pcache = port._block_fwd(tp, torch.from_numpy(block), port_cfg,
                                  pcache)
    check(got, want, "float32", "block logits")
    _check_cache(pcache, wcache, "float32", None, "block")
    assert pcache.length == int(wcache.length) == S + 6


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_batch_tokens(model, arch):
    """``serve_batch``'s greedy tokens equal the reference's, in float32."""
    ref_cfg, port_cfg, rp, tp = model(arch, "float32")
    prompts = tokens(seed=5, s=12)["tokens"]
    want, want_stats = ref_serve.serve_batch(ref_cfg, rp,
                                             jnp.asarray(prompts), 6)
    got, stats = port_serve.serve_batch(port_cfg, tp,
                                        torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == set(want_stats)
    assert stats["tok_per_s"] == pytest.approx(B * 6 / stats["decode_s"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_bf16_held_weights_are_bit_equal(model, arch):
    """Every weight is cast to ``cfg.dtype`` at use, so bfloat16-held
    weights give the same bits as float32-held ones, in the forward, the
    prefill and a decode step."""
    _, port_cfg, _, tp = model(arch, "bfloat16")
    held = port.init_lm(port_cfg, torch.Generator().manual_seed(0), "cpu",
                        dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16
               for t in jax.tree_util.tree_leaves(held))
    f32 = jax.tree_util.tree_map(lambda t: t.to(torch.float32), held)
    for a, b in ((tp, jax.tree_util.tree_map(
            lambda t: t.to(torch.bfloat16), tp)), (f32, held)):
        toks = torch.from_numpy(tokens(seed=6)["tokens"])
        h32, aux32 = port.forward(a, toks, port_cfg)
        h16, aux16 = port.forward(b, toks, port_cfg)
        assert torch.equal(h32, h16) and torch.equal(aux32, aux16)
        l32, c32 = port.prefill(a, toks, port_cfg, max_len=S + 1)
        l16, c16 = port.prefill(b, toks, port_cfg, max_len=S + 1)
        assert torch.equal(l32, l16)
        nxt = toks[:, 0]
        l32, c32 = port.decode_step(a, nxt, c32, port_cfg)
        l16, c16 = port.decode_step(b, nxt, c16, port_cfg)
        assert torch.equal(l32, l16)
        assert torch.equal(c32.a, c16.a) and torch.equal(c32.b, c16.b)


def test_init_lm_has_the_reference_tree(model):
    """``init_lm`` draws the reference's tree: the same keys, shapes and
    dtypes, the norms ones and the biases zero."""
    for arch in LM_ARCHS:
        _, port_cfg, rp, _ = model(arch, "float32")
        got = port.init_lm(port_cfg, torch.Generator().manual_seed(1), "cpu")
        want_paths = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
                      for k, v in jax.tree_util.tree_leaves_with_path(rp)}
        got_paths = {jax.tree_util.keystr(k): (tuple(v.shape),
                                               str(v.dtype)[6:])
                     for k, v in jax.tree_util.tree_leaves_with_path(got)}
        assert got_paths == want_paths
        assert bool((got["final_ln"] == 1).all())
        assert bool((got["layers"]["ln1"] == 1).all())
        if port_cfg.qkv_bias:
            assert not bool(got["layers"]["attn"]["bq"].any())
        assert float(got["embed"].std()) == pytest.approx(0.02, rel=0.1)


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    """Without ``device`` the entry points take the card; with no card they
    raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_cfg = smoke("qwen2-0.5b", "float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.init_lm(port_cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.init_cache(port_cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.main(["--arch", "qwen2-0.5b", "--smoke"])


def test_serve_entry_runs_on_the_cpu(capsys):
    stats = port_serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device",
                             "cpu", "--batch", "2", "--prompt-len", "8",
                             "--gen", "3"])
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
