"""The port's transformer building blocks (``repro_torch.models.layers``),
LM configs, registry entries and token stream against the JAX reference,
on the CPU.

Inputs are made with numpy from a seed; a bfloat16 input crosses as the
same bits.  Weights come from the reference's ``init_*`` functions and
cross as numpy arrays.  Each reference function is jitted and compiled
once per config and shape (``strict_jit``), with XLA's excess precision
off, so a bfloat16 op rounds where the reference's code says.
Tolerances, relative to the largest magnitude of the reference's
output (``scale``):

- float32: within ``F32_TOL`` = 1e-5 of scale (the two packages sum dot
  products in another order);
- bfloat16: within ``BF16_TOL`` = 1/32 of scale, four bfloat16 steps at
  the largest magnitude (XLA may keep float32 between fused elementwise
  ops where PyTorch rounds after each);
- the MoE's aux loss within ``AUX_RTOL`` (1e-5 relative in float32,
  1e-4 in bfloat16);
- integers (the MoE's routing: order, counts, dispatch) exactly.

The MoE's routing intermediates are read off the reference's own run: its
``moe_ffn`` is traced with ``sort_positions_by_key`` wrapped to return
the keys (each choice's expert), the order and the counts it computes
beside its output; the reference's dispatch is then rebuilt from those
by its formula.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as ref_registry
from repro.data import tokens as ref_tokens
from repro.models import layers as ref
from repro_torch.configs import registry as port_registry
from repro_torch.convert import tree_from_numpy
from repro_torch.data import tokens as port_tokens
from repro_torch.kernels.late_gather import ops as lg_ops
from repro_torch.models import layers as port
from test_torch_engine import release_reference_executables  # noqa: F401

F32_TOL = 1e-5
BF16_TOL = 1 / 32
# the MoE aux loss, relative (its float32 softmax of bfloat16 logits)
AUX_RTOL = {"float32": 1e-5, "bfloat16": 1e-4}
LM_ARCHS = ("qwen2-0.5b", "stablelm-1.6b", "stablelm-12b", "phi3.5-moe-42b",
            "deepseek-v2-lite-16b")
GQA_ARCHS = ("qwen2-0.5b", "stablelm-1.6b", "stablelm-12b")
MOE_ARCHS = ("phi3.5-moe-42b", "deepseek-v2-lite-16b")
DTYPES = ("float32", "bfloat16")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

_COMPILED = {}


def strict_jit(fn, **static):
    """``fn`` with the keyword arguments ``static`` bound, jitted and
    compiled once per ``static`` and argument shapes with XLA's
    ``xla_allow_excess_precision`` off, so every bfloat16 op rounds where
    the reference's code says (as it does run eagerly) instead of staying
    float32 across a fusion."""
    def call(*args, **kwargs):
        leaves, tree = jax.tree_util.tree_flatten((args, kwargs))
        key = (fn, tuple(sorted(static.items())), tree,
               tuple((np.shape(a), jnp.result_type(a)) for a in leaves))
        if key not in _COMPILED:
            _COMPILED[key] = jax.jit(functools.partial(fn, **static)).lower(
                *args, **kwargs).compile(
                    compiler_options={"xla_allow_excess_precision": False})
        return _COMPILED[key](*args, **kwargs)
    return call


@pytest.fixture(scope="module", autouse=True)
def release_strict_executables():
    """Drop the executables ``strict_jit`` compiled once the module is
    done: XLA keeps every compiled CPU executable mapped (ROADMAP §3)."""
    yield
    _COMPILED.clear()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread a worker, so that
    several test workers' thread pools do not wait on each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jit_init(init):
    """A reference ``init_*(key, cfg)``, jitted (the same numbers as run
    eagerly, in one compile)."""
    return jax.jit(init, static_argnums=(1,))


_RMS = strict_jit(ref.rmsnorm)
_DENSE = strict_jit(ref.dense_ffn)


def smoke(arch, dtype="bfloat16", **changes):
    """The reference's and the port's SMOKE config of ``arch`` (equal field
    for field) with ``dtype`` and ``changes``."""
    ref_cfg, _ = ref_registry.get_config(arch, smoke=True)
    port_cfg, _ = port_registry.get_config(arch, smoke=True)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(port_cfg)
    return (dataclasses.replace(ref_cfg, dtype=dtype, **changes),
            dataclasses.replace(port_cfg, dtype=dtype, **changes))


def to_torch(a) -> "torch.Tensor":
    """A JAX or numpy array as a tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def params_of(tree):
    return tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def normal(seed, shape, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype])


def assert_close(got, want, dtype, what=""):
    got, want = f64(got), f64(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    tol = (F32_TOL if dtype == "float32" else BF16_TOL) * scale
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max error {err} > {tol} (scale {scale})"


# ---------------------------------------------------------------------------
# configs, registry, tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("smoke_cfg", [False, True])
def test_lm_config_matches_reference(arch, smoke_cfg):
    ref_cfg, ref_family = ref_registry.get_config(arch, smoke_cfg)
    port_cfg, family = port_registry.get_config(arch, smoke_cfg)
    assert family == ref_family == "lm"
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
    assert port_cfg.head_dim == ref_cfg.head_dim
    assert port_cfg.param_count() == ref_cfg.param_count()
    assert port_cfg.active_param_count() == ref_cfg.active_param_count()


def test_lm_shapes_match_reference():
    for smoke_shapes in (False, True):
        assert port_registry.shapes_for("lm", smoke_shapes) == \
            ref_registry.shapes_for("lm", smoke_shapes)
    assert {a for a, (f, _) in port_registry.ARCHS.items() if f == "lm"} \
        == {a for a, (f, _) in ref_registry.ARCHS.items() if f == "lm"}
    # every LM arch has its cells (tests/test_torch_launch_train.py holds
    # them, and the whole cells() listing, against the reference)
    assert {c.arch for c in port_registry.cells(smoke=True)
            if c.family == "lm"} == set(LM_ARCHS)


@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (0, 0, 2, 32, 128), (7, 3, 4, 65, 151936), (1, 12, 1, 8, 5)])
def test_lm_batch_is_bit_equal(seed, step, batch, seq, vocab):
    want = ref_tokens.lm_batch(seed, step, batch, seq, vocab)
    got = port_tokens.lm_batch(seed, step, batch, seq, vocab)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_lm_batch_on_device_draws_from_its_generator():
    gen = torch.Generator().manual_seed(3)
    b = port_tokens.lm_batch_on_device(gen, 3, 17, 50)
    again = port_tokens.lm_batch_on_device(torch.Generator().manual_seed(3),
                                           3, 17, 50)
    assert b["tokens"].shape == b["labels"].shape == (3, 17)
    assert b["tokens"].dtype == torch.int32
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 50
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert torch.equal(b["tokens"], again["tokens"])


# ---------------------------------------------------------------------------
# norms, rope, attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    x = normal(1, (3, 9, 64), dtype) * 3
    w = normal(2, (64,))
    want = _RMS(x, w, 1e-6)
    got = port.rmsnorm(to_torch(x), to_torch(w), 1e-6)
    assert got.dtype == to_torch(want).dtype
    assert_close(got, want, dtype, "rmsnorm")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(dtype, theta):
    x = normal(3, (2, 11, 4, 16), dtype)
    pos = np.arange(11) + 1000
    want = strict_jit(ref.apply_rope, theta=theta)(x, jnp.asarray(pos))
    got = port.apply_rope(to_torch(x), torch.from_numpy(pos), theta)
    assert_close(got, want, dtype, "apply_rope")
    ang_want = ref.rope_angles(jnp.asarray(pos), 16, theta)
    ang_got = port.rope_angles(torch.from_numpy(pos), 16, theta)
    assert_close(ang_got, ang_want, "float32", "rope_angles")


ATTN_CASES = {
    # name: (Sq, Skv, q_start, kv_len, causal, chunk, window)
    "prefill": (24, 24, 0, 24, True, 16, None),
    "prefill_window": (24, 24, 0, 24, True, 16, 5),
    "decode_padded": (1, 40, 36, 37, True, 16, None),
    "decode_window": (3, 40, 30, 33, True, 16, 7),
    "noncausal": (5, 20, 0, 13, False, 8, None),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("mask_at_once", [True, False])
def test_chunked_attention(case, dtype, mask_at_once, monkeypatch):
    """Each case with every chunk's mask made at once (a decode step's
    few queries) and chunk by chunk (a long prefill's)."""
    monkeypatch.setattr(port, "MASK_AT_ONCE", 1 << 30 if mask_at_once else 0)
    sq, skv, q_start, kv_len, causal, chunk, window = ATTN_CASES[case]
    q = normal(4, (2, 2, 3, sq, 16), dtype)
    k = normal(5, (2, 2, skv, 16), dtype)
    v = normal(6, (2, 2, skv, 12), dtype)
    want = strict_jit(ref.chunked_attention, causal=causal, chunk=chunk,
                      window=window)(q, k, v, q_start=q_start, kv_len=kv_len)
    got = port.chunked_attention(to_torch(q), to_torch(k), to_torch(v),
                                 causal=causal, chunk=chunk, q_start=q_start,
                                 kv_len=kv_len, window=window)
    assert got.dtype == to_torch(want).dtype
    assert_close(got, want, dtype, case)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 6])
def test_blocked_causal_attention(dtype, window):
    q = normal(7, (1, 2, 2, 40, 8), dtype)
    k = normal(8, (1, 2, 40, 8), dtype)
    v = normal(9, (1, 2, 40, 8), dtype)
    want = strict_jit(ref.blocked_causal_attention, q_block=16, chunk=8,
                      window=window)(q, k, v)
    got = port.blocked_causal_attention(to_torch(q), to_torch(k),
                                        to_torch(v), q_block=16, chunk=8,
                                        window=window)
    assert_close(got, want, dtype, "blocked")
    # the blocked path is the plain one with the fully masked chunks skipped
    plain = port.chunked_attention(to_torch(q), to_torch(k), to_torch(v),
                                   causal=True, chunk=8, q_start=0,
                                   kv_len=40, window=window)
    assert_close(got, plain, dtype, "blocked vs chunked")


# ---------------------------------------------------------------------------
# GQA and MLA attention, with and without a cache
# ---------------------------------------------------------------------------

def _attention_case(arch, dtype, seed, changes=None):
    ref_cfg, port_cfg = smoke(arch, dtype, **(changes or {}))
    init = _jit_init(ref.init_mla if ref_cfg.mla is not None else
                     ref.init_gqa)
    p = init(jax.random.PRNGKey(seed), ref_cfg)
    if ref_cfg.qkv_bias:      # the reference's zeros, made visible
        for name in ("bq", "bk", "bv"):
            p[name] = normal(seed + 50, p[name].shape) * 0.1
    return ref_cfg, port_cfg, p, params_of(p)


def _cache_arrays(cfg, dtype, b, smax, seed):
    if cfg.mla is not None:
        shapes = [(b, smax, cfg.mla.kv_lora_rank),
                  (b, smax, cfg.mla.rope_head_dim)]
    else:
        shapes = [(b, smax, cfg.n_kv_heads, cfg.head_dim)] * 2
    return [normal(seed + i, s, dtype) for i, s in enumerate(shapes)]


# GQA with a bias and 7 query heads a KV head, GQA with 2, and MLA
# (stablelm-1.6b's full MHA runs in tests/test_torch_lm.py)
ATTN_ARCHS = ("qwen2-0.5b", "stablelm-12b", "deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch,variant,dtype", [
    *((a, "plain", d) for a in ATTN_ARCHS for d in DTYPES),
    *((a, v, "bfloat16") for a in ("qwen2-0.5b", "deepseek-v2-lite-16b")
      for v in ("q_block", "window"))])
def test_attention_without_cache(arch, dtype, variant):
    """The prefill path, plain in both dtypes; q-blocked and windowed in
    bfloat16 (in float32 they run in ``tests/test_torch_lm.py``'s
    prefill variants)."""
    changes = {"q_block": {"attn_q_block": 8},
               "window": {"attn_window": 5}, "plain": {}}[variant]
    ref_cfg, port_cfg, p, tp = _attention_case(arch, dtype, 11, changes)
    fn = strict_jit(ref.mla_attention if ref_cfg.mla is not None else
                    ref.gqa_attention, cfg=ref_cfg)
    port_fn = port.mla_attention if ref_cfg.mla is not None else \
        port.gqa_attention
    x = normal(12, (2, 20, ref_cfg.d_model), dtype)
    pos = np.arange(20)
    want, (wa, wb) = fn(p, x, positions=jnp.asarray(pos))
    got, (ga, gb) = port_fn(tp, to_torch(x), port_cfg,
                            positions=torch.from_numpy(pos))
    assert_close(got, want, dtype, "out")
    assert_close(ga, wa, dtype, "fresh cache a")
    assert_close(gb, wb, dtype, "fresh cache b")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ATTN_ARCHS)
@pytest.mark.parametrize("cur,s", [(5, 1), (9, 3), (23, 1), (22, 3), (30, 1)])
def test_attention_with_cache(arch, dtype, cur, s):
    """The decode path against a seeded cache of Smax = 24: a block inside
    it, one at its end, and blocks written past it (cur + s > Smax), which
    land at Smax - s as ``dynamic_update_slice`` clamps them while the
    queries keep their positions cur..cur+s-1.  MLA runs its absorbed
    path."""
    ref_cfg, port_cfg, p, tp = _attention_case(arch, dtype, 13)
    fn = strict_jit(ref.mla_attention if ref_cfg.mla is not None else
                    ref.gqa_attention, cfg=ref_cfg)
    port_fn = port.mla_attention if ref_cfg.mla is not None else \
        port.gqa_attention
    ca, cb = _cache_arrays(ref_cfg, dtype, 2, 24, 14)
    x = normal(16, (2, s, ref_cfg.d_model), dtype)
    pos = cur + np.arange(s)
    want, (wa, wb) = fn(p, x, positions=jnp.asarray(pos),
                        cache=(ca, cb, cur))
    ta, tb = to_torch(ca), to_torch(cb)
    got, (ga, gb) = port_fn(tp, to_torch(x), port_cfg,
                            positions=torch.from_numpy(pos),
                            cache=(ta, tb, cur))
    assert ga.data_ptr() == ta.data_ptr()          # written in place
    assert_close(got, want, dtype, "out")
    # the caches outside the written block keep their bits, the block is
    # where the reference put it
    start = min(cur, 24 - s)
    for g, w in ((ga, wa), (gb, wb)):
        keep = np.ones(24, bool)
        keep[start:start + s] = False
        np.testing.assert_array_equal(f64(g)[:, keep], f64(w)[:, keep])
        assert_close(g[:, start:start + s], np.asarray(w)[:, start:start + s],
                     dtype, "written block")


def test_write_block_clamps_as_dynamic_update_slice():
    cache = torch.zeros((1, 6, 2))
    for start in (0, 2, 4, 5, 9):
        block = torch.full((1, 2, 2), float(start))
        c = cache.clone()
        port.write_block(c, block, start)
        want = jax.lax.dynamic_update_slice(jnp.zeros((1, 6, 2)),
                                            jnp.full((1, 2, 2), float(start)),
                                            (0, start, 0))
        np.testing.assert_array_equal(c.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_ffn(dtype):
    p = jax.jit(ref.init_dense_ffn, static_argnums=(1, 2))(
        jax.random.PRNGKey(3), 64, 96)
    x = normal(17, (2, 9, 64), dtype)
    assert_close(port.dense_ffn(params_of(p), to_torch(x)), _DENSE(p, x),
                 dtype, "dense_ffn")


def _moe_traced(p, x, cfg):
    """The reference's ``moe_ffn`` with the keys, order and counts its
    ``sort_positions_by_key`` computes (installed by ``ref_moe_with_routing``
    while the function is traced)."""
    seen = {}
    inner = _moe_traced.inner

    def spy(keys, num_buckets):
        order, counts = inner(keys, num_buckets)
        seen.update(keys=keys, order=order, counts=counts)
        return order, counts

    ref.sort_positions_by_key = spy
    try:
        out, aux = ref.moe_ffn(p, x, cfg)
    finally:
        ref.sort_positions_by_key = inner
    return out, aux, seen["keys"], seen["order"], seen["counts"]


_moe_traced.inner = ref.sort_positions_by_key


def ref_moe_with_routing(p, x, cfg):
    """The reference's ``moe_ffn`` output and aux loss, with the keys,
    order and counts its ``sort_positions_by_key`` computed, and its
    dispatch rebuilt from those by its own formula
    (``layers.py:405-413``)."""
    out, aux, keys, order, counts = strict_jit(_moe_traced, cfg=cfg)(p, x)
    keys, order, counts = (np.asarray(a) for a in (keys, order, counts))
    e = cfg.moe
    t = x.shape[0] * x.shape[1]
    cap = int(e.capacity_factor * t * e.top_k / e.num_experts + 1)
    cap = max(8, -(-cap // 8) * 8)
    starts = np.cumsum(counts) - counts
    sorted_e = keys[order]
    rank = np.arange(t * e.top_k) - starts[sorted_e]
    keep = rank < cap
    slot = np.where(keep, sorted_e * cap + rank, e.num_experts * cap)
    dispatch = np.full(e.num_experts * cap + 1, t, np.int32)
    dispatch[slot] = np.where(keep, order // e.top_k, t)
    return out, aux, dict(keys=keys, order=order, counts=counts, cap=cap,
                          keep=keep, slot=slot, dispatch=dispatch[:-1])


def _check_moe(p, x, ref_cfg, port_cfg, dtype):
    want, want_aux, r = ref_moe_with_routing(p, x, ref_cfg)
    tp, tx = params_of(p), to_torch(x)
    route = port.moe_route(tp,
                           tx.reshape(-1, ref_cfg.d_model), port_cfg)
    assert route.cap == r["cap"]
    np.testing.assert_array_equal(route.order.numpy(), r["order"])
    np.testing.assert_array_equal(route.counts.numpy(), r["counts"])
    np.testing.assert_array_equal(route.keep.numpy(), r["keep"])
    np.testing.assert_array_equal(route.slot.numpy(), r["slot"])
    np.testing.assert_array_equal(route.dispatch.numpy(), r["dispatch"])
    assert route.dispatch.dtype == route.slot.dtype == torch.int32
    before = lg_ops.LAUNCHES
    got, got_aux = port.moe_ffn(tp, tx, port_cfg)
    assert lg_ops.LAUNCHES == before          # CPU tensors: the plain version
    assert got.dtype == to_torch(want).dtype
    assert_close(got, want, dtype, "moe out")
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               rtol=AUX_RTOL[dtype])
    return r


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_ffn(arch, dtype, capacity_factor):
    """Output, aux loss and the integer routing: at the config's capacity
    factor slots stay empty (dispatch T), at 0.5 experts overflow and
    choices are dropped (slot E·cap)."""
    ref_cfg, port_cfg = smoke(arch, dtype)
    if capacity_factor is not None:
        moe = dataclasses.replace(ref_cfg.moe,
                                  capacity_factor=capacity_factor)
        ref_cfg, port_cfg = smoke(arch, dtype, moe=moe)
    p = _jit_init(ref.init_moe)(jax.random.PRNGKey(21), ref_cfg)
    x = normal(22, (2, 24, ref_cfg.d_model), dtype)
    r = _check_moe(p, x, ref_cfg, port_cfg, dtype)
    if capacity_factor is None:
        assert (r["dispatch"] == 48).any()         # an empty slot
    else:
        assert not r["keep"].all()                 # a dropped choice


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_top_k_tie_takes_the_lower_expert(arch, dtype):
    """Router columns 1 and 3 equal (a tie in every token's logits) and the
    rest zero (a tie among all of them where columns 1 and 3 score below
    zero): ``jax.lax.top_k`` keeps the lower index, and so must the port
    (``torch.topk`` promises no order among equal values)."""
    ref_cfg, port_cfg = smoke(arch, dtype)
    p = _jit_init(ref.init_moe)(jax.random.PRNGKey(23), ref_cfg)
    col = normal(24, (ref_cfg.d_model,))
    router = jnp.zeros_like(p["router"]).at[:, 1].set(col).at[:, 3].set(col)
    p = dict(p, router=router)
    x = normal(25, (2, 16, ref_cfg.d_model), dtype)
    r = _check_moe(p, x, ref_cfg, port_cfg, dtype)
    keys = r["keys"].reshape(32, ref_cfg.moe.top_k)
    assert set(keys[:, 0].tolist()) <= {0, 1}      # tied: the lower first
    assert (keys[:, 0] == 1).any() and (keys[:, 0] == 0).any()


def test_moe_shard_axis_raises_naming_item_11():
    _, port_cfg = smoke("phi3.5-moe-42b", "float32", moe_shard_axis="model")
    p = params_of(_jit_init(ref.init_moe)(jax.random.PRNGKey(0), smoke(
        "phi3.5-moe-42b")[0]))
    with pytest.raises(NotImplementedError, match="item 11"):
        port.moe_ffn(p, torch.zeros((1, 4, port_cfg.d_model)), port_cfg)


@pytest.mark.parametrize("t,want", [(1, 8), (48, 32), (4096, 2568)])
def test_moe_capacity(t, want):
    _, port_cfg = smoke("phi3.5-moe-42b")
    e = dataclasses.replace(port_cfg.moe, capacity_factor=1.25)
    assert port.moe_capacity(e, t) == want
