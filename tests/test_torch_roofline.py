"""The port's roofline and counter (``repro_torch.launch.roofline``,
``launch.count``) against the reference's ``launch/roofline.py`` and
``compiled.cost_analysis()``.

- The roofline terms at the card's published peaks, as the reference's
  test holds its TPU terms.
- ``lm_model_flops``, ``param_count`` and ``active_param_count`` exactly
  the reference's for every LM config, full and SMOKE.
- The counter's FLOPs of each SMOKE ``lm_loss`` forward (B = 2, S = 32)
  exactly equal to the matmul count reckoned here in closed form, and
  within [0.80, 1.00] of the reference's ``cost_analysis()["flops"]`` for
  the jitted ``lm_loss`` (scans unrolled, as the reference's dry run
  compiles it): XLA also counts elementwise FLOPs (the norms, rope, the
  softmax, SwiGLU), which the counter leaves out, so the counter's share
  is below 1.
- A SMOKE train step counts its forward's matmuls three times (the
  forward and the backward's two products) and the recomputed ones once
  more (the loss chunks and, with ``remat``, each layer up to its last
  matmul).
- Each kernel's charge is its declared ``work``, equal on meta and on
  CPU tensors, with none of the plain version's ops counted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import roofline as ref_rl
from repro.models import transformer as ref_tfm
from repro_torch.configs import registry
from repro_torch.core.csr import CSRIndex
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.frontier_expand import ops as fe_ops
from repro_torch.kernels.frontier_pull import ops as fp_ops
from repro_torch.kernels.frontier_pull.layout import PullLayout
from repro_torch.kernels.late_gather import ops as lg_ops
from repro_torch.kernels.spmm_segment import ops as spmm_ops
from repro_torch.launch import roofline as rl
from repro_torch.launch.count import count_call
from repro_torch.launch.steps import build_lm_cell
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import moe_capacity
from test_torch_engine import release_reference_executables  # noqa: F401

LM_ARCHS = [a for a, (f, _) in registry.ARCHS.items() if f == "lm"]
B, S = 2, 32
RATIO_RANGE = (0.80, 1.00)
KERNEL_OPS = (lg_ops, spmm_ops, eb_ops, fe_ops, fp_ops)


def test_roofline_terms_and_dominance():
    r = rl.Roofline(flops=989e12, hbm_bytes=1e9, collective_bytes=1e9,
                    chips=1)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert r.dominant == "compute"
    assert abs(r.fraction_of_roofline() - 1.0) < 1e-9
    r2 = rl.Roofline(flops=1e12, hbm_bytes=3.35e12 * 2.0,
                     collective_bytes=0, chips=1)
    assert r2.dominant == "memory"
    assert abs(r2.memory_s - 2.0) < 1e-9
    assert r2.fraction_of_roofline() < 0.01
    r3 = rl.Roofline(flops=0, hbm_bytes=0, collective_bytes=900e9, chips=1)
    assert r3.dominant == "collective" and abs(r3.collective_s - 1) < 1e-9


def test_compute_term_sums_each_dtype_over_its_peak():
    r = rl.Roofline(flops=989e12 + 67e12, hbm_bytes=0, collective_bytes=0,
                    chips=1, flops_by_dtype={"bfloat16": 989e12,
                                             "float32": 67e12})
    assert abs(r.compute_s - 2.0) < 1e-9
    tf32 = rl.Roofline(flops=495e12, hbm_bytes=0, collective_bytes=0,
                       chips=1, flops_by_dtype={"tf32": 495e12})
    assert abs(tf32.compute_s - 1.0) < 1e-9
    with pytest.raises(ValueError):
        rl.Roofline(flops=1, hbm_bytes=0, collective_bytes=0, chips=1,
                    flops_by_dtype={"int4": 1})


def test_memory_basis_picks_the_byte_count():
    eager = rl.Roofline(flops=0, hbm_bytes=3.35e12, collective_bytes=0,
                        chips=1, compulsory_bytes=3.35e11)
    comp = dataclasses.replace(eager, memory_basis="compulsory")
    assert abs(eager.memory_s - 1.0) < 1e-9
    assert abs(comp.memory_s - 0.1) < 1e-9
    assert comp.row()["memory_basis"] == "compulsory"
    with pytest.raises(ValueError):
        rl.Roofline(flops=0, hbm_bytes=0, collective_bytes=0, chips=1,
                    memory_basis="compulsory")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_flops_equal_the_reference(arch, smoke):
    cfg, _ = registry.get_config(arch, smoke=smoke)
    ref_cfg, _ = ref_registry.get_config(arch, smoke=smoke)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    for train in (True, False):
        assert rl.lm_model_flops(cfg, 256, 4096, train=train) == \
            ref_rl.lm_model_flops(ref_cfg, 256, 4096, train=train)


def closed_form_forward(cfg, b: int, s: int) -> dict:
    """The matmul FLOPs of ``lm_loss``'s forward by dtype: the projections,
    FFN or experts (at their padded capacity) and the chunked loss in the
    config's dtype; the attention's scores and weighted sum over every
    KV chunk (none skipped without ``attn_q_block``) in float32."""
    t, d = b * s, cfg.d_model
    if cfg.mla is not None:
        m, h = cfg.mla, cfg.n_heads
        proj = 2 * t * (d * h * (m.nope_head_dim + m.rope_head_dim)
                        + d * m.kv_lora_rank + d * m.rope_head_dim
                        + m.kv_lora_rank * h * (m.nope_head_dim
                                                + m.v_head_dim)
                        + h * m.v_head_dim * d)
        scores = 2 * b * h * s * s * (m.nope_head_dim + m.rope_head_dim
                                      + m.v_head_dim)
    else:
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        proj = 2 * t * (d * h * hd + 2 * d * kv * hd + h * hd * d)
        scores = 4 * b * h * s * s * hd
    if cfg.moe is not None:
        e = cfg.moe
        ffn = 2 * t * d * e.num_experts \
            + 6 * e.num_experts * moe_capacity(e, t) * d * e.d_expert \
            + 6 * t * d * e.num_shared * e.d_expert
    else:
        ffn = 6 * t * d * cfg.d_ff
    return {cfg.dtype: cfg.n_layers * (proj + ffn) + 2 * t * d * cfg.vocab,
            "float32": cfg.n_layers * scores}


def port_forward_count(cfg, device="meta"):
    params = tfm.init_lm(cfg, None if device == "meta" else
                         torch.Generator().manual_seed(0), device)
    toks = torch.zeros((B, S), dtype=torch.int32, device=device)
    with torch.no_grad():
        return count_call(tfm.lm_loss, params, {"tokens": toks,
                                                "labels": toks}, cfg)[1]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_flops_match_closed_form_and_the_reference(arch):
    cfg, _ = registry.get_config(arch, smoke=True)
    count = port_forward_count(cfg)
    assert count.flops_by_dtype == closed_form_forward(cfg, B, S)

    ref_cfg, _ = ref_registry.get_config(arch, smoke=True)
    ref_cfg = dataclasses.replace(ref_cfg, unroll=True)
    params = jax.eval_shape(lambda k: ref_tfm.init_lm(k, ref_cfg),
                            jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)
    compiled = jax.jit(lambda p, b: ref_tfm.lm_loss(p, b, ref_cfg)[0]) \
        .lower(params, {"tokens": toks, "labels": toks}).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    ratio = count.flops / float(cost["flops"])
    assert RATIO_RANGE[0] <= ratio <= RATIO_RANGE[1], ratio


DENSE_ARCHS = [a for a in LM_ARCHS
               if registry.get_config(a, smoke=True)[0].moe is None]


@pytest.mark.parametrize("arch,remat", [(a, True) for a in DENSE_ARCHS]
                         + [(a, False) for a in LM_ARCHS])
def test_train_step_counts_forward_recompute_and_backward(arch, remat):
    """Every matmul of the step three times (the forward and the
    backward's two products), and the recomputed ones once more: each loss
    chunk (a checkpoint a chunk) and, with ``remat``, each layer but its
    FFN's down projection, which the non-reentrant checkpoint's early stop
    does not rerun (no backward needs its output)."""
    cfg, _ = registry.get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, remat=remat)
    plan = build_lm_cell(cfg, dict(kind="train", seq=S, batch=B), "meta")
    count = count_call(plan.fn, *plan.args)[1]
    t, d = B * S, cfg.d_model
    forward = closed_form_forward(cfg, B, S)
    loss = 2 * t * d * cfg.vocab
    want = {k: 3 * v for k, v in forward.items()}
    want[cfg.dtype] += loss
    if remat:
        for k, v in forward.items():
            want[k] += v - (loss if k == cfg.dtype else 0)
        want[cfg.dtype] -= cfg.n_layers * 2 * t * cfg.d_ff * d
    assert count.flops_by_dtype == want


def test_tf32_counts_float32_products_as_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    a = torch.empty((8, 16), device="meta")
    count = count_call(torch.mm, a, a.T)[1]
    assert count.flops_by_dtype == {"tf32": 2 * 8 * 16 * 8}


def kernel_calls(device):
    """One public call of each kernel on ``device``, seeded: (name, fn,
    args, kwargs)."""
    g = torch.Generator().manual_seed(3)
    v, e, d, r = 40, 120, 5, 50

    def ints(n, hi):
        return torch.randint(0, hi, (n,), generator=g,
                             dtype=torch.int32).to(device)

    src = torch.sort(ints(e, v)).values
    indptr = torch.searchsorted(src, torch.arange(v + 1, dtype=torch.int32),
                                out_int32=True) if device == "cpu" else \
        torch.empty(v + 1, dtype=torch.int32, device=device)
    csr = CSRIndex(indptr.to(device), torch.arange(e, dtype=torch.int32)
                   .to(device))
    x = torch.randn((v, d), generator=g).to(device)
    table = torch.randn((r, d), generator=g).to(device)
    flags = (torch.rand(v, generator=g) < 0.3).to(device)
    return [
        ("late_gather", lg_ops.late_gather_columns,
         ([table, table[:, :2].contiguous()], ints(30, r)), {}),
        ("spmm_segment", spmm_ops.spmm_segment,
         (x, ints(e, v), ints(e, v), None, v), {}),
        ("embedding_bag", eb_ops.embedding_bag,
         (table, ints(e, r), ints(e, 7), 7, torch.rand(e, generator=g)
          .to(device)), {}),
        ("frontier_expand", fe_ops.frontier_expand_fused,
         (csr, ints(9, v), (torch.rand(9, generator=g) < 0.7).to(device),
          64), {}),
        ("frontier_pull", fp_ops.frontier_pull_fused,
         (csr, src, ints(e, v), flags, ~flags), {}),
    ]


def test_kernel_charges_are_their_work_on_meta_and_cpu():
    got = {}
    for device in ("cpu", "meta"):
        for name, fn, args, kwargs in kernel_calls(device):
            before = {n: m.LAUNCHES for n, m in (
                ("late_gather", lg_ops), ("spmm_segment", spmm_ops),
                ("embedding_bag", eb_ops), ("frontier_expand", fe_ops),
                ("frontier_pull", fp_ops))}
            out, count = count_call(fn, *args, **kwargs)
            work = getattr(fn, "__wrapped__", fn)
            w = {"late_gather": lg_ops.work, "spmm_segment": spmm_ops.work,
                 "embedding_bag": eb_ops.work,
                 "frontier_expand": fe_ops.work,
                 "frontier_pull": fp_ops.work}[name](*args, **kwargs)
            assert work is not fn
            assert count.kernels == {name: {"calls": 1, "flops": w.flops,
                                            "bytes": w.bytes}}, name
            # none of the plain version's ops is counted
            assert count.ops == 0, (name, device)
            assert count.hbm_bytes == w.bytes and w.bytes > 0
            assert count.flops_by_dtype == ({"float32": w.flops}
                                            if w.flops else {})
            got[name, device] = (count.kernels, count.hbm_bytes)
            outs = out if isinstance(out, (list, tuple)) else [out]
            assert all(o.device.type == device for o in outs)
            assert before == {n: m.LAUNCHES for n, m in (
                ("late_gather", lg_ops), ("spmm_segment", spmm_ops),
                ("embedding_bag", eb_ops), ("frontier_expand", fe_ops),
                ("frontier_pull", fp_ops))}
    for name, _, _, _ in kernel_calls("meta"):
        assert got[name, "cpu"] == got[name, "meta"], name


def test_meta_outputs_have_the_kernels_shapes_and_dtypes():
    for (name, fn, args, kwargs), (_, _, cargs, ckw) in zip(
            kernel_calls("meta"), kernel_calls("cpu")):
        got, want = fn(*args, **kwargs), fn(*cargs, **ckw)
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        assert [(tuple(t.shape), t.dtype) for t in got] == \
            [(tuple(t.shape), t.dtype) for t in want], name


def swap_tensor(args, i: int, fn):
    """``args`` with its ``i``-th tensor (depth first, into lists, a
    ``CSRIndex`` and a ``PullLayout``) replaced by ``fn(tensor)``, and the
    number of tensors."""
    seen = [0]

    def go(o):
        if isinstance(o, torch.Tensor):
            seen[0] += 1
            return fn(o) if seen[0] - 1 == i else o
        if isinstance(o, tuple) and hasattr(o, "_fields"):
            return type(o)(*(go(v) for v in o))
        if isinstance(o, (list, tuple)):
            return type(o)(go(v) for v in o)
        return o
    return go(args), seen[0]


def test_one_tensor_off_meta_keeps_a_call_off_the_meta_branch():
    """The shape-only branch needs every tensor of the call on ``meta``:
    with any one of them (optional ones, a table of a list, a CSR's and a
    layout's too) on the CPU and the rest on ``meta``, a call raises
    rather than giving a meta output, and launches nothing."""
    calls = [(name, fn, args) for name, fn, args, _ in kernel_calls("meta")]
    rcsr, join_src, join_dst, frontier, visited = calls[-1][2]
    v, e = frontier.shape[0], join_src.shape[0]
    layout = PullLayout(*(torch.empty(n, dtype=torch.int32, device="meta")
                          for n in (v + 1, e, 3, 3)))
    x, src, dst, _, num_out = calls[1][2]
    calls.append(("spmm_segment with weights", spmm_ops.spmm_segment,
                  (x, src, dst, torch.empty(src.shape, device="meta"),
                   num_out)))
    calls.append(("frontier_pull with a layout",
                  lambda *a: fp_ops.frontier_pull_fused(*a[:5],
                                                        layout=a[5]),
                  (rcsr, join_src, join_dst, frontier, visited, layout)))
    launches = [m.LAUNCHES for m in KERNEL_OPS]
    for name, fn, args in calls:
        _, n = swap_tensor(args, -1, None)
        assert n >= 3, name
        for i in range(n):
            swapped, _ = swap_tensor(
                args, i, lambda t: torch.zeros(t.shape, dtype=t.dtype))
            with pytest.raises((ValueError, RuntimeError, TypeError,
                                IndexError)):
                fn(*swapped)
    assert launches == [m.LAUNCHES for m in KERNEL_OPS]


def test_kernel_inside_a_kernel_is_charged_once():
    table = torch.empty((50, 4), device="meta")
    ids = torch.empty((6, 3), dtype=torch.int32, device="meta")
    count = count_call(eb_ops.fixed_hot_lookup, table, ids)[1]
    assert list(count.kernels) == ["late_gather"]
    assert count.kernels["late_gather"]["calls"] == 1


def test_analyze_row_has_the_references_keys():
    cfg, _ = registry.get_config("qwen2-0.5b", smoke=True)
    count = port_forward_count(cfg)
    row = rl.analyze(count, model_flops=1e6)
    for key in ("flops", "hbm_bytes", "collective_bytes", "compute_s",
                "memory_s", "collective_s", "dominant", "roofline_frac",
                "model_flops", "useful_flops_ratio", "memory_analysis",
                "compulsory_bytes", "flops_by_dtype"):
        assert key in row, key
    assert row["collective_bytes"] == 0.0
    assert row["memory_analysis"]["argument_size_in_bytes"] == \
        count.argument_bytes
    with pytest.raises(NotImplementedError):
        rl.analyze(count, chips=4)
