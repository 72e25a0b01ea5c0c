"""The port's DeepFM serving path (``repro_torch.models.recsys``) against
the JAX reference, on the CPU.

Integers are exact: ``recsys_batch``, the configs, ``field_offsets``,
``total_rows`` and ``featurize``'s positions on the seeded smoke batches.
The reference's ``init_deepfm`` parameters cross by
``convert.deepfm_params_from_numpy``; ``deepfm_forward``, ``serve_scores``
and ``retrieval_scores`` are then held against the reference with
``use_pallas=False`` and ``True`` (interpret mode) within ``rtol = atol =
2e-5``, tests/test_models_gnn_recsys.py's tolerance between the two
reference paths: sums over fields and the MLP's dot products run in
another order.

``featurize`` buckets a numeric feature at ``int(1000 * sigmoid(x))``.
``torch.sigmoid`` and ``jax.nn.sigmoid`` differ in the last bit on some
inputs, so where ``1000 * sigmoid(x)`` lies within a rounding of an
integer the two packages pick neighbouring buckets.  The full-batch test
counts these flips at the serving batch size and holds each to a bucket
boundary; it does not hide them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import deepfm as ref_deepfm
from repro.data import recsys_stream as ref_stream
from repro.models import recsys as ref
from repro_torch.configs import deepfm as port_deepfm
from repro_torch.convert import deepfm_params_from_numpy
from repro_torch.data import recsys_stream as port_stream
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.late_gather import ops as lg_ops
from repro_torch.models import recsys as port
from test_torch_engine import release_reference_executables  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
SMOKE_VOCABS = ref_stream.vocab_sizes(1e-4)
# SMOKE-like widths (tests/test_models_gnn_recsys.py's configuration)
WIDTHS = dict(vocab_scale=1e-4, embed_dim=8, mlp_dims=(16, 16))


def configs(table_dtype="float32"):
    return (ref.RecsysConfig(name="t", table_dtype=table_dtype, **WIDTHS),
            port_deepfm.RecsysConfig(name="t", table_dtype=table_dtype,
                                     **WIDTHS))


def ref_params(cfg):
    return ref.init_deepfm(jax.random.PRNGKey(0), cfg)


def to_port(params):
    return deepfm_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           params), "cpu")


def as_float32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("seed,step,batch,scale",
                         [(0, 0, 32, 1e-4), (0, 3, 64, 1e-4),
                          (1, 0, 512, 1.0), (2, 5, 100, 0.5)])
def test_recsys_batch_matches_reference(seed, step, batch, scale):
    vocabs = ref_stream.vocab_sizes(scale)
    assert port_stream.vocab_sizes(scale) == vocabs
    want = ref_stream.recsys_batch(seed, step, batch, vocabs=vocabs)
    got = port_stream.recsys_batch(seed, step, batch, vocabs=vocabs)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_configs_offsets_and_rows_match_reference():
    assert port_stream.CRITEO_VOCABS == ref_stream.CRITEO_VOCABS
    for name in ("CONFIG", "SMOKE"):
        want = getattr(ref_deepfm, name)
        got = getattr(port_deepfm, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert port.field_vocabs(got) == ref.field_vocabs(want)
        offsets = port.field_offsets(got)
        assert offsets.dtype == np.int32
        np.testing.assert_array_equal(offsets, ref.field_offsets(want))
        assert port.total_rows(got) == ref.total_rows(want)
    assert port.total_rows(port_deepfm.CONFIG) == 32_722_432


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_init_deepfm_shapes_and_scales(table_dtype):
    rcfg, cfg = configs(table_dtype)
    want = ref_params(rcfg)
    got = port.init_deepfm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert got["table"].dtype == getattr(torch, table_dtype)
    for k in ("table", "first_order", "bias"):
        assert tuple(got[k].shape) == want[k].shape
    assert len(got["mlp"]) == len(want["mlp"])
    for g, w in zip(got["mlp"], want["mlp"]):
        assert tuple(g["w"].shape) == w["w"].shape
        assert g["w"].dtype == torch.float32 and not g["b"].any()
        # He-normal: std sqrt(2 / fan_in), within 10% on >= 256 draws
        fan_in = w["w"].shape[0]
        assert abs(float(g["w"].std()) / (2.0 / fan_in) ** 0.5 - 1) < 0.1
    assert abs(float(got["table"].float().std()) / 0.01 - 1) < 0.02
    same = port.init_deepfm(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(same["table"], got["table"])


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_params_cross_keeping_dtypes(table_dtype):
    rcfg, _ = configs(table_dtype)
    want = ref_params(rcfg)
    got = to_port(want)
    assert got["table"].dtype == getattr(torch, table_dtype)
    for k in ("table", "first_order", "bias"):
        np.testing.assert_array_equal(as_float32(got[k]), as_float32(want[k]))
    for g, w in zip(got["mlp"], want["mlp"]):
        for k in ("w", "b"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("seed,step,batch", [(0, 0, 8), (0, 0, 32),
                                             (0, 0, 64), (0, 1, 64)])
def test_featurize_positions_match_reference_exactly(seed, step, batch):
    rcfg, cfg = configs()
    b = ref_stream.recsys_batch(seed, step, batch, vocabs=SMOKE_VOCABS)
    off = ref.field_offsets(rcfg)
    want = np.asarray(ref.featurize(rcfg, jnp.asarray(b["dense"]),
                                    jnp.asarray(b["sparse"]),
                                    jnp.asarray(off)))
    got = port.featurize(cfg, torch.from_numpy(b["dense"]),
                         torch.from_numpy(b["sparse"]), torch.from_numpy(off))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def serve_inputs(batch, rcfg):
    b = ref_stream.recsys_batch(0, 0, batch, vocabs=SMOKE_VOCABS)
    off = ref.field_offsets(rcfg)
    return ([jnp.asarray(a) for a in (b["dense"], b["sparse"], off)],
            [torch.from_numpy(a) for a in (b["dense"], b["sparse"], off)],
            b["label"])


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas,batch", [(False, 32), (True, 8)])
def test_deepfm_forward_and_serve_match_reference(table_dtype, use_pallas,
                                                  batch):
    rcfg, cfg = configs(table_dtype)
    params = ref_params(rcfg)
    jargs, targs, label = serve_inputs(batch, rcfg)
    tp = to_port(params)
    before = (lg_ops.LAUNCHES, eb_ops.LAUNCHES)
    logits = port.deepfm_forward(tp, cfg, *targs)
    scores = port.serve_scores(tp, cfg, *targs)
    assert (lg_ops.LAUNCHES, eb_ops.LAUNCHES) == before   # CPU: no kernel
    assert logits.shape == (batch,) and logits.dtype == torch.float32
    want = np.asarray(ref.deepfm_forward(params, rcfg, *jargs,
                                         use_pallas=use_pallas))
    np.testing.assert_allclose(logits.numpy(), want, **TOL)
    np.testing.assert_allclose(
        scores.numpy(), np.asarray(ref.serve_scores(params, rcfg, *jargs,
                                                    use_pallas=use_pallas)),
        **TOL)
    np.testing.assert_allclose(
        float(port.bce_loss(logits, torch.from_numpy(label))),
        float(ref.bce_loss(jnp.asarray(want), jnp.asarray(label))), **TOL)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_retrieval_scores_match_reference(table_dtype):
    """One context against 1,000 candidate positions spread over the
    table, in the table's dtype as the reference computes them."""
    rcfg, cfg = configs(table_dtype)
    params = ref_params(rcfg)
    jargs, targs, _ = serve_inputs(1, rcfg)
    cand = np.random.default_rng(5).integers(
        0, ref.total_rows(rcfg), 1000).astype(np.int32)
    want = ref.retrieval_scores(params, rcfg, *jargs, jnp.asarray(cand))
    got = port.retrieval_scores(to_port(params), cfg, *targs,
                                torch.from_numpy(cand))
    assert got.shape == (1000,)
    assert got.dtype == getattr(torch, table_dtype)
    np.testing.assert_allclose(as_float32(got), as_float32(want), **TOL)


def test_bucket_flips_at_serving_batch_lie_on_boundaries():
    """``featurize`` on ``recsys_batch(1, 0, 262144)`` (the serve_bulk
    batch size, full Criteo vocabularies): every position equals the
    reference's except at bucket flips, where the reference's bucket and
    the port's differ by one and ``1000 * sigmoid(x)`` (in float64) lies
    within 1e-3 of an integer.  The flip count is printed."""
    cfg = port_deepfm.CONFIG
    b = port_stream.recsys_batch(1, 0, 262144)
    off = port.field_offsets(cfg)
    want = np.asarray(ref.featurize(ref_deepfm.CONFIG,
                                    jnp.asarray(b["dense"]),
                                    jnp.asarray(b["sparse"]),
                                    jnp.asarray(off)))
    got = port.featurize(cfg, torch.from_numpy(b["dense"]),
                         torch.from_numpy(b["sparse"]),
                         torch.from_numpy(off)).numpy()
    n_dense = cfg.n_dense
    np.testing.assert_array_equal(got[:, n_dense:], want[:, n_dense:])
    flips = np.nonzero(got[:, :n_dense] != want[:, :n_dense])
    print(f"bucket flips: {flips[0].size} of {got[:, :n_dense].size}")
    assert np.all(np.abs(got[flips] - want[flips]) == 1)
    x = b["dense"][flips].astype(np.float64)
    scaled = 1000.0 / (1.0 + np.exp(-x))
    assert np.all(np.abs(scaled - np.round(scaled)) < 1e-3)
