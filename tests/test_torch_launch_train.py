"""The port's LM training driver (``repro_torch.launch.train``) and LM
cells (``repro_torch.launch.steps.build_cell``) against the reference's,
on the CPU.

- ``TrainRun`` resumed from a checkpoint is bit-equal to an uninterrupted
  run (the reference's ``tests/test_system.py`` tests, on the port), and
  ``main`` runs end to end with ``--device cpu``.
- Every SMOKE LM cell (arch x shape, ``long_500k`` included, and a
  ``long_500k`` cell with ``attn_window``) is built by both packages:
  the inputs equal bit for bit (the reference's ``_concretize`` draw, the
  decode cache's length), then each cell's step runs from the reference's
  weights (and AdamW state) in float32, its config's dtype replaced on
  both sides: the train step's loss within 1e-6 relative, its gradients
  (read off the new first moments) and updated parameters within 1e-4 of
  each leaf's largest; prefill and decode logits within ``LOGIT_TOL`` =
  1e-5 of the largest logit, the caches within the same of their
  largest.  The cells in their configs' own bfloat16 are built and run
  once each, their outputs finite.
- ``cells(include_bfs=, smoke=)`` equals the reference's, skips and
  reasons included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as ref_registry
from repro.launch import steps as ref_steps
from repro_torch.configs import registry as port_registry
from repro_torch.convert import lm_params_from_numpy, tree_from_numpy
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.launch import steps as port_steps
from repro_torch.launch import train as port_train
from repro_torch.optim.tree import leaves
from repro_torch.checkpoint import CheckpointManager
from test_torch_engine import release_reference_executables  # noqa: F401
from test_torch_lm_layers import LM_ARCHS, one_torch_thread  # noqa: F401
from test_torch_lm_train import (GRAD_TOL, LOSS_RTOL, check_leaves,
                                 f32_leaves, grads_from_moments, leaf_names)

LOGIT_TOL = 1e-5
LM_CELLS = [(a, s) for a in LM_ARCHS for s in port_registry.SMOKE_LM_SHAPES]
WINDOW = 8              # the documented long_500k extra's sliding window


def test_train_resume_is_bitexact(tmp_path):
    """Run A: 8 steps straight.  Run B: 4 steps, checkpoint, 'crash',
    restore, 4 more.  Same data stream (seed, step) -> identical params
    and optimizer state."""
    kw = dict(batch=2, seq=32, seed=5, ckpt_every=4)
    run_a = port_train.build_run("qwen2-0.5b", smoke=True, device="cpu")
    run_a.run(steps=8, ckpt=None, **kw)

    ckpt_dir = str(tmp_path / "ck")
    mgr = CheckpointManager(ckpt_dir)
    run_b = port_train.build_run("qwen2-0.5b", smoke=True, device="cpu")
    run_b.run(steps=4, ckpt=mgr, **kw)
    del run_b                                        # "crash"

    run_c = port_train.build_run("qwen2-0.5b", smoke=True,
                                 resume_dir=ckpt_dir, device="cpu")
    assert run_c.step == 4
    run_c.run(steps=8, ckpt=None, **kw)
    for a, c in zip(leaves([run_a.params, run_a.opt_state]),
                    leaves([run_c.params, run_c.opt_state])):
        assert a.dtype == c.dtype and torch.equal(a, c)


def test_training_monitor_integration():
    run = port_train.build_run("stablelm-1.6b", smoke=True, device="cpu")
    hist = run.run(steps=6, batch=2, seq=16, seed=1, ckpt=None,
                   monitor=StragglerMonitor())
    assert len(hist) == 6
    assert all(np.isfinite(m["loss"]) for m in hist)
    assert set(hist[0]) == {"loss", "grad_norm", "xent", "aux"}


def test_main_runs_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "3", "--device",
            "cpu", "--batch", "2", "--seq", "16", "--ckpt-dir", ck,
            "--ckpt-every", "2"]
    hist = port_train.main(args)
    out = capsys.readouterr().out
    assert len(hist) == 3 and "final loss" in out
    assert CheckpointManager(ck).latest_step() == 3
    again = port_train.main(args[:4] + ["5"] + args[5:] + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and len(again) == 2


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.build_run("qwen2-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_steps.build_cell("qwen2-0.5b", "train_4k", smoke=True)


def test_build_run_drives_lm_archs_only():
    with pytest.raises(SystemExit, match="LM archs"):
        port_train.build_run("gatedgcn", smoke=True, device="cpu")


@pytest.mark.parametrize("include_bfs", [False, True])
@pytest.mark.parametrize("smoke", [False, True])
def test_cells_match_reference(include_bfs, smoke):
    got = [dataclasses.asdict(c) for c in port_registry.cells(
        include_bfs=include_bfs, smoke=smoke)]
    want = [dataclasses.asdict(c) for c in ref_registry.cells(
        include_bfs=include_bfs, smoke=smoke)]
    assert got == want
    skipped = {(c["arch"], c["shape"]) for c in got if c["skip"]}
    assert skipped == (set() if smoke else
                       {(a, "long_500k") for a in LM_ARCHS})


def test_posdb_bfs_has_no_cell():
    assert dataclasses.asdict(port_registry.get_config("posdb-bfs")[0]) == \
        dataclasses.asdict(ref_registry.get_config("posdb-bfs")[0])
    assert port_registry.shapes_for("bfs") == ref_registry.shapes_for("bfs")
    with pytest.raises(ValueError):
        ref_steps.build_cell("posdb-bfs", "traverse_1m", concrete=True)
    with pytest.raises(ValueError, match="posdb-bfs"):
        port_steps.build_cell("posdb-bfs", "traverse_1m", device="cpu")


@pytest.fixture
def float32_cells(monkeypatch):
    """Both packages' ``build_cell`` read their configs in float32."""
    for mod, registry in ((ref_steps, ref_registry),
                          (port_steps, port_registry)):
        def get(arch, smoke=False, registry=registry):
            cfg, family = registry.get_config(arch, smoke=smoke)
            if family == "lm":
                cfg = dataclasses.replace(cfg, dtype="float32")
            return cfg, family
        monkeypatch.setattr(mod, "get_config", get)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _check_close(got, want, what):
    got = got.detach().to(torch.float64).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_TOL * scale, (what, err, scale)


@pytest.mark.parametrize("arch,shape,window", [
    *((a, s, None) for a, s in LM_CELLS),
    ("qwen2-0.5b", "long_500k", WINDOW),
    ("deepseek-v2-lite-16b", "long_500k", WINDOW)])
def test_lm_cell_matches_reference(arch, shape, window, float32_cells):
    plan = ref_steps.build_cell(arch, shape, smoke=True, concrete=True,
                                attn_window=window)
    port_plan = port_steps.build_cell(arch, shape, smoke=True,
                                      device="cpu", attn_window=window)
    kind = port_registry.SMOKE_LM_SHAPES[shape]["kind"]
    params = lm_params_from_numpy(_host(plan.args[0]), "cpu")
    names = leaf_names(params)
    assert [tuple(t.shape) for t in leaves(port_plan.args[0])] == \
        [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(plan.args[0])]
    want_out = jax.jit(plan.fn)(*plan.args)
    if kind == "train":
        batch = port_plan.args[2]
        want_batch = _host(plan.args[2])
        assert list(batch) == sorted(want_batch) == ["labels", "tokens"]
        for k in want_batch:
            assert batch[k].dtype == torch.int32
            np.testing.assert_array_equal(batch[k].numpy(), want_batch[k])
        state = tree_from_numpy(_host(plan.args[1]), "cpu")
        got_p, got_state, got_m = port_plan.fn(params, state, batch)
        want_p, want_state, want_m = want_out
        np.testing.assert_allclose(float(got_m["loss"]),
                                   float(want_m["loss"]),
                                   rtol=LOSS_RTOL["float32"])
        mu_old = jax.tree_util.tree_leaves(_host(plan.args[1])["mu"])
        b1 = port_steps.make_optimizer().b1
        check_leaves(
            grads_from_moments([t.numpy() for t in leaves(got_state["mu"])],
                               mu_old, float(got_m["grad_norm"]), b1),
            grads_from_moments(jax.tree_util.tree_leaves(want_state["mu"]),
                               mu_old, float(want_m["grad_norm"]), b1),
            names, GRAD_TOL, f"{arch} {shape} gradient")
        check_leaves([t.numpy() for t in leaves(got_p)],
                     f32_leaves(want_p), names, GRAD_TOL,
                     f"{arch} {shape} parameter")
        return
    tokens = port_plan.args[1]
    assert tokens.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(plan.args[1]))
    if kind == "prefill":
        logits, cache = port_plan.fn(params, tokens)
    else:
        cache_in = port_plan.args[2]
        want_in = plan.args[2]
        assert cache_in.length == int(want_in.length) == \
            port_registry.SMOKE_LM_SHAPES[shape]["seq"] - 1
        for got_t, want_t in ((cache_in.a, want_in.a),
                              (cache_in.b, want_in.b)):
            assert tuple(got_t.shape) == want_t.shape
            assert not bool(got_t.any()) and not bool(jnp.any(want_t))
        logits, cache = port_plan.fn(params, tokens, cache_in)
    want_logits, want_cache = want_out
    _check_close(logits, want_logits, f"{arch} {shape} logits")
    assert cache.length == int(want_cache.length)
    _check_close(cache.a, want_cache.a, f"{arch} {shape} cache a")
    _check_close(cache.b, want_cache.b, f"{arch} {shape} cache b")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_cells_run_in_their_own_dtype(arch):
    """Each cell as built (the config's bfloat16 compute, float32
    weights): the step runs and its outputs are finite."""
    for shape, dims in port_registry.SMOKE_LM_SHAPES.items():
        plan = port_steps.build_cell(arch, shape, smoke=True, device="cpu")
        out = plan.fn(*plan.args)
        if dims["kind"] == "train":
            assert all(np.isfinite(float(v)) for v in out[2].values())
            assert out[0]["embed"].dtype == torch.float32
        else:
            assert out[0].dtype == torch.float32
            assert tuple(out[0].shape) == (dims["batch"],
                                           port_registry.get_config(
                                               arch, smoke=True)[0].vocab)
            assert bool(torch.isfinite(out[0]).all())
