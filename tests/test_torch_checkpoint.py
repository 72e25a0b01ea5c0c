"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), on the CPU.

The reference's own tests (``tests/test_checkpoint.py``) run on the
port's trees of tensors, and the two packages read each other's files:
a checkpoint saved by either restores in the other leaf for leaf, values
and dtypes exact (the file is the same ``.npz`` of path-keyed arrays).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as ref
from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import tree_to_numpy
from repro_torch.optim import AdamW, constant
from repro_torch.optim.tree import leaves, tree_map
from test_torch_engine import release_reference_executables  # noqa: F401


def _tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "layers": [torch.ones(2), torch.zeros(3)]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _ref_tree():
    return {"params": {"w": jnp.arange(6.0).reshape(2, 3),
                       "layers": [jnp.ones((2,)), jnp.zeros((3,))]},
            "step": jnp.asarray(7, jnp.int32)}


def test_roundtrip(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 7, t)
    r = restore_checkpoint(path, tree_map(torch.zeros_like, t))
    for a, b in zip(leaves(t), leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_atomicity_no_tmp_left(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    assert os.listdir(tmp_path) == ["ckpt_00000001.npz"]


def test_manager_rotation_and_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, {"x": torch.tensor(float(s))})
    assert m.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.npz",
                                            "ckpt_00000004.npz"]
    step, tree = m.restore_latest({"x": torch.tensor(0.0)})
    assert step == 4 and float(tree["x"]) == 4.0


def test_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path), async_save=True)
    x = torch.arange(1000.0)
    m.save(5, {"x": x})
    x.zero_()          # the host copy was taken before the thread started
    m.wait()
    step, tree = m.restore_latest({"x": torch.zeros(1000)})
    assert step == 5
    np.testing.assert_array_equal(tree["x"].numpy(), np.arange(1000.0))


def test_restore_missing_key_raises(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, {"a": torch.tensor(1.0)})
    with pytest.raises(KeyError):
        restore_checkpoint(path, {"b": torch.tensor(0.0)})


def test_empty_dir_restore(tmp_path):
    m = CheckpointManager(str(tmp_path))
    assert m.restore_latest({"x": torch.tensor(0.0)}) == (None, None)


def test_restore_onto_a_device_and_dtype(tmp_path):
    """``device=`` puts every leaf there; each leaf takes ``like``'s
    dtype."""
    path = save_checkpoint(str(tmp_path), 3, _tree())
    like = _tree()
    like["params"]["w"] = like["params"]["w"].to(torch.float64)
    r = restore_checkpoint(path, like, device="cpu")
    assert r["params"]["w"].dtype == torch.float64
    assert all(t.device.type == "cpu" for t in leaves(r))
    np.testing.assert_array_equal(r["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))


def _train_state():
    """An AdamW state after one update: nested dicts, a list, an int32
    step, float32 moments."""
    g = torch.Generator().manual_seed(0)
    params = {"embed": {"w": torch.randn(4, 3, generator=g),
                        "b": torch.randn(3, generator=g)},
              "layers": [{"w": torch.randn(3, 3, generator=g)},
                         {"w": torch.randn(3, 2, generator=g)}]}
    opt = AdamW(lr=constant(0.1))
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g), params)
    params, state, _ = opt.update(params, grads, opt.init(params))
    return {"params": params, "opt_state": state}


def test_reference_restores_the_ports_checkpoint(tmp_path):
    t = _train_state()
    path = save_checkpoint(str(tmp_path), 2, t)
    want = tree_to_numpy(t)
    like = jax.tree_util.tree_map(jnp.zeros_like, want)
    got = ref.restore_checkpoint(path, like)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        b = np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_restores_the_references_checkpoint(tmp_path):
    t = jax.tree_util.tree_map(jnp.asarray, tree_to_numpy(_train_state()))
    t["extra"] = _ref_tree()
    path = ref.save_checkpoint(str(tmp_path), 9, t)
    like = tree_map(lambda a: torch.zeros(a.shape, dtype=getattr(
        torch, str(a.dtype))), jax.tree_util.tree_map(np.asarray, t))
    got = restore_checkpoint(path, like)
    for a, b in zip(jax.tree_util.tree_leaves(t), leaves(got)):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)
    # and the reference's manager finds the port's files
    m = CheckpointManager(str(tmp_path))
    m.save(10, tree_map(torch.as_tensor, got))
    assert ref.CheckpointManager(str(tmp_path)).latest_step() == 10
