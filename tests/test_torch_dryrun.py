"""The port's dry run (``repro_torch.launch.{steps,dryrun,probe,
hillclimb}``) against the reference's ``concrete=False`` cells.

- **Arguments.**  For every published cell at full size, the port's meta
  cell (``build_cell(..., device="meta")``) takes the reference's
  ``build_cell(arch, shape, None, concrete=False)`` ShapeDtypeStructs
  leaf by leaf, in shape and dtype (dict entries in sorted key order, as
  JAX flattens them; the decode cache's ``length``, a Python int in the
  port, stands for the reference's () int32), and the skip reasons are
  the reference's.
- **Meta against the CPU.**  Every SMOKE LM cell counts the same on meta
  and on CPU tensors: FLOPs by dtype, eager bytes and compulsory bytes,
  exactly.
- **``dryrun.main``** (``--all --smoke``, a family a test) writes a row
  or a named skip for every cell; the ``posdb-bfs`` row names ROADMAP
  item 11.
- **``probe.lm_exact_costs``** at SMOKE: the affine fit's extrapolation
  equals the direct count, FLOPs exactly and bytes within
  ``PROBE_BYTES_RTOL`` (a prefill's bytes fit exactly; a train step's
  backward traffic is not quite affine in the trip counts, and the fit
  missed 0.19% of it at SMOKE when this test was written).
- **``hillclimb.measure``** at SMOKE: the reference's documented
  override lowers the counted attention FLOPs, the lazy DeepFM step
  counts, and the sharded one raises.
"""
import json

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs import registry as ref_registry
from repro.launch import steps as ref_steps
from repro_torch.configs import registry
from repro_torch.launch import dryrun, hillclimb, probe
from repro_torch.launch.count import count_call
from repro_torch.launch.steps import build_cell
from test_torch_engine import release_reference_executables  # noqa: F401

PROBE_BYTES_RTOL = 1e-2
LM_ARCHS = [a for a, (f, _) in registry.ARCHS.items() if f == "lm"]
PUBLISHED = [(c.arch, c.shape) for c in registry.cells()]


def ref_leaves(tree, prefix=""):
    """(path, shape, dtype) of each leaf, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in ref_leaves(tree[k],
                                                            f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in ref_leaves(t, f"{prefix}/{i}")]
    return [(prefix, tuple(tree.shape), str(np.dtype(tree.dtype)))]


def port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in port_leaves(tree[k],
                                                             f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in port_leaves(t, f"{prefix}/{i}")]
    if isinstance(tree, int):                 # KVCache.length
        return [(prefix, (), "int32")]
    assert tree.device.type == "meta", prefix
    return [(prefix, tuple(tree.shape),
             str(tree.dtype).removeprefix("torch."))]


@pytest.mark.parametrize("arch,shape", PUBLISHED)
def test_meta_cell_arguments_are_the_references(arch, shape):
    ref = {(c.arch, c.shape): c.skip for c in ref_registry.cells()}
    port = {(c.arch, c.shape): c.skip for c in registry.cells()}
    assert port[arch, shape] == ref[arch, shape]
    if port[arch, shape]:
        return
    want = ref_leaves(ref_steps.build_cell(arch, shape, None,
                                           concrete=False).args)
    got = port_leaves(build_cell(arch, shape, device="meta").args)
    assert got == want


def counted(plan):
    c = count_call(plan.fn, *plan.args)[1]
    return c.flops_by_dtype, c.hbm_bytes, c.compulsory_bytes


@pytest.mark.parametrize("arch,shape", [(c.arch, c.shape)
                                        for c in registry.cells(smoke=True)
                                        if c.family == "lm"])
def test_smoke_lm_cell_counts_the_same_on_meta_and_cpu(arch, shape):
    meta = counted(build_cell(arch, shape, smoke=True, device="meta"))
    cpu = counted(build_cell(arch, shape, smoke=True, device="cpu"))
    assert meta == cpu
    assert meta[0] and meta[1] > meta[2] > 0


@pytest.mark.parametrize("arch,shape", [
    ("gatedgcn", "minibatch_lg"), ("graphsage-reddit", "ogb_products"),
    ("egnn", "molecule"), ("deepfm", "train_batch")])
def test_smoke_gnn_and_recsys_cells_count_the_same(arch, shape):
    assert counted(build_cell(arch, shape, smoke=True, device="meta")) == \
        counted(build_cell(arch, shape, smoke=True, device="cpu"))


@pytest.mark.parametrize("family", ["lm", "gnn", "recsys", "bfs"])
def test_dryrun_main_writes_a_row_for_every_cell(tmp_path, family):
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--all", "--smoke", "--family", family, "--out",
                        str(out)]) == 0
    rows = json.loads(out.read_text())
    want = [(c.arch, c.shape) for c in registry.cells(include_bfs=True,
                                                      smoke=True)
            if c.family == family]
    assert [(r["arch"], r["shape"]) for r in rows] == want
    for r in rows:
        if r["arch"] == "posdb-bfs":
            assert "ROADMAP item 11" in r["skipped"]
            continue
        assert r["mesh"] == "one_h100" and r["counted_on"] == "meta"
        assert r["flops"] >= 0 and r["hbm_bytes"] > 0
        assert r["compulsory_bytes"] > 0 and r["count_s"] >= 0
        assert r["dominant"] in ("compute", "memory")
        if family == "lm":
            assert r["useful_flops_ratio"] > 0
            assert set(r["probe"]) >= {"probe_flops", "probe_counts"}


def test_dryrun_names_what_waits_for_item_11():
    with pytest.raises(NotImplementedError, match="item 11"):
        dryrun.main(["--all", "--mesh", "multi"])
    with pytest.raises(NotImplementedError, match="item 11"):
        dryrun.run_cell("posdb-bfs", "traverse_1m")


def test_dryrun_keeps_the_long_500k_skip(tmp_path):
    out = tmp_path / "long.json"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert json.loads(out.read_text()) == [
        {"arch": "qwen2-0.5b", "shape": "long_500k",
         "skipped": registry.LONG_500K_SKIP}]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_probe_extrapolation_equals_the_direct_count(arch, shape):
    costs = probe.lm_exact_costs(arch, shape, smoke=True)
    fit = costs["probe_extrapolated"]
    assert fit["flops"] == costs["flops"]
    np.testing.assert_allclose(fit["hbm_bytes"], costs["hbm_bytes"],
                               rtol=PROBE_BYTES_RTOL)
    assert costs["collective_bytes"] == 0.0
    # eager chunks split the same products: no FLOPs a chunk
    assert costs["probe_flops"]["per_chunk"] == 0
    assert costs["probe_flops"]["per_loss_chunk"] == 0
    assert costs["probe_flops"]["per_layer"] > 0
    cfg, _ = registry.get_config(arch, smoke=True)
    assert costs["probe_counts"]["L"] == cfg.n_layers


def test_hillclimb_measures_smoke_cells(capsys):
    base = hillclimb.measure("qwen2-0.5b", "prefill_32k", {}, smoke=True,
                             label="baseline")
    variant = hillclimb.measure("qwen2-0.5b", "prefill_32k",
                                {"attn_q_block": 8, "attn_chunk": 16},
                                smoke=True)
    assert variant["flops_by_dtype"]["float32"] < \
        base["flops_by_dtype"]["float32"]
    assert variant["flops_by_dtype"]["bfloat16"] == \
        base["flops_by_dtype"]["bfloat16"]
    lazy = hillclimb.measure("deepfm", "train_batch", {}, "plain",
                             smoke=True)
    dense = hillclimb.measure("deepfm", "train_batch", {}, smoke=True)
    assert lazy["flops"] == dense["flops"]
    assert lazy["hbm_bytes"] < dense["hbm_bytes"]
    with pytest.raises(NotImplementedError, match="item 11"):
        hillclimb.measure("deepfm", "train_batch", {}, "shardmap",
                          smoke=True)
    assert "[baseline]" in capsys.readouterr().out


def test_hillclimb_main_appends_to_its_out(tmp_path):
    out = tmp_path / "hc.json"
    for extra in ([], ["--set", "attn_chunk=8", "--probe"]):
        hillclimb.main(["--cell", "qwen2-prefill", "--smoke", "--out",
                        str(out)] + extra)
    rows = json.loads(out.read_text())
    assert [r["label"] for r in rows] == ["baseline", "attn_chunk=8"]
    assert rows[1]["method"] == "probe"
    assert rows[1]["overrides"] == {"attn_chunk": "8"}
    assert hillclimb._coerce("None") is None
    assert hillclimb._coerce("3") == 3 and hillclimb._coerce("x") == "x"


def test_meta_cells_make_no_host_data(monkeypatch):
    """A meta cell never generates a graph or a batch."""
    from repro_torch.launch import steps

    def boom(*a, **k):
        raise AssertionError("host data made for a meta cell")
    for name in ("make_graph", "make_molecule_batch", "recsys_batch"):
        monkeypatch.setattr(steps, name, boom)
    for arch, shape in (("graphsage-reddit", "ogb_products"),
                        ("gatedgcn", "minibatch_lg"),
                        ("egnn", "molecule"), ("deepfm", "serve_bulk")):
        plan = build_cell(arch, shape, device="meta")
        leaves = [t for t in tree_leaves(plan.args)
                  if isinstance(t, torch.Tensor)]
        assert leaves and all(t.device.type == "meta" for t in leaves)


def test_lazy_deepfm_state_owns_exactly_its_rows(tmp_path):
    """The lazy DeepFM step (whose sentinel writes keep every shape off
    the data, so that it runs on ``meta``) returns a table, first-order
    weights and moments that own exactly their rows: a save holds nothing
    past them (the same bytes as a save of their copies), a restore gives
    the same bits, and the meta step gives the same shapes."""
    import io
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.recsys import make_deepfm_train_step_lazy
    cfg, _ = registry.get_config("deepfm", smoke=True)
    step = make_deepfm_train_step_lazy(cfg, make_optimizer())
    out = {}
    for device in ("cpu", "meta"):
        params, state, batch = build_cell("deepfm", "train_batch",
                                          smoke=True, device=device).args
        for _ in range(2):
            params, state, _ = step(params, state, batch)
        out[device] = {"params": params, "mu": state["mu"],
                       "nu": state["nu"]}
    cpu = out["cpu"]
    for t in tree_leaves(cpu):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()

    def saved(tree) -> bytes:
        buf = io.BytesIO()
        torch.save(tree, buf)
        return buf.getvalue()
    copies = {k: {n: t.clone() for n, t in v.items() if n != "mlp"}
              for k, v in cpu.items()}
    assert saved({k: {n: t for n, t in v.items() if n != "mlp"}
                  for k, v in cpu.items()}) == saved(copies)
    torch.save(cpu, tmp_path / "state.pt")
    back = torch.load(tmp_path / "state.pt")
    for a, b in zip(tree_leaves(cpu), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [(tuple(t.shape), t.dtype) for t in tree_leaves(out["meta"])] == \
        [(tuple(t.shape), t.dtype) for t in tree_leaves(cpu)]
