"""The port's examples (``repro_torch.examples``) on the CPU at small
sizes, against the reference's code at the same sizes.

- Every example's inner function runs on CPU tensors and launches no
  kernel.
- ``quickstart``: each engine's rows and levels, and the planner's ranked
  labels, equal the reference's ``run_query`` and ``plan`` on the same
  ``TreeSpec``.
- ``bfs_traversal``: every section ``run`` runs (the planner's ranking,
  pick, rows, depth column and pushed-down filter; the depth sweep; the
  batch; the three directions; the plan's text) equals the reference's at
  the same spec.  Largest depths are read over the live rows.  Its
  distributed section (``run_distributed``, 8 spawned gloo ranks) gives
  the per-shard counts and rows of the reference's section at a cut spec
  (8 fake host devices, in a subprocess).
- ``recsys_serve``, ``gnn_reddit`` and ``train_lm`` give finite losses,
  and their first step's loss, at the reference's weights and data
  (``gnn_reddit`` on the reference's seeds and sampler draws), is within
  the tolerances of ``tests/test_torch_train_cells.py`` (DeepFM and the
  GNN step: ``rtol = atol = 2e-5``, the reference's DeepFM tolerance)
  and ``tests/test_torch_lm_train.py`` (a bfloat16 LM loss: 1e-2
  relative).
"""
import json
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as RefGNNConfig
from repro.configs.base import LMConfig as RefLMConfig
from repro.configs.base import RecsysConfig as RefRecsysConfig
from repro.core import EngineCaps as RefCaps
from repro.core.csr import build_csr as ref_build_csr
from repro.core.engine import Dataset as RefDataset
from repro.core.engine import RecursiveQuery as RefQuery
from repro.core.engine import plan_and_run as ref_plan_and_run
from repro.core.engine import plan_repr as ref_plan_repr
from repro.core.engine import run_query as ref_run_query
from repro.core.engine import run_query_batch as ref_run_query_batch
from repro.data import graphgen as ref_graphgen
from repro.data.recsys_stream import recsys_batch as ref_recsys_batch
from repro.data.recsys_stream import vocab_sizes as ref_vocab_sizes
from repro.data.sampler import gather_block_features as ref_gather
from repro.data.sampler import sample_block as ref_sample_block
from repro.data.tokens import lm_batch as ref_lm_batch
from repro.data.treegen import TreeSpec as RefTreeSpec
from repro.data.treegen import make_edge_table as ref_make_edge_table
from repro.launch.steps import make_optimizer as ref_make_optimizer
from repro.models import gnn as ref_gnn
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tfm
from repro.optim import AdamW as RefAdamW
from repro.optim import linear_warmup_cosine as ref_schedule
from repro.planner import paper_listing as ref_paper_listing
from repro.planner import plan as ref_plan
from repro_torch.convert import (deepfm_params_from_numpy,
                                 gnn_params_from_numpy, lm_params_from_numpy)
from repro_torch.core.operators import EngineCaps
from repro_torch.data.treegen import TreeSpec
from repro_torch.examples import (bfs_traversal, gnn_reddit, quickstart,
                                  recsys_serve, train_lm)
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.frontier_expand import ops as fe_ops
from repro_torch.kernels.frontier_pull import ops as fp_ops
from repro_torch.kernels.late_gather import ops as lg_ops
from repro_torch.kernels.spmm_segment import ops as spmm_ops
from conftest import subprocess_env
from test_torch_engine import release_reference_executables  # noqa: F401
from test_torch_sampler import reference_draws

TRAIN_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_LOSS_RTOL = 1e-2
QUICK_SPEC = dict(num_vertices=1500, height=10, payload_cols=4, seed=0)
BFS_SPEC = dict(num_vertices=3000, height=14, payload_cols=8, seed=1)
BFS_CAPS = (1 << 12, 1 << 13)
BFS_DEPTHS = (5, 10)
N_ROOTS, ROOT_STEP = 4, 100
# the distributed section's cut: E = 4,096 rows, 512 a shard of 8
DIST_SPEC = dict(num_vertices=4097, height=14, payload_cols=8, seed=1)
DIST_CAPS = (1 << 8, 1 << 9)
DIST_DEPTH = 10
GNN = dict(nodes=500, edges=4000, batch=16, steps=2)
RECSYS = dict(train_steps=2, train_batch=64, serve_batch=16,
              serve_requests=5, vocab_scale=0.001, n_candidates=512)
LM = dict(d_model=64, layers=2, batch=2, seq=64, vocab=256)
KERNEL_OPS = (lg_ops, spmm_ops, eb_ops, fe_ops, fp_ops)


@pytest.fixture
def no_launch():
    """The kernels' launch counters are unchanged by the test."""
    before = [m.LAUNCHES for m in KERNEL_OPS]
    yield
    assert [m.LAUNCHES for m in KERNEL_OPS] == before


def ref_dataset(spec):
    return RefDataset.prepare(ref_make_edge_table(RefTreeSpec(**spec)),
                              spec["num_vertices"])


def test_quickstart_matches_the_reference(no_launch, capsys):
    spec = TreeSpec(**QUICK_SPEC)
    got = quickstart.run(spec, device="cpu", reps=1)
    ds = ref_dataset(QUICK_SPEC)
    caps = RefCaps(frontier=spec.num_vertices, result=spec.num_vertices)
    for engine in quickstart.ENGINES:
        r = ref_run_query(RefQuery(engine=engine, max_depth=10,
                                   payload_cols=4, caps=caps), ds, root=0)
        assert got["engines"][engine]["rows"] == int(r.count), engine
        assert got["engines"][engine]["levels"] == int(r.depth), engine
    report = ref_plan(ref_paper_listing(2, root=0, depth=10,
                                        payload_cols=4), ds, caps=caps)
    assert [label for label, _ in got["ranking"]] == \
        [c.label for c in report.ranked]
    assert "planner ranking:" in capsys.readouterr().out


def test_bfs_traversal_sections_match_the_reference(no_launch, capsys):
    got = bfs_traversal.run(TreeSpec(**BFS_SPEC), EngineCaps(*BFS_CAPS),
                            depths=BFS_DEPTHS, n_roots=N_ROOTS,
                            root_step=ROOT_STEP, device="cpu")
    ds = ref_dataset(BFS_SPEC)
    caps = RefCaps(*BFS_CAPS)
    sql = ref_paper_listing(2, root=0, depth=10, payload_cols=8)
    report = ref_plan(sql, ds, caps=caps)
    r = ref_plan_and_run(sql, ds, caps=caps)
    n = int(r.count)
    assert got["planner"]["ranked"] == [c.label for c in report.ranked]
    assert got["planner"]["chose"] == report.best.label
    assert got["planner"]["rows"] == n
    assert got["planner"]["depth_column_max"] == \
        int(np.asarray(r.values["depth"])[:n].max())
    assert got["planner"]["where_rows"] == int(ref_plan_and_run(
        sql + " WHERE depth <= 3", ds, caps=caps).count)
    for depth in BFS_DEPTHS:
        r = ref_run_query(RefQuery("precursive", depth, 8, caps), ds, 0)
        assert got["sweep"][depth]["rows"] == int(r.count)
        assert got["sweep"][depth]["overflow"] == bool(r.overflow)
    roots = jnp.arange(N_ROOTS, dtype=jnp.int32) * ROOT_STEP
    rb = ref_run_query_batch(RefQuery("precursive", 10, 8, caps), ds, roots)
    assert got["batch"]["rows"] == np.asarray(rb.count).tolist()
    leaf = got["directions"]["leaf"]
    assert leaf == int(np.asarray(ds.table.column("to"))[-1])
    for direction in ("outbound", "inbound", "both"):
        r = ref_run_query(RefQuery("precursive", 10, 8, caps,
                                   direction=direction), ds, leaf)
        n = int(r.count)
        assert got["directions"][direction] == {
            "rows": n, "levels": int(r.depth), "overflow": bool(r.overflow),
            "max_row_depth": int(np.asarray(r.row_depths)[:n].max())
            if n else 0}, direction
    assert got["plan"] == ref_plan_repr("precursive", 10, 8)
    assert "=== the PRecursive plan" in capsys.readouterr().out


REFERENCE_DISTRIBUTED = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import EngineCaps
from repro.core.distributed_bfs import make_distributed_pbfs
from repro.data.treegen import TreeSpec, make_edge_table
from repro.launch.mesh import make_mesh

spec, caps, depth = json.loads(sys.argv[1])
table = make_edge_table(TreeSpec(**spec))
mesh = make_mesh((8,), ("data",))
fn = make_distributed_pbfs(mesh, ("data",), spec["num_vertices"],
                           caps=EngineCaps(*caps), max_depth=depth,
                           num_payload_cols=spec["payload_cols"])
sh = NamedSharding(mesh, P("data"))
args = [jax.device_put(np.asarray(table.column(k)), sh)
        for k in ("from", "to", "column1")]
counts = np.asarray(fn(*args, jnp.int32(0))[2]).ravel()
print(json.dumps(counts.tolist()))
"""


def test_bfs_traversal_distributed_section_matches_the_reference(
        no_launch, capsys):
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_DISTRIBUTED,
         json.dumps([DIST_SPEC, DIST_CAPS, DIST_DEPTH])],
        env=subprocess_env(8), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        got = bfs_traversal.run_distributed(
            TreeSpec(**DIST_SPEC), EngineCaps(*DIST_CAPS),
            max_depth=DIST_DEPTH, device="cpu")
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    want = json.loads(out.strip().splitlines()[-1])
    assert got["world"] == bfs_traversal.CPU_RANKS == len(want)
    assert got["counts"] == want
    assert got["rows"] == sum(want) > 0
    assert got["ms"] > 0
    printed = capsys.readouterr().out
    assert f"rows={sum(want)}" in printed
    assert f"per-shard result counts: {want}" in printed


def test_recsys_serve_first_loss_matches_the_reference(no_launch):
    cfg = RefRecsysConfig(name="deepfm", vocab_scale=RECSYS["vocab_scale"])
    ref_params = ref_recsys.init_deepfm(jax.random.PRNGKey(0), cfg)
    opt = RefAdamW(lr=ref_schedule(1e-3, 10, RECSYS["train_steps"]))
    batch = {k: jnp.asarray(v) for k, v in ref_recsys_batch(
        0, 0, RECSYS["train_batch"],
        vocabs=ref_vocab_sizes(cfg.vocab_scale)).items()}
    batch["offsets"] = jnp.asarray(ref_recsys.field_offsets(cfg))
    _, _, m = jax.jit(ref_recsys.make_deepfm_train_step(cfg, opt))(
        ref_params, opt.init(ref_params), batch)
    got = recsys_serve.run(**RECSYS, device="cpu",
                           params=deepfm_params_from_numpy(
                               jax.tree_util.tree_map(np.asarray,
                                                      ref_params), "cpu"))
    assert np.all(np.isfinite(got["losses"]))
    assert len(got["losses"]) == RECSYS["train_steps"]
    np.testing.assert_allclose(got["losses"][0], float(m["loss"]),
                               **TRAIN_TOL)
    assert len(got["top5"]) == 5 and got["p50_ms"] > 0


def test_gnn_reddit_first_loss_matches_the_reference(no_launch):
    cfg = gnn_reddit.sage_config()
    ref_cfg = RefGNNConfig(name="sage", kind="graphsage", n_layers=2,
                           d_hidden=128, d_feat=64, num_classes=41,
                           sample_sizes=gnn_reddit.FANOUT)
    nodes, b = GNN["nodes"], GNN["batch"]
    g = ref_graphgen.make_graph(nodes, GNN["edges"], cfg.d_feat,
                                num_classes=cfg.num_classes, seed=0)
    csr = ref_build_csr(jnp.asarray(g.src), nodes)
    ref_params = ref_gnn.init_gnn(jax.random.PRNGKey(0), ref_cfg,
                                  cfg.d_feat, cfg.num_classes)
    opt = RefAdamW(lr=ref_schedule(1e-3, 20, GNN["steps"]))
    key = jax.random.PRNGKey(0)
    seeds = jax.random.randint(key, (b,), 0, nodes, jnp.int32)
    layers = ref_sample_block(key, csr, jnp.asarray(g.dst), seeds,
                              gnn_reddit.FANOUT)
    block = {"layer_feats": ref_gather(jnp.asarray(g.feats), layers),
             "labels": jnp.take(jnp.asarray(g.labels), seeds)}
    _, _, m = jax.jit(ref_gnn.make_gnn_train_step(ref_cfg, opt,
                                                  block=True))(
        ref_params, opt.init(ref_params), block)

    def sample(s):
        k = jax.random.PRNGKey(s)
        sd = jax.random.randint(k, (b,), 0, nodes, jnp.int32)
        return (torch.from_numpy(np.array(sd)),
                [torch.tensor(d) for d in
                 reference_draws(k, b, gnn_reddit.FANOUT)])

    got = gnn_reddit.run(nodes, GNN["edges"], b, GNN["steps"], "cpu",
                         params=gnn_params_from_numpy(
                             jax.tree_util.tree_map(np.asarray, ref_params),
                             "cpu"), sample=sample)
    assert np.all(np.isfinite(got["losses"]))
    np.testing.assert_allclose(got["losses"][0], float(m["loss"]),
                               **TRAIN_TOL)
    # the generator's own draws train too
    own = gnn_reddit.run(nodes, GNN["edges"], b, GNN["steps"], "cpu")
    assert np.all(np.isfinite(own["losses"]))


def test_train_lm_first_loss_matches_the_reference(no_launch, tmp_path):
    cfg = train_lm.example_config(LM["d_model"], LM["layers"], LM["vocab"])
    ref_cfg = RefLMConfig(name="example-lm", n_layers=cfg.n_layers,
                          d_model=cfg.d_model, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                          vocab=cfg.vocab, qkv_bias=True, attn_chunk=64,
                          loss_chunk=64)
    ref_params = ref_tfm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    opt = ref_make_optimizer()
    batch = {k: jnp.asarray(v) for k, v in ref_lm_batch(
        0, 0, LM["batch"], LM["seq"], LM["vocab"]).items()}
    _, _, m = jax.jit(ref_tfm.make_train_step(ref_cfg, opt))(
        ref_params, opt.init(ref_params), batch)
    params = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    got = train_lm.run(2, **LM, ckpt_dir=str(tmp_path), device="cpu",
                       params=params)
    assert np.all(np.isfinite(got["losses"])) and len(got["losses"]) == 2
    np.testing.assert_allclose(got["losses"][0], float(m["loss"]),
                               rtol=BF16_LOSS_RTOL)
    resumed = train_lm.main(["--steps", "3", "--d-model", "64", "--layers",
                             "2", "--batch", "2", "--seq", "64", "--vocab",
                             "256", "--ckpt-dir", str(tmp_path),
                             "--resume", "--device", "cpu"])
    assert resumed["resumed_at"] == 2 and len(resumed["losses"]) == 1


def test_train_lm_checkpoints_in_the_temporary_directory(no_launch, tmp_path,
                                                        monkeypatch):
    """Without ``--ckpt-dir`` the checkpoints go to ``repro_lm_ckpt`` in
    the temporary directory (``$TMPDIR``), never a fixed path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = train_lm.main(["--steps", "1", "--d-model", "64", "--layers", "1",
                         "--batch", "2", "--seq", "32", "--vocab", "256",
                         "--device", "cpu"])
    assert len(out["losses"]) == 1
    assert any((tmp_path / "repro_lm_ckpt").iterdir())


def test_small_mains_run_on_the_cpu(no_launch):
    hist = gnn_reddit.main(["--steps", "2", "--nodes", "300", "--edges",
                            "2000", "--batch", "8", "--device", "cpu"])
    assert len(hist["losses"]) == 2
    out = recsys_serve.main(["--train-steps", "1", "--train-batch", "32",
                             "--serve-batch", "8", "--serve-requests", "4",
                             "--vocab-scale", "0.001", "--device", "cpu"])
    assert np.all(np.isfinite(out["losses"]))
