"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. print the card's name and power limit; build the CUDA kernels with
   ``nvcc`` from ``src/repro_torch/csrc`` and time the build;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (exact equality; ``frontier_expand`` at root 0's
   widest level and at the seeded cases that split its tiles
   (``expand_case``: F beside the 2,048-target scan tile, a zero-degree
   run longer than a tile, a hub across output tiles, a total on an
   output tile edge, cuts, out-of-range valid targets, F = 1, F = 0,
   E = 0), its device launches per call and its kernels' times read
   from ``torch.profiler`` after phase 3's profile lines; ``late_gather``
   at the take of all 12 output columns at root 0's positions, at one
   column in each of float32, int32 and bfloat16 and at DeepFM's lookup,
   each also with negative positions mixed in; ``frontier_pull`` at
   ``diropt`` root 0's first pull level over the dataset's pull layout
   (``ms``) and building its own (``wrapper_ms``), at the inbound view's
   hub (vertex 0 unvisited, its only frontier in-neighbor last in its
   83,619-entry row) and at the shared ``PULL_CASES`` (``frontier_pull
   cases:``), with its device launches per call, no memset, and its
   kernels' times read from ``torch.profiler`` last (``frontier_pull
   profile:``); ``spmm_segment`` at root
   0's widest ``bitmap`` aggregate_sum level (exact), on two random graphs
   with in-degree > 1 (within rtol = atol = 1e-5), on the tree's inbound
   view, whose vertex 0 owns 83,619 edges, at D = 1 (d) and at
   GraphSAGE-Reddit's D = 128 (e) (within 1e-5 of each row's sum of
   absolute terms), and on the shared tile cases (``spmm_tile_case``:
   hubs beside the tile starts and the hub threshold, medium rows,
   dropped edges, E < P, E = 0, no row) at D = 1, 4, 17 and 128 (rows of
   at most 32 edges equal to the CPU run, the rest within 1e-5 of their
   absolute sums, two calls bit-equal), with its device launches per
   call and its kernels' times at (a) and (d) read from
   ``torch.profiler`` after phase 3's profile lines;
   ``embedding_bag`` at four shapes, the first the full DeepFM table with
   the serve_bulk batch's 39 positions per sample as bags (within 1e-5 of
   each bag's sum of absolute terms, and bit-equal to the plain version
   run on the CPU), with the layout ``bag_layout`` chose, and on the
   shared layout cases (``bag_layout_case``: every layout, bags of 0, 1,
   K - 1, K, K + 1, 39 and 3,000 entries, a table at a storage offset),
   weighted and not, under sum and mean (bit-equal to the CPU run, two
   calls bit-equal), with its device launches per call and its kernel's
   own time at the four shapes read from ``torch.profiler`` after phase
   3's profile lines; the lane axis of ``frontier_expand`` and
   ``frontier_pull`` (one call for the BATCH_ROOTS lanes of root 0's
   batch, at root 0's widest expansion level and at ``diropt`` root 0's
   first pull level, bit-equal to the plain version and to each lane's
   one-lane call, and every ``expand_lanes_case`` / ``pull_lanes_case``,
   a shared case stacked as four lanes), with its device launches per
   call and its kernels' times read last (``frontier_expand lanes:``,
   ``frontier_pull lanes:``); the lane axis of ``spmm_segment`` (the
   eight lanes of the outbound aggregate_sum batch at root 0's widest
   dense level, each lane's frontier bits its source mask, exact against
   the lane-axis plain version, each lane bit-equal to its one-lane call
   on its masked sources, one lane with its mask equal to that call; the
   same edges with seeded x on every vertex and eight seeded masks of
   density 0 to 1 (``seeded``), exact; and every tile case at D = 1 and
   17 as eight lanes, lane 1 masked off, against the plain version run on
   the CPU; ``spmm_segment lane cases:``, then ``spmm_segment lanes:``
   with its device launches per call, the 8 one-lane calls in a row and
   ``torch.sparse.mm`` of all lanes at once beside it); and time the kernel,
   the plain version and, where one exists, a single PyTorch library
   call;
3. drive three paths at full size on the repo's own deployment
   (``src/repro/configs/posdb_bfs.py``: 2^20-vertex tree of height 16,
   8 payload columns, depth 16, result cap 2^20, plus a float32 edge
   weight column ``w`` uniform in [0.5, 2)) with a per-level frontier cap
   of 2^18, through ``run_query``: PRecursive for 10 requests; the dense
   and direction-optimizing engines (``bitmap``, ``hybrid``, ``diropt``,
   ``diropt_hybrid``) for 4 requests each, and the two direction-
   optimizing plans with the switch forced to pull; the weighted
   ``precursive`` (11 requests) and ``bitmap`` (7) engines under the five
   value semirings.  Every result must equal the port's CPU run bit for
   bit (``vertex_values`` included), ``diropt`` must equal ``bitmap`` and
   ``diropt_hybrid`` ``hybrid`` row for row, root 0 must equal the BFS
   oracle (and, weighted, the path sums and products of the weights), and
   each path's kernel launch counters (zeroed just before the path, read
   just after) must show it went through its kernels; then DeepFM serving
   at the published Criteo width (``src/repro/configs/deepfm.py``:
   32,722,432-row table, embed_dim 10, MLP 400-400-400, random weights
   from a seed) for 8 serve_p99 requests (B = 512), one serve_bulk request
   (B = 262,144) and one retrieval request (1,000,000 candidates), against
   the port's CPU run (positions equal except bucket flips at a bucket
   boundary, which are counted; scores within rtol = atol = 2e-5, TF32
   off), and one ``embedding_bag`` call at the serve_bulk bags as its
   users call it; then batched roots through ``run_query_batch``: each
   engine outbound over BATCH_ROOTS = 8 roots (the PRecursive requests'
   outbound roots), PRecursive inbound and both ways over 8 roots with
   the deepest vertex among them, and PRecursive over a 32-root serving
   bucket, every lane bit-equal to the card's single-root run of its
   root and root 0's lane to the BFS oracle, each per-level kernel
   called once a level for all lanes (its launches equal the levels at
   which some lane calls it), one ``batch:`` line per call; warm
   latencies and ``torch.profiler`` lines follow (the forced-pull
   ``diropt`` root 0's, the ``bags`` call's and the 8-root
   ``precursive`` and ``diropt`` batches' among them);
4. the paper's tuple-based and row-store engines (``trecursive``,
   ``rowstore``, ``rowstore_index`` and the three Exp-3 rewrites) on the
   deployment's table without the weight column, root 0 outbound, and
   ``trecursive`` and
   ``trecursive_rewrite`` from the deepest vertex inbound and both ways,
   through ``run_query`` (the row table, 47 slots of 188 bytes a row, is
   built on the first row-store request): every result equal to the
   port's CPU run
   bit for bit, root 0's rows (their ids mapped back to positions where
   the recursion carried values) equal to the BFS oracle, and the path's
   launches equal to the CPU run's levels (``frontier_expand`` a level on
   the IndexJoin engines, ``late_gather`` a level and one for the seed
   block, one more for a rewrite's top-level join); a ``profile:`` line
   each; ``late_gather`` at the row table's shape (``late_gather rows
   case:``, ``take_rows`` at ``rowstore`` root 0's widest level, with
   ``index_select`` as the library call); then the paper's Exp 1-3
   (Fig. 5-7) at depth 16 from root 0, ``exp1:`` on the same tree with no
   payload column (rows of 7 slots, 28 bytes), ``exp2:`` and ``exp3:`` on
   that 8-payload table: each engine's root 0 checked against the BFS
   oracle, then its warm ms (median of 3), busy ms, launches and idle
   share (the paper path's, where it ran the request), and its speedup
   against ``rowstore`` (Exp 1-2) or
   ``rowstore_rewrite`` (Exp 3) in warm and busy ms; last, after every
   earlier profile line (its host and device memory stay out of their
   numbers), the weighted batches over the eight batch roots on the
   table with ``w`` (``precursive`` outbound under each semiring and
   shortest_path inbound and both ways, ``bitmap`` outbound under each
   semiring and shortest_path and aggregate_sum inbound) and the
   value-engine batches on the paper's table (each of the six outbound,
   ``trecursive`` and ``trecursive_rewrite`` inbound and both ways):
   every lane bit-equal to its single-root card run, root 0's lane to
   the BFS and path oracles, ``spmm_segment``, ``frontier_expand`` and
   ``late_gather`` called once a level for all lanes (``batch:`` lines
   with warm ms beside the roots one by one, peak MiB and the reckoned
   result buffers; two ``profile:`` lines), and a weighted
   ``run_query_buckets`` in two buckets of 4 (``weighted buckets:``);
   then, on the same table without the weight column: MS-BFS
   (``run_query_multi``) over the 32-root serving bucket outbound,
   inbound and both ways, every lane the same rows (positions,
   count, depth, overflow, row depths, every column) as lane i of the
   card's ``diropt`` batch over the same roots, root 0's lane equal to
   the BFS oracle, the outbound call equal to the port's CPU run on every
   field, ``late_gather`` launched once a call and no traversal kernel
   (one ``multiquery:`` line a direction, with warm ms, busy ms and
   launches beside the ``diropt`` batch's); per-lane depth caps
   (``multiquery depth caps:``, each capped lane equal to ``diropt`` at
   that depth); the bucket executor on one MS-BFS bucket at result cap
   2^12, fallback caps (2^18, 2^20), evicting exactly the lanes over the
   cap (``multiquery eviction:``, each evicted lane equal to ``diropt`` at
   the fallback caps, the others keeping their rows); and
   ``run_query_buckets`` of ``precursive`` over the 32 roots in four
   buckets of 8, every root bit-equal to its single-root card run
   (``buckets:``, beside one 32-root batch);
5. the cost-based planner (``repro_torch.planner``) on the table with
   ``w``: ``ds.stats(d)`` for each direction, equal field for field to the
   port's CPU dataset's (``planner stats:``, ms per pass); five queries
   (paper listings 1-3 at depth 16, listing 2 with the 8 payloads, and
   the shortest_path and aggregate_sum weighted listings), each planned
   with ``DEFAULT_CONSTANTS`` on the card and on the CPU dataset (the same
   ranked labels, prices and skipped reasons), its pick run from root 0
   bit-equal to ``run_query`` of the chosen engine (every dressed column,
   ``depth`` and ``value`` included), root 0 equal to the BFS oracle and,
   weighted, to the path oracle, and its launches equal to the levels
   that call each kernel (one ``planner:`` line each: the pick, the top
   three with their prices, the plan ms with the statistics cached, and
   ``plan_and_run``'s warm ms beside ``run_query``'s); ``plan_and_run`` of
   listing 1 over the eight batch roots, every lane equal to
   ``run_query_batch`` of the pick, and ``run_bucketed`` over the 32
   serving roots, every root's live rows equal to its single-root run on
   the port's CPU dataset, root 0 to the BFS oracle, one ``late_gather``
   a bucket and each per-level kernel once on each level where a lane of
   the bucket calls it (``planner batches:``, with the buckets
   ``bucket_roots`` made); the three kernel factors measured on the card,
   each the ratio of the kernel and plain microseconds it was measured
   from (``planner factors:``), and the ``precursive+kernel`` candidate
   they price, its run equal to ``run_query`` of ``precursive`` and to
   the BFS oracle with ``frontier_expand`` once a level, and
   ``frontier_expand`` at the candidate's frontier capacity at root 0's
   widest level bit-equal to its plain version (``planner kernel
   candidate:``); the admission guards over the serving roots, the same
   decisions on the card and the CPU dataset (``planner guards:``);
6. the traversal serving layer (``repro_torch.planner.serving``) on the
   same table: a ``ServingSession`` on the card and one on the CPU
   dataset submit listing 1 over the 32 serving roots (cold, then 3 warm)
   and aggregate_sum over the eight batch roots, every lane bit-equal to
   the CPU session's, root 0 to the BFS and path oracles, the buckets'
   engines and the plan document equal, and each kernel's launches
   exactly one take a bucket and each per-level kernel once on each level
   where a lane of the bucket calls it (``serving:``, with warm ms per
   root beside ``plan_and_run`` and ``run_query_batch`` of the same
   roots, and a ``profile:`` line of the warm submit); ``enqueue`` x 32 +
   ``flush`` as one coalesced dispatch; the plan store saved and a new
   card session rehydrated from it, zero parse / statistics / costing
   passes and the same lanes (``serving store:``); ``explain``,
   ``explain_json`` and ``explain_analyze`` of listing 1 equal to the CPU
   dataset's but the wall time, and the session's EXPLAIN ANALYZE over
   the 32 roots (``serving explain:``); a session with the default
   ``calibrate_every`` served warm until its calibrator refits: the refit
   constants, refits accepted and rejected, each listing's pick under
   them (a changed pick run on the card equal to the CPU run), each plan
   signature's mean measured bucket interval beside the prior's
   prediction, the last warm 32-root request's buckets with each one's
   own ``elapsed_us`` (each below the request's time), the accepted
   refits out of all and the calibrator's reason for its last rejection,
   warm p50 / p99 and roots per second (``serving calibration:``); one warm request traced to JSONL and held to the
   port's ``check_trace``, its request, transfer and level-event span
   ms, and the warm ms with the tracer on and off, median of 5 each
   (``serving trace:``);
   the admission decisions equal to the CPU session's and a 20 ms
   deadline under an injected 50 ms straggler, the skipped roots named
   and empty and the served lanes bit-equal (``serving guards:``); and
   ``python -m repro_torch.launch.serve --traversal`` at 2^20 vertices,
   height and depth 16, batches of 8, 16 requests, with a plan store and
   a trace, run twice, the second ``(rehydrated)`` with zero planning
   passes (``serving entry:``);
7. GNN inference at the published widths (``src/repro/configs``:
   GAT-Cora, GatedGCN, EGNN, GraphSAGE-Reddit) on seeded R-MAT graphs
   and molecule batches of the published shapes (``GNN_SHAPES``), random
   weights from a seed: GAT-Cora and GatedGCN on ``full_graph_sm``,
   GatedGCN and EGNN (with coordinates) on ``molecule``, each
   ``gnn_forward`` within ``rtol = atol = 1e-4`` of the port's CPU run,
   but EGNN's, whose logits reach ~8,000 and whose CPU float32 run itself
   drifts past that from float64: its largest error against the CPU run
   in float64 no larger than 4 times the CPU float32 run's own, or within
   1e-4 of the largest logit, both distances printed;
   GraphSAGE-Reddit's ``gnn_forward`` on ``ogb_products`` (2,449,029
   vertices, 61,859,140 edges), its logits within 1e-4 of a forward
   assembled here with the plain aggregation, ``spmm_segment`` launched
   once a layer and held against its plain version at each layer's input
   (D = 128, within 1e-5 of each row's sum of absolute terms of the plain
   version run in float64, the float32 plain version's own error beside
   it; ``gnn
   spmm_segment:``, with the kernel's, the wrapper's, the plain and
   ``torch.sparse.mm``'s times and the bound from the compulsory bytes
   beside the bound from gathering an x row per edge); and its minibatch
   path on ``minibatch_lg`` (1,024 seeds, fan-out (15, 10) over
   114,615,892 edges): ``sample_block`` from a seeded card generator,
   ``gather_block_features`` and ``sage_block_forward``, the layers equal
   to the port's CPU sampler fed the same draws and the logits within
   1e-4 of its CPU forward.  Each graph's host generation and copy to
   the card print on a ``gnn graph:`` line, each row on a ``gnn:`` line
   (warm ms, device ms, the host's share, peak MiB above what was held,
   launches);
8. training through the trainer's cells (``repro_torch.launch.steps
   .build_cell``, the cells' own seeded graphs and batches, random
   weights from a seed, TF32 off), one ``train:`` line a row (warm ms per
   step, host median of 3 after the counted run; device ms and the
   host's share; peak MiB above what was held; launches; seconds):
   GraphSAGE-Reddit on ``ogb_products`` for three AdamW steps,
   ``spmm_segment`` launched twice a layer a step (forward, and the
   backward over the edges grouped by source), step 1's loss and every
   gradient within 1e-4 of each leaf's largest of the same step with the
   plain aggregation in both directions on the card, the backward kernel
   at each layer's gradient within 1e-5 of each row's sum of absolute
   terms of the float64 plain version over the transposed edges (``train
   spmm_segment backward:``, with the kernel's ms, its ms with the
   grouping sort, the plain version's, ``torch.sparse.mm`` of the
   transpose and the bound), and a ``CheckpointManager`` checkpoint after
   step 2 restored into zeroed trees whose step 3 is bit-equal to the
   uninterrupted one in every leaf; its sampled path on ``minibatch_lg``
   for one step, the layers equal to the CPU sampler fed the card
   generator's draws and the loss and gradients within 1e-4 of the
   port's CPU step; GAT-Cora and GatedGCN on ``full_graph_sm``, GatedGCN
   and EGNN on ``molecule`` for one step each, the gradients within 1e-4
   (GatedGCN on ``full_graph_sm``: 3e-4, ``TRAIN_ROW_TOL``) of the port's
   CPU run in float32 and of that run in float64, the CPU float32 run's
   own distance from float64 printed beside them; and DeepFM on
   ``train_batch`` (B = 65,536, the 32,722,432-row table) for one dense
   AdamW step (``late_gather`` forward, its scatter-add backward), its
   loss and gradients within 1e-4 of the same step with the plain lookup
   (touched table rows row by row, the rest zero in both), the
   gradient's own time (``train late_gather gradient:``), then one lazy
   step whose untouched rows and moments are bit-equal to before and
   whose touched rows are within 1e-5 of its CPU run;
9. LM serving (``repro_torch.models.transformer``, ``launch.serve
   .serve_batch``) at the published widths (``src/repro/configs``),
   random weights from a seeded CUDA generator, TF32 off: qwen2-0.5b at
   full width and depth (24 layers) and deepseek-v2-lite-16b at 2 of its
   27 layers, each in float32, a prefill of 2 x 64 ``lm_batch`` tokens
   and 8 greedy decode steps on the card against the port's CPU run of
   the same weights fed the card's tokens, every block's logits within
   1e-4 of the largest and each greedy token equal to the CPU's argmax
   where its top two differ by more (``lm check:``); then, in the configs'
   bfloat16 (qwen2's weights cast, deepseek's 27 layers drawn a layer at a
   time into bfloat16), one ``lm:`` line a row with its cuts of
   ``LM_SHAPES``: ``prefill_32k`` at batch 1 for both, ``decode_32k`` at
   batch 32 (qwen2) and 16 (deepseek), 8 steps against a seeded cache
   of 32,768 positions, and qwen2's ``serve_batch`` at batch 8, prompt
   512, gen 16 (warm ms, one warm run after the counted one, none for a
   prefill, whose ms is the counted run's; ms a token, tok/s, device ms
   and the host's share from ``torch.profiler``, device launches,
   ``late_gather``
   launches held to one a block for the lookup and two a MoE layer,
   peak MiB above what was held); ``lm attention:`` the ported
   ``chunked_attention`` beside ``F.scaled_dot_product_attention`` at
   qwen2's prefill shape (a yardstick); ``lm late_gather:`` the kernel
   bit-equal to its plain version at qwen2's float32 token lookup of the
   32,768 prefill tokens and at deepseek's layer-0 MoE dispatch (its
   routing's sentinels T) and combine (sentinels E·cap), timed beside
   the plain version and ``index_select`` with its bound; ``lm phase:``
   its seconds;
10. LM training (``models.transformer.make_train_step``, ``launch.train``),
   TF32 off: one step of qwen2-0.5b and of deepseek-v2-lite-16b, each at
   full width with 2 layers, in float32, on a ``lm_batch`` batch of
   2 x 64 tokens, on the card with ``remat`` and without against the
   port's CPU run of the same weights and batch (its loss and gradients,
   no optimizer step there): the loss within 1e-4 relative and every
   gradient (read off the step's first moments) within 1e-4 of its
   leaf's largest, ``late_gather`` launched once for the lookup and
   twice a MoE layer, four times under ``remat`` (``train lm check:``);
   then ``launch.train.build_run`` and ``TrainRun.run`` for 4 AdamW steps
   of ``train_4k`` (S = 4,096) cut in batch to 8: qwen2-0.5b at full
   width and depth, float32 weights, bfloat16 compute, ``remat``, and
   deepseek-v2-lite-16b at 2 of its 27 layers (``train lm:``: each
   step's ms, warm ms the median of steps 2-4, tok/s, device ms and the
   host's share from a profiled step, device launches, ``late_gather``
   launches held to the count above, peak MiB above what was held, the
   losses, all finite); qwen2's run again as 2 steps saved by its
   ``CheckpointManager`` into a temporary directory, a run restored from
   it and 2 more steps, held to the straight run (the gradients' adds are
   atomics): losses within 1e-3 relative, parameters within 1e-3 of each
   leaf's largest plus twice the learning rates' sum, moments within 1e-3
   of the largest moment; with the save's seconds; and
   ``late_gather``'s gradient (``LateGather``'s ``index_add_``) at
   qwen2's lookup and deepseek's layer-0 MoE dispatch and combine at
   those shapes, against the plain gather's own gradient and the sum in
   float64 (within n·u of each element's sum of absolute terms), timed
   with its bound (``train lm late_gather gradient:``); ``train lm
   phase:`` its seconds;
11. the launch tooling (``repro_torch.launch.{count,roofline,probe,
   dryrun,hillclimb}``) and the examples (``repro_torch.examples``):
   ``roofline card:`` (the data sheet's peaks beside the card's name and
   power limit), ``roofline check:`` (phase 10's two LM train steps at
   their cuts, and phase 8's GraphSAGE ``ogb_products`` and DeepFM
   ``train_batch`` steps, each counted under ``launch.count.CountMode``
   on the card and on ``meta``: FLOPs by dtype, eager and compulsory
   bytes and the kernels' charges equal), ``roofline measured:`` (those
   steps and phase 9's qwen2 prefill: the bound beside the warm time
   measured, its share, and an LM step's MFU), ``examples:`` (each
   example on the card at the reference script's widths, steps and
   requests cut; its seconds, headline numbers and kernel launches,
   counted into the ``examples`` path; every loss finite), then
   ``quickstart`` and ``bfs_traversal`` again on the CPU, their rows,
   levels, rankings and plans equal to the card's, ``dryrun:``
   (``launch.dryrun.run_cell`` on ``meta`` at full size for every
   published cell of qwen2-0.5b and deepseek-v2-lite-16b, a skipped one
   with its reason), ``hillclimb:`` (``launch.hillclimb.measure`` of its
   three cells and of qwen2-prefill under ``attn_q_block=4096
   attn_chunk=8192``) and ``launch phase:``.  The full ``python -m
   repro_torch.launch.dryrun --all`` is a command of its own;
12. the distributed positional BFS (``core.distributed_bfs``) in a
   default group of world size 1 (``cpu:gloo,cuda:nccl``, a file store
   in a temporary directory, destroyed after): ``make_distributed_pbfs``
   on the card under NCCL at the deployment's size and caps (the 8
   payload columns, depth 16) from root 0 and two seeded random inner
   vertices, and from root 0 at ``posdb-bfs``'s own caps (frontier
   2^15: overflow), counted into the ``distributed`` path (one
   ``frontier_expand`` a level, one ``late_gather`` a call, one
   all-gather a level); every output bit-equal to the same function's
   gloo run on the CPU, the live positions equal to the BFS oracle as a
   set, the values equal to the payload rows there, the overflow flags
   equal (set at the config's caps); ``late_gather`` at the path's
   payload take against its plain version (``distributed late_gather
   case:``); ``distributed bfs:`` with warm ms, device busy ms and
   launches, levels, all-gathers and their bytes, the payload bytes that
   crossed a link (0) and the card; then ``bfs_traversal``'s distributed
   section on the card (one spawned NCCL rank a card), its per-shard
   counts equal to this process's gloo CPU run (``examples
   distributed:``).  Multi-rank NCCL needs more than one card and is not
   run here;
13. print one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line last.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.deepfm import CONFIG as DEEPFM  # noqa: E402
from repro_torch.configs.registry import (GNN_SHAPES,  # noqa: E402
                                          LM_SHAPES, RECSYS_SHAPES)
from repro_torch.convert import dataset_from_numpy  # noqa: E402
from repro_torch.core.bitmap import (diropt_hybrid_plan,  # noqa: E402
                                     diropt_plan)
from repro_torch.core.csr import (CSRIndex, build_csr,  # noqa: E402
                                   expand_frontier)
from repro_torch.core.engine import (PUSH_COUNTERPART,  # noqa: E402
                                     VALUE_ENGINE_NAMES, EngineCaps,
                                     RecursiveQuery, build_plan,
                                     dispatch_buckets, lane_eviction_count,
                                     positions_available, result_lane,
                                     run_query, run_query_batch,
                                     run_query_buckets, run_query_multi)
from repro_torch.core import operators  # noqa: E402
from repro_torch.core.distributed_bfs import \
    make_distributed_pbfs  # noqa: E402
from repro_torch.core.operators import execute  # noqa: E402
from repro_torch.core.table import payload_names  # noqa: E402
from repro_torch.configs.posdb_bfs import CONFIG as POSDB  # noqa: E402
from repro_torch.data.recsys_stream import (recsys_batch,  # noqa: E402
                                            vocab_sizes)
from repro_torch.data.treegen import (TreeSpec, bfs_reference,  # noqa: E402
                                      make_edge_table)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as eb_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import \
    fixed_hot_lookup  # noqa: E402
from repro_torch.kernels.embedding_bag.embedding_bag import \
    bag_layout  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (  # noqa: E402
    BAG_LAYOUT_CASES, bag_cases, bag_layout_case, embedding_bag_ref,
    layout_table)
from repro_torch.kernels.frontier_expand import ops as fe_ops  # noqa: E402
from repro_torch.kernels.frontier_expand.ref import (  # noqa: E402
    EXPAND_CASES, expand_case, expand_lanes_case)
from repro_torch.kernels.frontier_pull import ops as fp_ops  # noqa: E402
from repro_torch.kernels.frontier_pull import (  # noqa: E402
    PULL_CASES, build_pull_layout, frontier_pull_layout_ref,
    frontier_pull_ref, pull_case, pull_lanes_case)
from repro_torch.kernels.late_gather import ops as lg_ops  # noqa: E402
from repro_torch.kernels.late_gather.ref import (  # noqa: E402
    late_gather_columns_ref, late_gather_ref)
from repro_torch.kernels.spmm_segment import ops as spmm_ops  # noqa: E402
from repro_torch.kernels.spmm_segment.ref import (  # noqa: E402
    SPMM_CASES, spmm_segment_lanes_ref, spmm_segment_ref, spmm_tile_case)
from repro_torch.kernels.spmm_segment.spmm_segment import (  # noqa: E402
    SHORT_ROW, tile_plan)
from repro_torch.data import graphgen  # noqa: E402
from repro_torch.data.sampler import (DRAW_HIGH,  # noqa: E402
                                      gather_block_features, sample_block)
from repro_torch.models import gnn, recsys  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.data.tokens import lm_batch  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch import count as launch_count  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, roofline  # noqa: E402
from repro_torch.examples import bfs_traversal as ex_bfs  # noqa: E402
from repro_torch.examples import gnn_reddit as ex_gnn  # noqa: E402
from repro_torch.examples import quickstart as ex_quickstart  # noqa: E402
from repro_torch.examples import recsys_serve as ex_recsys  # noqa: E402
from repro_torch.examples import train_lm as ex_train_lm  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.distributed.fault_tolerance import \
    StragglerMonitor  # noqa: E402
from repro_torch.distributed.spawn import init_default_group  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim.tree import leaves as tree_leaves  # noqa: E402
from repro_torch.optim.tree import tree_map, value_and_grad  # noqa: E402
from repro_torch.planner import (DEFAULT_CONSTANTS,  # noqa: E402
                                 ServingSession, admit_roots, calibrate,
                                 explain, explain_analyze, explain_json,
                                 paper_listing, plan, plan_and_run,
                                 weighted_listing)
from repro_torch.planner.optimize import \
    bucket_roots as plan_buckets  # noqa: E402

# the posdb-bfs deployment (src/repro/configs/posdb_bfs.py), on one card:
# frontier_cap is 2^18 instead of the config's per-shard 2^15, because the
# widest level of this tree emits 155,901 edges
SPEC = TreeSpec(num_vertices=1 << 20, height=16, payload_cols=8, seed=0)
MAX_DEPTH = 16
CAPS = EngineCaps(frontier=1 << 18, result=1 << 20)
ROOT_SEED = 1
DEVICE = "cuda"                # the card
HBM_BYTES_PER_S = roofline.HBM_BW        # H100 SXM data sheet
FP32_OPS_PER_S = roofline.FP32_FLOPS     # the same, float32 off the
#                                          tensor cores
TIMING_REPS = 20
PROFILE_TRIES = 8              # sessions taken while one loses its events
DENSE_ENGINES = ("bitmap", "hybrid", "diropt", "diropt_hybrid")
FORCE_PULL = dict(alpha=1e9, beta=1e9)
SEMIRINGS = ("shortest_path", "aggregate_sum", "aggregate_max",
             "aggregate_min", "aggregate_mul")
WEIGHT_COL = "w"
SPMM_TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_semiring.py's
# of each bag's sum of absolute terms: the kernel sums a bag in sorted
# order, the plain version's index_add_ with atomics in no fixed order
BAG_TOL = 1e-5
# tests/test_models_gnn_recsys.py's tolerance between the reference's two
# DeepFM paths: sums over fields and the MLP's dot products run in another
# order on the card than on the CPU
DEEPFM_TOL = dict(rtol=2e-5, atol=2e-5)
P99_BATCH, P99_REQUESTS = RECSYS_SHAPES["serve_p99"]["batch"], 8
BULK_BATCH = RECSYS_SHAPES["serve_bulk"]["batch"]
N_CANDIDATES = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
PARAM_SEED = 0
NEG_SEED = 4                 # the negative positions of late_gather's checks
BATCH_ROOTS = 8              # benchmarks/exp1_bfs.py's lockstep batch
BUCKET_ROOTS = 32            # one serving bucket of the reference's planner
TRAVERSAL_KERNELS = ("frontier_expand", "frontier_pull")
# the kernels a batch calls once a level for all lanes
LEVEL_KERNELS = TRAVERSAL_KERNELS + ("spmm_segment",)
SPMM_LANE_DIMS = (1, 17)       # the widths of the lane-axis tile cases
BATCH_ENGINES = ("precursive",) + DENSE_ENGINES   # the reach batches
# the engines whose plan has a CSRIndexJoin, so frontier_expand each level
INDEX_JOIN_ENGINES = ("precursive", "trecursive", "trecursive_rewrite",
                      "rowstore_index", "rowstore_index_rewrite")
# the paper's Exp 1-3 (benchmarks/exp1_bfs.py, exp2_payload.py and
# exp3_rewrite.py; Fig. 5-7): the engines, the payload columns of the
# table and the engine each speedup is read against.  Exp 1's table is
# the deployment's tree with no payload column.
EXPERIMENTS = (
    ("exp1", "Fig. 5", ("precursive", "trecursive", "rowstore",
                        "rowstore_index", "bitmap", "hybrid"), 0,
     "rowstore"),
    ("exp2", "Fig. 6", ("precursive", "trecursive", "rowstore"), 8,
     "rowstore"),
    ("exp3", "Fig. 7", ("precursive", "trecursive_rewrite",
                        "rowstore_rewrite", "rowstore_index_rewrite"), 8,
     "rowstore_rewrite"),
)


class Request(NamedTuple):
    engine: str
    direction: str
    root: int
    workload: str = "reach"

    def __str__(self) -> str:
        label = f"{self.engine} {self.direction} root {self.root}"
        return label if self.workload == "reach" else \
            f"{label} {self.workload}"


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over TIMING_REPS runs, CUDA events
    around each run, with the 50 MB L2 evicted before each (a 256 MB
    write), so each run finds its inputs in device memory as the main path
    does."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(TIMING_REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes: float, fp32_ops: float = 0.0) -> float:
    """The larger of the bytes over the memory rate and the float32
    operations over the card's float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, fp32_ops / FP32_OPS_PER_S) * 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# the requests and their checks
# ---------------------------------------------------------------------------

def make_requests(cols: dict, num_vertices: int) -> list[Request]:
    """PRecursive: root 0, three depth-1 vertices and four seeded random
    roots outbound; the deepest vertex inbound and both ways."""
    children = cols["to"][cols["from"] == 0][:3]
    out = [0, *children.tolist(), *random_roots(num_vertices)]
    last = num_vertices - 1
    return ([Request("precursive", "outbound", int(r)) for r in out]
            + [Request("precursive", "inbound", last),
               Request("precursive", "both", last)])


def random_roots(num_vertices: int) -> list[int]:
    return np.random.default_rng(ROOT_SEED).integers(
        0, num_vertices, 4).tolist()


def make_dense_requests(cols: dict, num_vertices: int) -> list[Request]:
    """Each dense engine: root 0 (the whole tree, both sides of the
    switch) and one depth-1 vertex outbound, the deepest vertex inbound
    and both ways."""
    child = int(cols["to"][cols["from"] == 0][0])
    last = num_vertices - 1
    return [Request(engine, direction, root) for engine in DENSE_ENGINES
            for direction, root in (("outbound", 0), ("outbound", child),
                                    ("inbound", last), ("both", last))]


def make_weighted_requests(num_vertices: int) -> list[Request]:
    """Weighted ``precursive``: root 0 outbound under each semiring,
    shortest path from the deepest vertex inbound and both ways and from
    the four random roots outbound.  Weighted ``bitmap``: root 0 outbound
    under each semiring, shortest path and aggregate_sum from the deepest
    vertex inbound.  The bitmap aggregate_sum requests run spmm_segment."""
    last = num_vertices - 1
    sp = "shortest_path"
    return ([Request("precursive", "outbound", 0, s) for s in SEMIRINGS]
            + [Request("precursive", "inbound", last, sp),
               Request("precursive", "both", last, sp)]
            + [Request("precursive", "outbound", r, sp)
               for r in random_roots(num_vertices)]
            + [Request("bitmap", "outbound", 0, s) for s in SEMIRINGS]
            + [Request("bitmap", "inbound", last, sp),
               Request("bitmap", "inbound", last, "aggregate_sum")])


def make_paper_requests(num_vertices: int) -> list[Request]:
    """Each of the paper's tuple-based and row-store engines from root 0
    outbound; the two tuple engines also from the deepest vertex inbound
    and both ways (the row store is outbound-only)."""
    last = num_vertices - 1
    return ([Request(engine, "outbound", 0) for engine in VALUE_ENGINE_NAMES]
            + [Request(engine, direction, last)
               for engine in ("trecursive", "trecursive_rewrite")
               for direction in ("inbound", "both")])


def query(engine: str, direction: str = "outbound",
          workload: str = "reach",
          payload_cols: int = SPEC.payload_cols) -> RecursiveQuery:
    return RecursiveQuery(engine, MAX_DEPTH, payload_cols, CAPS,
                          direction=direction, workload=workload,
                          weight_col=None if workload == "reach"
                          else WEIGHT_COL)


def run_request(ds, req: Request):
    return run_query(query(req.engine, req.direction, req.workload), ds,
                     req.root)


def run_requests(ds, requests) -> list:
    return [run_request(ds, req) for req in requests]


KERNEL_OPS = {"frontier_expand": fe_ops, "late_gather": lg_ops,
              "frontier_pull": fp_ops, "spmm_segment": spmm_ops,
              "embedding_bag": eb_ops}


def reset_launches() -> None:
    for ops in KERNEL_OPS.values():
        ops.LAUNCHES = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: ops.LAUNCHES for name, ops in KERNEL_OPS.items()}


def launch_levels(req: Request, r, num_vertices: int) -> dict:
    """The levels at which the card's run of one request calls each
    per-level kernel, read off a run's result: ``frontier_expand`` at
    every executed level of PRecursive (weighted or not) and of the tuple
    and row-store engines with an IndexJoin, and at each
    sparse (positional) push level of the hybrid engines,
    ``frontier_pull`` at each pull level, both only outside the fused
    ``both`` view (which has no kernel, as in the reference);
    ``spmm_segment`` at every executed level of a ``bitmap`` aggregate_sum
    request.  A hybrid level is sparse when its frontier block, the rows
    first emitted at that level, is below :func:`hybrid_threshold`."""
    engine, depth = req.engine, int(r.depth)
    out = {"frontier_expand": set(), "frontier_pull": set(),
           "spmm_segment": set()}
    if req.workload == "aggregate_sum" and engine == "bitmap":
        out["spmm_segment"] = set(range(depth))
    if req.direction == "both":
        return out
    if engine in INDEX_JOIN_ENGINES:
        out["frontier_expand"] = set(range(depth))
        return out
    dirs = (r.level_dirs.tolist() if r.level_dirs is not None
            else [0] * depth)
    widths = torch.bincount(r.row_depths[:int(r.count)].long(),
                            minlength=depth).tolist()
    for d in range(depth):
        if dirs[d] == 1:
            out["frontier_pull"].add(d)
        elif engine in ("hybrid", "diropt_hybrid") and \
                widths[d] < hybrid_threshold(engine, num_vertices):
            out["frontier_expand"].add(d)
    return out


def late_gathers(req: Request, r) -> int:
    """``late_gather`` launches of one request: one take of all its output
    columns; on the tuple and row-store engines one take a level and one
    for the seed block (``EarlyMaterialize``, up to 32 columns a launch),
    and one more for an Exp-3 rewrite's top-level join."""
    if req.engine not in VALUE_ENGINE_NAMES:
        return 1
    return int(r.depth) + 1 + req.engine.endswith("_rewrite")


def expected_launches(requests, results, num_vertices: int) -> dict:
    """The launches the card's run of ``requests`` must make, read off the
    CPU run's results: each per-level kernel once per level of
    :func:`launch_levels`; ``late_gather`` as :func:`late_gathers` says;
    ``embedding_bag`` never."""
    out = {"frontier_expand": 0,
           "late_gather": sum(late_gathers(req, r)
                              for req, r in zip(requests, results)),
           "frontier_pull": 0, "spmm_segment": 0, "embedding_bag": 0}
    for req, r in zip(requests, results):
        for kernel, levels in launch_levels(req, r, num_vertices).items():
            out[kernel] += len(levels)
    return out


def hybrid_threshold(engine: str, num_vertices: int) -> int:
    """The frontier size below which the engine's ``HybridStep`` (alone,
    or the push side of its ``DirectionSwitch``) takes its sparse branch,
    read off the plan ``run_query`` builds."""
    step = build_plan(query(engine)).ops[0]
    step = getattr(step, "push", step)
    return max(1, int(num_vertices * step.switch_frac))


def require_equal(a, b, label: str, other: str = "the CPU run") -> None:
    """Field-for-field, bit-for-bit equality of two BFSResults, compared
    on ``a``'s device."""
    for field in ("positions", "count", "depth", "overflow", "row_depths",
                  "level_dirs", "vertex_values"):
        x, y = getattr(a, field), getattr(b, field)
        if x is None or y is None:
            require(x is None and y is None, f"{label}: field {field}")
            continue
        y = y.to(x.device)
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"{label}: field {field} differs from {other}")
    require(a.values.keys() == b.values.keys(), f"{label}: value columns")
    for k in a.values:
        x = a.values[k]
        y = b.values[k].to(x.device)
        require(x.dtype == y.dtype and torch.equal(x, y),
                f"{label}: column {k} differs from {other}")


def require_same_rows(a, b, label: str,
                      other: str = "the push-only engine") -> None:
    """The rows, their order and depths, and the loop accounting of two
    results (a direction-optimizing engine and its push-only twin, or an
    MS-BFS lane and ``diropt`` on its root)."""
    for field in ("positions", "count", "depth", "overflow", "row_depths"):
        require(torch.equal(getattr(a, field), getattr(b, field)),
                f"{label}: field {field} differs from {other}")
    require(a.values.keys() == b.values.keys(), f"{label}: value columns")
    for k in a.values:
        require(torch.equal(a.values[k], b.values[k]),
                f"{label}: column {k} differs from {other}")


def check_result_shape(r, caps: EngineCaps, label: str) -> None:
    require(r.positions.shape == (caps.result,), f"{label}: positions shape")
    for k, v in r.values.items():
        require(v.shape[0] == caps.result, f"{label}: column {k} shape")
        if v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f"{label}: {k} not finite")


def real_positions(engine: str, r, id_to_pos: torch.Tensor
                   ) -> torch.Tensor:
    """The edge positions of a result's rows: its positions, or, where the
    engine's recursion carried values (positions all -1), the rows' ids
    (float32 on the row store, exact below 2^24) mapped back to positions
    through ``id_to_pos``, the inverse of the table's id column."""
    if positions_available(engine):
        return r.positions
    ids = r.values["id"].cpu().long().clamp(0, id_to_pos.shape[0] - 1)
    return id_to_pos[ids]


def check_root0(r, levels: list, spec: TreeSpec, label: str,
                positions: torch.Tensor | None = None) -> None:
    """Root 0 reaches the whole tree without overflow, level by level equal
    to the pure-Python BFS oracle's ``levels``; ``positions`` are the rows'
    edge positions (by default the result's)."""
    count = int(r.count)
    require(count == spec.num_edges,
            f"{label}: count {count} != {spec.num_edges}")
    require(not bool(r.overflow), f"{label} overflowed")
    positions = r.positions if positions is None else positions
    pos = positions[:count].cpu().numpy()
    depth = r.row_depths[:count].cpu().numpy()
    for d, want in enumerate(levels):
        require(set(pos[depth == d].tolist()) == want,
                f"{label}: level {d} differs from bfs_reference")
    require(int(depth.max()) + 1 == len([s for s in levels if s]),
            f"{label}: extra levels")


def widest_level(r0, cols: dict, capacity: int):
    """The targets of the widest level of root 0's traversal, in the
    frontier order the engine gives them (the previous level's rows in
    emission order), padded to ``capacity``: a real input of the
    expansion.  Returns (targets, valid, level, emitted) on the CPU."""
    count = int(r0.count)
    pos = r0.positions[:count].cpu().numpy()
    depth = r0.row_depths[:count].cpu().numpy()
    widths = np.bincount(depth)
    level = int(np.argmax(widths[1:])) + 1
    prev = cols["to"][pos[depth == level - 1]]
    targets = torch.full((capacity,), -1, dtype=torch.int32)
    targets[:prev.shape[0]] = torch.from_numpy(prev.astype(np.int32))
    valid = torch.arange(capacity) < prev.shape[0]
    return targets, valid, level, int(widths[level])


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions, at the main path's shapes
# ---------------------------------------------------------------------------

def device_events(prof) -> list:
    """The device-side entries (kernels, copies, fills) of a profiler
    session's ``key_averages()``."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def profiled(run, enough) -> list:
    """The device events of a ``torch.profiler`` session around ``run()``.
    The session records device activity only: the host ops are not read,
    and summing them costs the session most of its time.  On this card a
    session sometimes loses some or all of its device events (PERF.md §7)
    and never gains one, so a session is taken again, up to
    PROFILE_TRIES times, until ``enough(events)``; the fullest one is
    returned."""
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = device_events(prof)
        if best is None or sum(e.count for e in events) > \
                sum(e.count for e in best):
            best = events
        if enough(best):
            break
    return best


def device_profile(fn, flush, launches: int) -> tuple[int, dict]:
    """The device launches of one call of ``fn`` (sessions taken until one
    sees ``launches``, so a call that makes more still shows more), and
    the mean device time of each of its kernels, by the profiler's name,
    over TIMING_REPS calls with the L2 evicted before each, from
    ``torch.profiler``.  Run after the profile lines: an earlier profiler
    session changes their event counts."""
    fn()
    torch.cuda.synchronize()
    events = profiled(fn, lambda ev: sum(e.count for e in ev) >= launches)
    keys = {e.key for e in events}         # not the L2 flush's fill

    def reps():
        for _ in range(TIMING_REPS):
            flush.zero_()
            fn()

    timed = profiled(reps, lambda ev: keys <= {e.key for e in ev})
    return sum(e.count for e in events), {
        e.key: e.self_device_time_total / e.count / 1e3
        for e in timed if e.key in keys}


def kernel_times(by_key: dict, names, label: str) -> dict:
    """Each of ``names``' mean ms from :func:`device_profile`'s keys (one
    key each)."""
    found = {n: [ms for key, ms in by_key.items() if n in key]
             for n in names}
    require(all(len(ms) == 1 for ms in found.values()),
            f"{label}: the profiler's kernels {sorted(by_key)}")
    return {n: ms[0] for n, ms in found.items()}


def expand_profile(fn, flush) -> dict:
    """``frontier_expand``'s device launches per call (3) and the mean
    time of each of its kernels."""
    launches, by_key = device_profile(fn, flush, 3)
    require(launches == 3, f"frontier_expand: {launches} device launches "
            "in one call, want 3")
    by_kernel = kernel_times(by_key, ("frontier_degree_sums",
                                      "frontier_scan_ends",
                                      "frontier_expand_slots"),
                             "frontier_expand")
    return {"expand_only_ms": by_kernel["frontier_expand_slots"],
            "device_launches_per_call": launches,
            "device_ms_by_kernel": by_kernel}


SPMM_KERNELS = ("spmm_segment_rows", "spmm_segment_hub_fixup")


def spmm_profile(calls: dict, flush) -> dict:
    """``spmm_segment``'s device launches per call and the mean time of
    each of its two kernels at each case of ``calls`` (each has E > H, so
    both run)."""
    out = {}
    for case, fn in calls.items():
        launches, by_key = device_profile(fn, flush, 2)
        require(launches == 2, f"spmm_segment ({case}): {launches} device "
                "launches in one call, want 2")
        out[case] = {"device_launches_per_call": launches,
                     "device_ms_by_kernel": kernel_times(
                         by_key, SPMM_KERNELS, f"spmm_segment ({case})")}
    return out


def expand_cases_on_card() -> dict:
    """Each :func:`expand_case` on the card: the kernel route bit-equal to
    the plain version in all three outputs.  Returns each case's F,
    capacity, count and overflow."""
    cases = {}
    for case in EXPAND_CASES:
        src, v, targets, valid, capacity = expand_case(case)
        csr = build_csr(torch.from_numpy(src).to(DEVICE), v)
        t = torch.from_numpy(targets).to(DEVICE)
        m = torch.from_numpy(valid).to(DEVICE)
        got = fe_ops.frontier_expand_fused(csr, t, m, capacity)
        want = expand_frontier(csr, t, m, capacity)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("positions", "total", "overflow")):
            require(g.dtype == w.dtype and g.shape == w.shape
                    and torch.equal(g, w),
                    f"frontier_expand case {case}: {name} differs")
        cases[case] = {"F": targets.shape[0], "capacity": capacity,
                       "count": int(got[1]), "overflow": bool(got[2])}
    return cases


def frontier_expand_phase(ds, targets, valid, capacity, emitted, flush):
    """Root 0's widest level (the kernel line's entry) and the tile cases,
    each bit-equal to the plain version; then the wrapper's and the plain
    version's times at the widest level.  Returns the entry, the cases and
    the widest level's call, for :func:`expand_profile`."""
    csr = ds.csr
    t, v = targets.to(DEVICE), valid.to(DEVICE)
    got = fe_ops.frontier_expand_fused(csr, t, v, capacity)
    want = expand_frontier(csr, t, v, capacity)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("positions", "total", "overflow")):
        require(g.dtype == w.dtype and torch.equal(g, w),
                f"frontier_expand: {name} differs")
    require(int(got[1]) == emitted, "frontier_expand: level total")
    err = max_abs_err(got[0], want[0])
    cases = expand_cases_on_card()

    def call():
        return fe_ops.frontier_expand_fused(csr, t, v, capacity)

    f, live = t.shape[0], int(v.sum())
    # targets + valid read once, two indptr entries per live target, the
    # reached perm entries, the (capacity,) output written once
    nbytes = f * 5 + live * 8 + min(emitted, capacity) * 4 + capacity * 4
    entry = {
        "name": "frontier_expand", "route": "cuda",
        "source": "src/repro_torch/csrc/frontier_expand.cu",
        "replaces": "src/repro/kernels/frontier_expand/frontier_expand.py:84",
        "max_abs_err": err,
        "ms": time_ms(call, flush),
        "plain_ms": time_ms(lambda: expand_frontier(csr, t, v, capacity),
                            flush),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None,
        "shape": f"F={f} capacity={capacity} live={live} "
                 f"emitted={emitted} E={csr.num_edges}",
    }
    return entry, cases, call


def with_negatives(positions: torch.Tensor, num_rows: int) -> torch.Tensor:
    """A copy of ``positions`` with every 64th replaced by a negative from
    a numpy seed: in [-R, 0), which counts from the end once, and every
    16th of those below -R, which gives a zero row."""
    rng = np.random.default_rng(NEG_SEED)
    out = positions.clone()
    n = out[::64].numel()
    neg = -rng.integers(1, num_rows + 1, n)
    neg[::16] = -num_rows - 1 - rng.integers(0, 1000, neg[::16].shape[0])
    out[::64] = torch.from_numpy(neg.astype(np.int32)).to(out.device)
    return out


def late_gather_case(tables: list, positions: torch.Tensor, flush) -> dict:
    """``late_gather_columns`` on ``tables`` held bit-equal to the plain
    version at ``positions`` and at :func:`with_negatives` of them, then
    timed at ``positions``.  ``library_ms`` is ``index_select``'s time for
    one table; for several, no single call computes the function, and
    ``index_select_sum_ms`` adds the per-column ``index_select`` times."""
    r = tables[0].shape[0]
    for pos in (positions, with_negatives(positions, r)):
        got = lg_ops.late_gather_columns(tables, pos)
        want = late_gather_columns_ref(tables, pos)
        torch.cuda.synchronize()
        for g, w, t in zip(got, want, tables):
            require(g.dtype == w.dtype and g.shape == w.shape and torch.equal(
                g.view(torch.uint8), w.view(torch.uint8)),
                f"late_gather {t.dtype} {tuple(t.shape)} differs")
    p = positions.shape[0]
    wrapped = torch.where(positions < 0, positions.long() + r,
                          positions.long())
    in_range = (wrapped >= 0) & (wrapped < r)
    live = int(in_range.sum())
    rows = int(torch.unique(wrapped[in_range]).numel())
    row_bytes = sum(t.shape[1] * t.element_size() for t in tables)
    safe = wrapped.clamp(0, r - 1)
    selects = [time_ms(lambda t=t: torch.index_select(t, 0, safe), flush)
               for t in tables]
    case = {
        "max_abs_err": max(max_abs_err(g, w) for g, w in zip(got, want)),
        "ms": time_ms(lambda: lg_ops.late_gather_columns(tables, positions),
                      flush),
        "plain_ms": time_ms(lambda: late_gather_columns_ref(tables,
                                                            positions),
                            flush),
        "library_ms": selects[0] if len(tables) == 1 else None,
        # positions read once, each distinct live row of each column read
        # once, every output row written once
        "bound_ms": bound_ms(p * 4 + rows * row_bytes + p * row_bytes),
        "bound_by": "bytes",
        "shape": (f"R={r} P={p} live={live} rows={rows} columns="
                  + ",".join(f"{str(t.dtype)[6:]}x{t.shape[1]}"
                             for t in tables)),
    }
    if len(tables) > 1:
        case["index_select_sum_ms"] = sum(selects)
    return case


def late_gather_phase(ds, positions, out_cols, flush):
    """Root 0's result positions: all the query's output columns in one
    take (the main path's call, and the kernel line's entry), and the
    f32, int32 and bf16 one-column cases."""
    table = ds.table
    payload = table.column("column1")
    cases = {
        "columns": late_gather_case(
            [table.column(n).reshape(table.num_rows, -1) for n in out_cols],
            positions, flush),
        "f32": late_gather_case([payload], positions, flush),
        "int32": late_gather_case([table.column("id")[:, None]], positions,
                                  flush),
        "bf16": late_gather_case([payload.to(torch.bfloat16)], positions,
                                 flush),
    }
    entry = {
        "name": "late_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/late_gather.cu",
        "replaces": "src/repro/kernels/late_gather/late_gather.py:34",
        **cases["columns"],
    }
    return entry, cases


def pull_input(r, cols: dict, num_vertices: int):
    """The first pull level of a root-0 ``diropt`` run, rebuilt from its
    rows (the vertex reached by a row has the row's depth + 1): its (V,)
    frontier and visited masks on the CPU, and the level."""
    count = int(r.count)
    pos = r.positions[:count].long()
    vd = torch.full((num_vertices,), -1, dtype=torch.int32)
    vd[0] = 0
    vd[torch.from_numpy(cols["to"])[pos].long()] = r.row_depths[:count] + 1
    level = r.level_dirs.tolist().index(1)
    return vd == level, (vd >= 0) & (vd <= level), level


def walk_bytes(layout, f: torch.Tensor, v: torch.Tensor) -> int:
    """The bytes the layout route can not avoid (``layout_bound_ms``):
    ``visited`` and the output (V each), and for each unvisited vertex with
    an in-entry its two ``ptr`` words, then one ``nbr`` word and one
    frontier byte for each entry of its row up to its first hit (the whole
    row when none hits; one entry at the main shape, where every vertex
    has one in-entry)."""
    nv, e = f.shape[0], layout.num_edges
    ptr = layout.ptr.long()
    deg = ptr[1:] - ptr[:-1]
    open_rows = ~v & (deg > 0)
    owner = torch.repeat_interleave(torch.arange(nv, device=f.device), deg)
    rank = torch.arange(e, device=f.device) - ptr[owner]
    first = deg.clone().scatter_reduce_(
        0, owner, torch.where(f[layout.nbr], rank, deg[owner]), "amin")
    read = torch.minimum(first + 1, deg)[open_rows]
    return 2 * nv + int(open_rows.sum()) * 8 + int(read.sum()) * 5


def frontier_pull_shape(ctx, f: torch.Tensor, v: torch.Tensor, flush):
    """``frontier_pull`` at one shape of a direction's join view: the
    kernel over the dataset's layout (``ms``, the per-level call) and
    without it (``wrapper_ms``, which builds a layout in the call) held
    bit-equal to both plain versions.  ``bound_ms`` (also printed as
    ``layout_bound_ms``) counts what the timed call needs, from
    :func:`walk_bytes`; ``entry_bound_ms`` keeps the per-entry kernel's
    count (perm and join_dst in full, visited, join_src and the frontier
    bytes that the open entries need, the output), which the layout call
    does not read.  Returns the numbers and the per-level call."""
    rcsr, src, dst, layout = ctx.rcsr, ctx.join_src, ctx.join_dst, \
        ctx.pull_layout
    require(layout is not None, "the dataset built no pull layout")

    def call():
        return fp_ops.frontier_pull_fused(rcsr, src, dst, f, v,
                                          layout=layout)

    def wrapper():
        return fp_ops.frontier_pull_fused(rcsr, src, dst, f, v)

    want = frontier_pull_ref(rcsr, src, dst, f, v)
    got = call()
    for g, what in ((got, "the kernel"), (wrapper(), "the wrapper"),
                    (frontier_pull_layout_ref(layout, f, v),
                     "the layout's plain version")):
        torch.cuda.synchronize()
        require(g.dtype == want.dtype and torch.equal(g, want),
                f"frontier_pull: {what} differs from the plain version")
    e, nv = rcsr.num_edges, f.shape[0]
    vtx = dst[rcsr.perm].clamp(0, nv - 1)
    nbr = src[rcsr.perm].clamp(0, nv - 1)
    open_entries = ~v[vtx]
    pending = int(open_entries.sum())
    needed = int(torch.unique(nbr[open_entries]).numel())
    nbytes = e * 4 + e * 4 + nv + pending * 4 + needed + nv
    walk_ms = bound_ms(walk_bytes(layout, f, v))
    return {
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(call, flush),
        "wrapper_ms": time_ms(wrapper, flush),
        "plain_ms": time_ms(lambda: frontier_pull_ref(rcsr, src, dst, f, v),
                            flush),
        "bound_ms": walk_ms,
        "layout_bound_ms": walk_ms,
        "entry_bound_ms": bound_ms(nbytes),
        "bound_by": "bytes",
        "library_ms": None,
        "shape": f"E={e} V={nv} frontier={int(f.sum())} "
                 f"unvisited={int((~v).sum())} open_entries={pending} "
                 f"needed={needed} tiles={layout.tile_vtx.shape[0]} "
                 f"next={int(got.sum())}",
    }, call


def hub_input(ds):
    """The inbound view's hub, vertex 0 (83,619 entries): unvisited, with
    its last in-neighbor the only frontier vertex and every other vertex
    visited, so its tiles are read to the end."""
    layout = ds.context("inbound").pull_layout
    last = int(layout.nbr[int(layout.ptr[1]) - 1])
    f = torch.zeros((ds.num_vertices,), dtype=torch.bool, device=DEVICE)
    f[last] = True
    v = torch.ones_like(f)
    v[0] = False
    return f, v


def pull_cases_on_card() -> dict:
    """Each :func:`pull_case` on the card: the kernel over a layout built
    there, and the wrapper building its own, bit-equal to the plain
    version.  Returns each case's V, E, tiles and next-frontier size."""
    cases = {}
    for case in PULL_CASES:
        src, dst, frontier, visited = (torch.from_numpy(a).to(DEVICE)
                                       for a in pull_case(case))
        nv = frontier.shape[0]
        rcsr = build_csr(dst, nv)
        layout = build_pull_layout(rcsr, src, dst, nv)
        want = frontier_pull_ref(rcsr, src, dst, frontier, visited)
        for got in (fp_ops.frontier_pull_fused(rcsr, src, dst, frontier,
                                               visited, layout=layout),
                    fp_ops.frontier_pull_fused(rcsr, src, dst, frontier,
                                               visited)):
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"frontier_pull case {case}: differs")
        cases[case] = {"V": nv, "E": layout.num_edges,
                       "tiles": layout.tile_vtx.shape[0],
                       "next": int(want.sum())}
    return cases


def frontier_pull_phase(ds, frontier, visited, level, flush):
    """The first pull level of ``diropt`` root 0 (the kernel line's entry),
    the inbound view's hub and the shared cases, each bit-equal to the
    plain version.  Returns the entry, the cases and each shape's call,
    for :func:`pull_profile`."""
    ds.ensure_pull_layout("outbound")
    ds.ensure_pull_layout("inbound")
    main, main_call = frontier_pull_shape(
        ds.context("outbound"), frontier.to(DEVICE), visited.to(DEVICE),
        flush)
    main["shape"] = f"level={level} " + main["shape"]
    hub, hub_call = frontier_pull_shape(ds.context("inbound"),
                                        *hub_input(ds), flush)
    nxt = hub_call()
    require(bool(nxt[0]) and int(nxt.sum()) == 1,
            "frontier_pull hub: the next frontier is not vertex 0 alone")
    entry = {
        "name": "frontier_pull", "route": "cuda",
        "source": "src/repro_torch/csrc/frontier_pull.cu",
        "replaces": "src/repro/kernels/frontier_pull/frontier_pull.py:60",
        **main, "hub": hub,
    }
    return entry, pull_cases_on_card(), {"main": main_call, "hub": hub_call}


PULL_KERNELS = ("frontier_pull_rows", "frontier_pull_tiles")


def pull_profile(calls: dict, flush) -> dict:
    """``frontier_pull``'s device launches per call (1 at the main shape,
    whose layout has no hub tile; 2 at the hub) and the mean time of each
    kernel, with no memset among the device events."""
    out = {}
    for (case, fn), kernels in zip(calls.items(), (1, 2)):
        launches, by_key = device_profile(fn, flush, kernels)
        require(launches == kernels and not any(
            "memset" in k.lower() for k in by_key),
            f"frontier_pull ({case}): {launches} device launches "
            f"{sorted(by_key)}, want {kernels} and no memset")
        out[case] = {"device_launches_per_call": launches,
                     "device_ms_by_kernel": kernel_times(
                         by_key, PULL_KERNELS[:kernels],
                         f"frontier_pull ({case})")}
    return out


def batch_roots(cols: dict, num_vertices: int) -> list[int]:
    """BATCH_ROOTS roots: PRecursive's outbound single-root requests (root
    0, the three depth-1 vertices, the four random roots)."""
    return [req.root for req in make_requests(cols, num_vertices)
            if req.direction == "outbound"]


def lane_targets(results, cols: dict, level: int, capacity: int):
    """Each lane's targets at ``level`` of its own traversal, as
    :func:`widest_level` builds them for root 0: the ``to`` of the lane's
    rows of level - 1 in emission order, padded to ``capacity``.  Returns
    (targets (L, capacity), valid (L, capacity), each lane's rows at
    ``level``) on the CPU."""
    targets = torch.full((len(results), capacity), -1, dtype=torch.int32)
    valid = torch.zeros((len(results), capacity), dtype=torch.bool)
    emitted = []
    for i, r in enumerate(results):
        count = int(r.count)
        pos = r.positions[:count].cpu().numpy()
        depth = r.row_depths[:count].cpu().numpy()
        prev = cols["to"][pos[depth == level - 1]]
        targets[i, :prev.shape[0]] = torch.from_numpy(prev.astype(np.int32))
        valid[i, :prev.shape[0]] = True
        emitted.append(int((depth == level).sum()))
    return targets, valid, emitted


def expand_lane_cases_on_card() -> dict:
    """Each :func:`expand_lanes_case` (a tile case stacked as four lanes:
    itself, an empty lane, itself reversed, every other target) on the
    card: one call bit-equal to the plain version on every lane.  Returns
    each case's per-lane counts and overflow flags and the call's ms."""
    cases = {}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    for case in EXPAND_CASES:
        src, v, targets, valid, capacity = expand_lanes_case(case)
        csr = build_csr(torch.from_numpy(src).to(DEVICE), v)
        t = torch.from_numpy(targets.copy()).to(DEVICE)
        m = torch.from_numpy(valid.copy()).to(DEVICE)
        got = fe_ops.frontier_expand_fused(csr, t, m, capacity)
        want = expand_frontier(csr, t, m, capacity)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("positions", "total", "overflow")):
            require(g.dtype == w.dtype and g.shape == w.shape
                    and torch.equal(g, w),
                    f"frontier_expand lane case {case}: {name} differs")
        cases[case] = {"count": got[1].tolist(), "overflow": got[2].tolist(),
                       "ms": time_ms(lambda: fe_ops.frontier_expand_fused(
                           csr, t, m, capacity), flush)}
    return cases


def frontier_expand_lane_phase(ds, targets, valid, capacity, emitted,
                               flush):
    """The lane axis at the widest level of root 0's batch: the
    BATCH_ROOTS lanes' targets at that level in one call, bit-equal to the
    plain version and to each lane's one-lane call, then timed beside the
    plain version and the one-lane calls one after another.  Returns the
    numbers, the stacked cases and the call, for :func:`expand_profile`."""
    csr = ds.csr
    t, v = targets.to(DEVICE), valid.to(DEVICE)
    lanes = t.shape[0]
    got = fe_ops.frontier_expand_fused(csr, t, v, capacity)
    want = expand_frontier(csr, t, v, capacity)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("positions", "total", "overflow")):
        require(g.dtype == w.dtype and torch.equal(g, w),
                f"frontier_expand lanes: {name} differs")
    require(got[1].tolist() == [min(n, capacity) for n in emitted],
            "frontier_expand lanes: level totals")
    rows = [(t[i].contiguous(), v[i].contiguous()) for i in range(lanes)]
    for i, (ti, vi) in enumerate(rows):
        one = fe_ops.frontier_expand_fused(csr, ti, vi, capacity)
        require(all(torch.equal(g[i], o) for g, o in zip(got, one)),
                f"frontier_expand lanes: lane {i} differs from its own call")

    def call():
        return fe_ops.frontier_expand_fused(csr, t, v, capacity)

    def per_lane_calls():
        for ti, vi in rows:
            fe_ops.frontier_expand_fused(csr, ti, vi, capacity)

    live = v.sum(-1).tolist()
    nbytes = sum(t.shape[1] * 5 + n * 8 + min(e, capacity) * 4 + capacity * 4
                 for n, e in zip(live, emitted))
    entry = {
        "lanes": lanes, "max_abs_err": max_abs_err(got[0], want[0]),
        "ms": time_ms(call, flush),
        "per_lane_calls_ms": time_ms(per_lane_calls, flush),
        "plain_ms": time_ms(lambda: expand_frontier(csr, t, v, capacity),
                            flush),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None,
        "shape": f"L={lanes} F={t.shape[1]} capacity={capacity} "
                 f"live={live} emitted={emitted}",
    }
    return entry, expand_lane_cases_on_card(), call


def pull_lane_input(results, roots, cols: dict, num_vertices: int,
                    level: int):
    """Each lane's (V,) frontier and visited masks at ``level`` of its own
    traversal, rebuilt from its rows as :func:`pull_input` rebuilds root
    0's: (L, V) planes on the CPU."""
    to = torch.from_numpy(cols["to"])
    frontier, visited = [], []
    for r, root in zip(results, roots):
        count = int(r.count)
        pos = r.positions[:count].cpu().long()
        vd = torch.full((num_vertices,), -1, dtype=torch.int32)
        vd[root] = 0
        vd[to[pos].long()] = r.row_depths[:count].cpu() + 1
        frontier.append(vd == level)
        visited.append((vd >= 0) & (vd <= level))
    return torch.stack(frontier), torch.stack(visited)


def pull_lane_cases_on_card() -> dict:
    """Each :func:`pull_lanes_case` (a pull case stacked as four lanes:
    itself, an empty frontier, the frontier moved on by one, every other
    vertex open) on the card: one call bit-equal to the plain version on
    every lane.  Returns each case's next-frontier sizes and the call's
    ms."""
    cases = {}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    for case in PULL_CASES:
        src, dst, frontier, visited = (torch.from_numpy(a.copy()).to(DEVICE)
                                       for a in pull_lanes_case(case))
        nv = frontier.shape[-1]
        rcsr = build_csr(dst, nv)
        layout = build_pull_layout(rcsr, src, dst, nv)
        want = frontier_pull_ref(rcsr, src, dst, frontier, visited)

        def call():
            return fp_ops.frontier_pull_fused(rcsr, src, dst, frontier,
                                              visited, layout=layout)
        got = call()
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"frontier_pull lane case {case}: differs")
        cases[case] = {"next": got.sum(-1).tolist(),
                       "ms": time_ms(call, flush)}
    return cases


def frontier_pull_lane_phase(ds, frontier, visited, level, flush):
    """The lane axis at ``diropt`` root 0's first pull level: the
    BATCH_ROOTS lanes' (V,) planes at that level in one call over the one
    outbound layout, bit-equal to both plain versions and to each lane's
    one-lane call, then timed beside the plain version and the one-lane
    calls one after another.  ``bound_ms`` sums :func:`walk_bytes` over
    the lanes.  Returns the numbers, the stacked cases and the call."""
    ctx = ds.context("outbound")
    rcsr, src, dst, layout = ctx.rcsr, ctx.join_src, ctx.join_dst, \
        ctx.pull_layout
    f, v = frontier.to(DEVICE), visited.to(DEVICE)
    lanes = f.shape[0]

    def call():
        return fp_ops.frontier_pull_fused(rcsr, src, dst, f, v,
                                          layout=layout)

    rows = [(f[i].contiguous(), v[i].contiguous()) for i in range(lanes)]

    def per_lane_calls():
        for fi, vi in rows:
            fp_ops.frontier_pull_fused(rcsr, src, dst, fi, vi, layout=layout)

    want = frontier_pull_ref(rcsr, src, dst, f, v)
    got = call()
    torch.cuda.synchronize()
    require(torch.equal(got, want) and torch.equal(
        frontier_pull_layout_ref(layout, f, v), want),
        "frontier_pull lanes: differs from the plain versions")
    for i, (fi, vi) in enumerate(rows):
        require(torch.equal(got[i], fp_ops.frontier_pull_fused(
            rcsr, src, dst, fi, vi, layout=layout)),
            f"frontier_pull lanes: lane {i} differs from its own call")
    nbytes = sum(walk_bytes(layout, fi, vi) for fi, vi in rows)
    entry = {
        "lanes": lanes, "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(call, flush),
        "per_lane_calls_ms": time_ms(per_lane_calls, flush),
        "plain_ms": time_ms(lambda: frontier_pull_ref(rcsr, src, dst, f, v),
                            flush),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None,
        "shape": f"L={lanes} level={level} V={f.shape[1]} "
                 f"frontier={f.sum(-1).tolist()} "
                 f"unvisited={(~v).sum(-1).tolist()} "
                 f"next={got.sum(-1).tolist()} "
                 f"tiles={layout.tile_vtx.shape[0]}",
    }
    return entry, pull_lane_cases_on_card(), call


def spmm_case(x, src, dst, w, num_out: int, check: str, flush):
    """``spmm_segment`` against its plain version on the card, ``check``
    ``exact``, ``close`` (SPMM_TOL), ``scaled`` (within 1e-5 of each
    row's sum of absolute terms, for rows of thousands of edges) or
    ``f64`` (within 1e-5 of each row's sum of absolute terms of the plain
    version run in float64, for rows of 10^5 edges; the float32 plain
    version's errors against it print beside the kernel's).  ``ms`` is
    the call the engine makes each level (the kernel on edges already in
    destination order); ``wrapper_ms`` adds the wrapper's stable sort;
    ``library_ms`` is ``torch.sparse.mm`` of the (num_out x N) CSR matrix
    of the live edges' weights, built outside the timed region.  Returns
    the case's numbers and its kernel call, for :func:`spmm_profile`."""
    n, d = x.shape
    seg = spmm_ops.segments(dst, num_out)
    s_src, s_w = src[seg.order], w[seg.order]
    got = spmm_ops.spmm_segment_sorted(x, s_src, seg.seg, s_w, seg.offsets)
    via_wrapper = spmm_ops.spmm_segment(x, src, dst, w, num_out)
    want = spmm_segment_ref(x, src, dst, w, num_out)
    torch.cuda.synchronize()
    label = f"spmm_segment N={n} E={src.shape[0]} D={d}"
    require(torch.equal(got, via_wrapper), f"{label}: wrapper differs")
    require(got.shape == (num_out, d) and bool(got.isfinite().all()),
            f"{label}: shape {tuple(got.shape)} or a non-finite value")
    if check == "exact":
        require(torch.equal(got, want), f"{label} differs from its plain "
                                        f"version")
    elif check == "close":
        require(bool(torch.isclose(got, want, **SPMM_TOL).all()),
                f"{label} differs from its plain version beyond "
                f"{SPMM_TOL}")
    elif check == "scaled":
        scale = spmm_segment_ref(x.abs(), src, dst, w.abs(), num_out)
        require(bool(((got - want).abs() <= 1e-5 * scale + 1e-5).all()),
                f"{label} differs from its plain version beyond 1e-5 of "
                f"the rows' absolute sums")
    else:
        # the plain version in float64 on the same tensors: a float32 sum
        # of one row's 10^5 non-negative terms by atomics drifts past 1e-5
        # of the row's sum, so the float32 plain version is no yardstick
        # there
        truth = spmm_segment_ref(x.double(), src, dst, w.double(), num_out)
        scale = spmm_segment_ref(x.abs().double(), src, dst,
                                 w.abs().double(), num_out)
        require(bool(((got.double() - truth).abs()
                      <= 1e-5 * scale + 1e-5).all()),
                f"{label} differs from its plain version in float64 beyond "
                f"1e-5 of the rows' absolute sums")
        f64 = {"max_abs_err_f64": max_abs_err(got, truth),
               "plain_max_abs_err_f64": max_abs_err(want, truth),
               "max_err_over_abs_sum_f64": float(
                   ((got.double() - truth).abs() / (scale + 1e-30)).max()),
               "plain_max_err_over_abs_sum_f64": float(
                   ((want.double() - truth).abs() / (scale + 1e-30)).max())}
        del truth, scale
    live = (src >= 0) & (src < n) & (dst >= 0) & (dst < num_out)
    n_live = int(live.sum())
    rows = int(torch.unique(src[live]).numel())
    sparse = torch.sparse_coo_tensor(
        torch.stack([dst[live], src[live]]).long(), w[live],
        (num_out, n)).coalesce().to_sparse_csr()
    e = src.shape[0]
    # the kernel's call: offsets and src in full, w and the x rows of the
    # live edges (each distinct row once), the output written once
    nbytes = (num_out + 1) * 4 + e * 4 + n_live * 4 + rows * d * 4 \
        + num_out * d * 4
    ops = 2.0 * n_live * d

    def call():
        return spmm_ops.spmm_segment_sorted(x, s_src, seg.seg, s_w,
                                            seg.offsets)

    return {
        "max_abs_err": max_abs_err(got, want),
        **(f64 if check == "f64" else {}),
        "bytes": nbytes,
        "ms": time_ms(call, flush),
        "wrapper_ms": time_ms(lambda: spmm_ops.spmm_segment(
            x, src, dst, w, num_out), flush),
        "plain_ms": time_ms(lambda: spmm_segment_ref(x, src, dst, w,
                                                     num_out), flush),
        "library_ms": time_ms(lambda: torch.sparse.mm(sparse, x), flush),
        "bound_ms": bound_ms(nbytes, ops),
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= ops / FP32_OPS_PER_S else "operations",
        # the wrapper's call: src, dst and w read in full, the live x rows,
        # the output, and the sort's own output (sorted keys, int64 order)
        "wrapper_bound_ms": bound_ms(e * 12 + rows * d * 4 + num_out * d * 4
                                     + e * 12, ops),
        "shape": f"N={n} E={e} D={d} live={n_live} rows={rows} "
                 f"out={num_out}",
    }, call


def spmm_main_input(r, cols: dict, num_vertices: int):
    """The widest level of a root-0 ``bitmap`` aggregate_sum run, rebuilt
    from its rows and values: the frontier is the sources of the level's
    rows, ``x`` their values (zero elsewhere), and ``src`` is masked with
    the padding V outside the frontier, as ``WeightedDenseStep`` masks it.
    Returns (x (V, 1), src, dst, w, level) on the CPU."""
    count = int(r.count)
    pos = r.positions[:count].long()
    depth = r.row_depths[:count]
    level = int(torch.bincount(depth).argmax())
    frm = torch.from_numpy(cols["from"])
    frontier = torch.zeros((num_vertices,), dtype=torch.bool)
    frontier[frm[pos[depth == level]].long()] = True
    x = torch.where(frontier, r.vertex_values, 0.0)[:, None].contiguous()
    src = torch.where(frontier[frm.long()], frm, num_vertices)
    return (x, src, torch.from_numpy(cols["to"]),
            torch.from_numpy(cols[WEIGHT_COL]), level)


def spmm_random_input(seed: int, num_vertices: int, num_edges: int, d: int):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, num_edges).astype(np.int32)
    dst = rng.integers(0, num_vertices, num_edges).astype(np.int32)
    w = rng.uniform(0.5, 2.0, num_edges).astype(np.float32)
    x = rng.standard_normal((num_vertices, d), dtype=np.float32)
    return (torch.from_numpy(x).to(DEVICE), torch.from_numpy(src).to(DEVICE),
            torch.from_numpy(dst).to(DEVICE), torch.from_numpy(w).to(DEVICE))


def spmm_tile_cases_on_card() -> dict:
    """Each shared tile case (``spmm_tile_case``) at D = 1, 4, 17 and 128
    on the card: rows of at most S edges equal to the plain version run on
    the CPU, every row within 1e-5 of its sum of absolute terms, two calls
    bit-equal.  Returns each case's E, hubs and largest error per D."""
    cases = {}
    for case in SPMM_CASES:
        for d in (1, 4, 17, 128):
            x, src, dst, w, n_out = spmm_tile_case(case, d)
            x, src, dst, w = (torch.from_numpy(a) for a in (x, src, dst, w))
            want = spmm_segment_ref(x, src, dst, w, n_out)
            scale = spmm_segment_ref(x.abs(), src, dst, w.abs(), n_out)
            deg = spmm_ops.segments(dst, n_out).offsets.diff()
            args = [t.to(DEVICE) for t in (x, src, dst, w)]
            got = spmm_ops.spmm_segment(*args, n_out)
            again = spmm_ops.spmm_segment(*args, n_out)
            torch.cuda.synchronize()
            label = f"spmm_segment tile case {case} D={d}"
            require(torch.equal(got.view(torch.int32),
                                again.view(torch.int32)),
                    f"{label}: two calls differ")
            got = got.cpu()
            short = deg <= SHORT_ROW
            require(got.shape == want.shape
                    and torch.equal(got[short], want[short]),
                    f"{label}: a short row differs from the CPU run")
            require(bool(((got - want).abs() <= 1e-5 * scale + 1e-5).all()),
                    f"{label}: beyond 1e-5 of the rows' absolute sums")
            hub = tile_plan(src.shape[0], d).hub_edges
            cases.setdefault(case, {})[d] = {
                "E": src.shape[0], "hubs": int((deg > hub).sum()),
                "max_abs_err": max_abs_err(got, want)}
    return cases


def spmm_segment_phase(r, cols: dict, num_vertices: int, flush):
    """Cases (a)-(e) against the plain version (the kernel line's entry is
    (a)); returns the entry, the cases and the kernel calls at (a) and
    (d), for :func:`spmm_profile`."""
    x, src, dst, w, level = spmm_main_input(r, cols, num_vertices)
    frm = torch.from_numpy(cols["from"]).to(DEVICE)
    to, w = dst.to(DEVICE), w.to(DEVICE)
    main, main_call = spmm_case(x.to(DEVICE), src.to(DEVICE), to, w,
                                num_vertices, "exact", flush)
    main["shape"] += f" level={level}"
    cases, calls = {"a": main}, {"a": main_call}
    cases["b"], _ = spmm_case(*spmm_random_input(2, 1 << 20, 1 << 22, 1),
                              1 << 20, "close", flush)
    cases["c"], _ = spmm_case(*spmm_random_input(3, 1 << 16, 1 << 18, 128),
                              1 << 16, "close", flush)
    # the inbound view: every edge live, grouped by its `from` vertex
    # (vertex 0 owns 83,619 edges), at D = 1 and at GraphSAGE-Reddit's
    # d_hidden = 128 (src/repro/configs/graphsage_reddit.py)
    for case, seed, d in (("d", 4, 1), ("e", 5, 128)):
        xs = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (num_vertices, d), dtype=np.float32)).to(DEVICE)
        cases[case], calls[case] = spmm_case(xs, to, frm, w, num_vertices,
                                             "scaled", flush)
        del xs
    del calls["e"]
    entry = {
        "name": "spmm_segment", "route": "cuda",
        "source": "src/repro_torch/csrc/spmm_segment.cu",
        "replaces": "src/repro/kernels/spmm_segment/spmm_segment.py:43",
        **main,
    }
    return entry, cases, calls


def spmm_lane_bytes(xs: torch.Tensor, s_src: torch.Tensor,
                    mask: torch.Tensor, num_out: int) -> tuple[int, int]:
    """The bytes and float32 operations of one lane-axis call, each input
    read once and each output written once, for this call's data: offsets
    and the shared src in full, each lane's mask bytes at the sources of
    in-range edges (the kernel reads no other), the weights of the edges
    live in some lane, each lane's x rows that a live edge reads, and
    every lane's output rows; two operations a live term."""
    lanes, n, d = xs.shape
    e = s_src.shape[0]
    in_range = (s_src >= 0) & (s_src < n)
    live = mask[:, s_src.clamp(0, n - 1).long()] & in_range
    has_edge = torch.zeros((n,), dtype=torch.bool, device=xs.device)
    has_edge[s_src[in_range].long()] = True
    sources = int(has_edge.sum())
    rows = int((mask & has_edge).sum())
    nbytes = ((num_out + 1) * 4 + e * 4 + lanes * sources
              + int(live.any(0).sum()) * 4 + rows * d * 4
              + lanes * num_out * d * 4)
    return nbytes, 2 * int(live.sum()) * d


def spmm_lanes_library(xs, s_src, seg, s_w, mask, num_out: int):
    """The one PyTorch call that computes every lane at once: the (num_out
    x N) CSR matrix of the in-range edges' weights times the lanes' x,
    each masked to 0 off its lane's sources and laid out as (N, L * D).
    Returns the call, built outside any timed region, and its output's
    (L, num_out, D) view."""
    lanes, n, d = xs.shape
    keep = (s_src >= 0) & (s_src < n) & (seg >= 0) & (seg < num_out)
    sparse = torch.sparse_coo_tensor(
        torch.stack([seg[keep], s_src[keep]]).long(), s_w[keep],
        (num_out, n)).coalesce().to_sparse_csr()
    dense = torch.where(mask[..., None], xs, 0).permute(1, 0, 2).reshape(
        n, lanes * d)

    def call():
        return torch.sparse.mm(sparse, dense)
    return call, lambda out: out.reshape(num_out, lanes, d).permute(1, 0, 2)


def spmm_lanes_call(xs, s_src, seg, s_w, offsets, mask, flush,
                    exact: bool, label: str, want=None, scale=None,
                    short=None, library: bool = False
                    ) -> tuple[dict, object]:
    """One lane-axis ``spmm_segment`` call on the card: two calls bit-equal,
    every lane bit-equal to the one-lane call on its sources masked to N,
    one lane with its mask equal to that call, a lane whose mask is all
    off zero, and the lanes equal to ``want`` (the lane-axis plain
    version): exactly where ``exact``, else on the ``short`` rows exactly
    and elsewhere within 1e-5 of each row's absolute sum ``scale``.  Times
    the call, the plain version (on the card) and the lanes' one-lane
    calls in a row, the L one-lane sources masked beforehand, and with
    ``library`` :func:`spmm_lanes_library`'s call.  Returns the numbers
    and the call."""
    lanes, n, d = xs.shape
    num_out = offsets.shape[0] - 1

    def call():
        return spmm_ops.spmm_segment_sorted(xs, s_src, seg, s_w, offsets,
                                            mask)
    before = spmm_ops.LAUNCHES
    got, again = call(), call()
    torch.cuda.synchronize()
    require(spmm_ops.LAUNCHES == before + 2 * (num_out * d * lanes > 0),
            f"{label}: {spmm_ops.LAUNCHES - before} launches for two calls")
    require(got.shape == (lanes, num_out, d)
            and torch.equal(got.view(torch.int32), again.view(torch.int32)),
            f"{label}: shape {tuple(got.shape)} or two calls differ")
    masked = [torch.where(mask[i][s_src.clamp(0, n - 1).long()], s_src, n)
              for i in range(lanes)]
    for i in range(lanes):
        one = spmm_ops.spmm_segment_sorted(xs[i], masked[i], seg, s_w,
                                           offsets)
        require(torch.equal(got[i].view(torch.int32), one.view(torch.int32)),
                f"{label}: lane {i} differs from its one-lane call")
        if i == 0:
            alone = spmm_ops.spmm_segment_sorted(xs[:1], s_src, seg, s_w,
                                                 offsets, mask[:1])[0]
            require(torch.equal(alone.view(torch.int32),
                                one.view(torch.int32)),
                    f"{label}: L = 1 differs from the one-lane call")
        if not bool(mask[i].any()):
            require(not bool(got[i].any()), f"{label}: empty lane {i}")
    if want is None:
        want = spmm_segment_lanes_ref(xs, s_src, seg, s_w, num_out, mask)
    got_w = got.to(want.device)
    if exact:
        require(torch.equal(got_w, want),
                f"{label} differs from the lane-axis plain version")
    else:
        require(torch.equal(got_w[:, short], want[:, short])
                and bool(((got_w - want).abs()
                          <= 1e-5 * scale + 1e-5).all()),
                f"{label} differs from the lane-axis plain version beyond "
                f"1e-5 of the rows' absolute sums")
    nbytes, ops = spmm_lane_bytes(xs, s_src, mask, num_out)

    def one_by_one():
        for i in range(lanes):
            spmm_ops.spmm_segment_sorted(xs[i], masked[i], seg, s_w, offsets)
    plain = None if not exact else time_ms(
        lambda: spmm_segment_lanes_ref(xs, s_src, seg, s_w, num_out, mask),
        flush)
    lib = {}
    if library:
        lib_call, lanes_of = spmm_lanes_library(xs, s_src, seg, s_w, mask,
                                                num_out)
        lib_out = lanes_of(lib_call()).to(want.device)
        require(bool(torch.isclose(lib_out, want, **SPMM_TOL).all()),
                f"{label}: torch.sparse.mm differs from the lane-axis "
                f"plain version beyond {SPMM_TOL}")
        lib = {"library_ms": time_ms(lib_call, flush),
               "library_max_abs_err": max_abs_err(lib_out, want)}
    return {
        "max_abs_err": max_abs_err(got_w, want),
        "ms": time_ms(call, flush),
        "one_lane_calls_ms": time_ms(one_by_one, flush),
        "plain_ms": plain,
        **lib,
        "bound_ms": bound_ms(nbytes, ops),
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= ops / FP32_OPS_PER_S else "operations",
        "live_lanes": int(mask.any(-1).sum()),
    }, call


def spmm_lane_input(results, roots, cols: dict, num_vertices: int,
                    level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's frontier and values at ``level`` of the outbound
    aggregate_sum traversal from its root, rebuilt from the lane's
    PRecursive rows (on the tree the two emit the same rows level by
    level): the frontier is the sources of the lane's rows of that level,
    and a frontier vertex's value the product of the weights on its path
    from the root, in float32 root-down, as the engine folds it.  Returns
    (xs (L, V, 1), mask (L, V)) on the CPU."""
    frm, to, w = cols["from"], cols["to"], cols[WEIGHT_COL]
    xs = np.zeros((len(results), num_vertices), np.float32)
    mask = np.zeros((len(results), num_vertices), bool)
    for i, (r, root) in enumerate(zip(results, roots)):
        count = int(r.count)
        pos = r.positions[:count].cpu().numpy()
        depth = r.row_depths[:count].cpu().numpy()
        prod = np.ones(num_vertices, np.float32)
        for d in range(level):
            p = pos[depth == d]
            prod[to[p]] = prod[frm[p]] * w[p]
        f = frm[pos[depth == level]]
        mask[i, f] = True
        xs[i, f] = prod[f]
    return torch.from_numpy(xs)[..., None], torch.from_numpy(mask)


def spmm_lane_cases_on_card(flush) -> dict:
    """Each shared tile case (``spmm_tile_case``) at the widths
    SPMM_LANE_DIMS as BATCH_ROOTS lanes in one call: each lane its own
    seeded x and source mask (lane 1 masks every source off), checked by
    :func:`spmm_lanes_call` against the lane-axis plain version run on the
    CPU.  Returns each case's numbers per width."""
    cases = {}
    for case in SPMM_CASES:
        for d in SPMM_LANE_DIMS:
            x, src, dst, w, n_out = spmm_tile_case(case, d)
            n = x.shape[0]
            rng = np.random.default_rng(SPMM_CASES.index(case) + 1000 * d)
            xs = torch.from_numpy(rng.standard_normal(
                (BATCH_ROOTS, n, d), dtype=np.float32))
            mask = torch.from_numpy(rng.random((BATCH_ROOTS, n)) < 0.6)
            mask[1] = False
            dst = torch.from_numpy(dst)
            seg = spmm_ops.segments(dst, n_out)
            s_src = torch.from_numpy(src)[seg.order]
            s_w = torch.from_numpy(w)[seg.order]
            want = spmm_segment_lanes_ref(xs, s_src, seg.seg, s_w, n_out,
                                          mask)
            scale = spmm_segment_lanes_ref(xs.abs(), s_src, seg.seg,
                                           s_w.abs(), n_out, mask)
            short = seg.offsets.diff() <= SHORT_ROW
            on = [t.to(DEVICE) for t in (xs, s_src, seg.seg, s_w,
                                         seg.offsets, mask)]
            numbers, _ = spmm_lanes_call(
                *on, flush, False, f"spmm_segment lane case {case} D={d}",
                want, scale, short)
            hub = tile_plan(s_src.shape[0], d).hub_edges
            numbers.update(E=s_src.shape[0],
                           hubs=int((seg.offsets.diff() > hub).sum()))
            cases.setdefault(case, {})[d] = numbers
    return cases


# the source-mask densities of the seeded main-shape lane case: an empty
# lane, a full one, and six between
SPMM_LANE_DENSITIES = (0.0, 0.05, 0.15, 0.3, 0.5, 0.7, 0.9, 1.0)


def spmm_segment_lane_phase(ds, xs, mask, level: int, flush):
    """The lane axis at the deployment's widest dense level: the
    BATCH_ROOTS lanes of the outbound aggregate_sum batch (root 0's
    widest level, the other lanes at the same level of their own
    traversals) in one call over the tree's edges in destination order,
    exact against the lane-axis plain version (every row of the tree has
    at most one edge).  Then the same edges with seeded x on every vertex
    and each lane its own seeded mask (SPMM_LANE_DENSITIES), where a lane
    that ignored its mask, or read another lane's, would differ; then the
    tile cases.  Returns the entry (the seeded case under ``seeded``), the
    cases and the call."""
    frm, to = ds.table.column("from"), ds.table.column("to")
    w = ds.edge_weights(WEIGHT_COL)
    seg = spmm_ops.segments(to, SPEC.num_vertices)
    s_src, s_w = frm[seg.order], w[seg.order]
    xs, mask = xs.to(DEVICE), mask.to(DEVICE)
    entry, call = spmm_lanes_call(xs, s_src, seg.seg, s_w, seg.offsets,
                                  mask, flush, True,
                                  f"spmm_segment lanes level {level}",
                                  library=True)
    entry["shape"] = (f"L={xs.shape[0]} level={level} V={xs.shape[1]} "
                      f"E={s_src.shape[0]} D=1 "
                      f"frontier={mask.sum(-1).tolist()}")
    rng = np.random.default_rng(SPEC.seed + 2)
    lanes, n = mask.shape
    seeded_x = torch.from_numpy(rng.standard_normal(
        (lanes, n, 1), dtype=np.float32)).to(DEVICE)
    seeded_mask = torch.from_numpy(
        rng.random((lanes, n)) < np.asarray(SPMM_LANE_DENSITIES)[:, None]
    ).to(DEVICE)
    seeded, _ = spmm_lanes_call(seeded_x, s_src, seg.seg, s_w, seg.offsets,
                                seeded_mask, flush, True,
                                "spmm_segment lanes seeded", library=True)
    seeded["shape"] = (f"L={lanes} V={n} E={s_src.shape[0]} D=1 "
                       f"mask={seeded_mask.sum(-1).tolist()}")
    entry["seeded"] = seeded
    return entry, spmm_lane_cases_on_card(flush), call


def value_oracle(levels: list, cols: dict, num_vertices: int
                 ) -> dict[str, np.ndarray]:
    """Root 0's vertex values on the tree, from ``bfs_reference``'s levels:
    the sum of the weights along each vertex's root path (shortest_path)
    and their product (the four aggregates coincide on a tree), both
    accumulated root-down in float32, as the engines do; the identity where
    a vertex is not reached."""
    frm, to, w = cols["from"], cols["to"], cols[WEIGHT_COL]
    total = np.full(num_vertices, np.inf, np.float32)
    prod = np.full(num_vertices, np.nan, np.float32)
    total[0], prod[0] = 0.0, 1.0
    for level in levels:
        p = np.fromiter(level, np.int64)
        total[to[p]] = total[frm[p]] + w[p]
        prod[to[p]] = prod[frm[p]] * w[p]
    reached = ~np.isnan(prod)
    identity = {"aggregate_sum": 0.0, "aggregate_max": -np.inf,
                "aggregate_min": np.inf, "aggregate_mul": 1.0}
    out = {"shortest_path": total}
    for name, ident in identity.items():
        out[name] = np.where(reached, prod, np.float32(ident))
    return out


def embedding_bag_case(table, idx, seg, w, num_bags: int, combiner: str,
                       flush) -> dict:
    """``embedding_bag`` against its plain version on the card, within
    BAG_TOL of each bag's sum of absolute terms.  ``ms`` is the kernel on
    entries already in bag order; ``wrapper_ms`` adds the wrapper's stable
    sort; ``library_ms`` is ``torch.nn.functional.embedding_bag`` over the
    live entries (in-range segment, index wrapped into [0, R)) in bag
    order, built outside the timed region.  ``cpu_exact``: the kernel
    equals the plain version run on the CPU bit for bit (its
    ``index_add_`` adds in the entries' order there, as the kernel does);
    required.  ``layout`` is the kernel's, from ``bag_layout``.  Returns
    the case and the kernel's call on the sorted entries."""
    r, d = table.shape
    n = idx.shape[0]
    s = spmm_ops.segments(seg, num_bags)
    s_idx = idx[s.order]
    s_w = None if w is None else w[s.order]
    got = eb_ops.embedding_bag_sorted(table, s_idx, s.seg, s_w, s.offsets,
                                      combiner=combiner)
    via_wrapper = eb_ops.embedding_bag(table, idx, seg, num_bags, w,
                                       combiner=combiner)
    want = embedding_bag_ref(table, idx, seg, num_bags, w, combiner=combiner)
    scale = embedding_bag_ref(table.abs(), idx, seg, num_bags,
                              None if w is None else w.abs(),
                              combiner=combiner)
    torch.cuda.synchronize()
    label = f"embedding_bag R={r} D={d} I={n} bags={num_bags} {combiner}"
    require(torch.equal(got, via_wrapper), f"{label}: wrapper differs")
    require(bool(((got - want).abs() <= BAG_TOL * scale).all()),
            f"{label} differs from its plain version beyond {BAG_TOL} of "
            f"the bags' absolute sums")
    want_cpu = embedding_bag_ref(table.cpu(), idx.cpu(), seg.cpu(), num_bags,
                                 None if w is None else w.cpu(),
                                 combiner=combiner)
    require(torch.equal(got.cpu().view(torch.int32),
                        want_cpu.view(torch.int32)),
            f"{label} differs from its plain version run on the CPU")
    # the library call's inputs: live entries in bag order, bag offsets
    wrapped = torch.where(s_idx < 0, s_idx + r, s_idx).long()
    in_bag = (s.seg >= 0) & (s.seg < num_bags)
    live = in_bag & (wrapped >= 0) & (wrapped < r)
    lib_idx, lib_seg = wrapped[live], s.seg[live]
    lib_w = None if s_w is None else s_w[live]
    lib_off = torch.searchsorted(lib_seg, torch.arange(
        num_bags, dtype=lib_seg.dtype, device=lib_seg.device))
    mode = "sum" if combiner == "sum" else "mean"
    require(mode == "sum" or lib_w is None,
            "the library's mean takes no weights")

    def library():
        return torch.nn.functional.embedding_bag(
            lib_idx, table, lib_off, mode=mode, per_sample_weights=lib_w)

    n_live = int(live.sum())
    rows = int(torch.unique(lib_idx).numel())
    entries = int(in_bag.sum())
    weighted = w is not None
    # the kernel's call: offsets, the in-bag entries' indices (and
    # weights), each distinct live row once, the output written once
    nbytes = (num_bags + 1) * 4 + entries * (8 if weighted else 4) \
        + rows * d * 4 + num_bags * d * 4
    ops = (2.0 if weighted else 1.0) * n_live * d

    def kernel():
        return eb_ops.embedding_bag_sorted(table, s_idx, s.seg, s_w,
                                           s.offsets, combiner=combiner)

    return {
        "max_abs_err": max_abs_err(got, want),
        "cpu_exact": True,
        "layout": bag_layout(d, table.data_ptr())._asdict(),
        "library_max_abs_err": max_abs_err(got, library()),
        "ms": time_ms(kernel, flush),
        "wrapper_ms": time_ms(lambda: eb_ops.embedding_bag(
            table, idx, seg, num_bags, w, combiner=combiner), flush),
        "plain_ms": time_ms(lambda: embedding_bag_ref(
            table, idx, seg, num_bags, w, combiner=combiner), flush),
        "library_ms": time_ms(library, flush),
        "bound_ms": bound_ms(nbytes, ops),
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= ops / FP32_OPS_PER_S else "operations",
        # the wrapper's call adds the segment ids read and the sort's own
        # output (sorted keys, int64 order) and the permuted copies
        "wrapper_bound_ms": bound_ms(nbytes + n * 4 + n * 12
                                     + n * (8 if weighted else 4), ops),
        "shape": f"R={r} D={d} I={n} bags={num_bags} live={n_live} "
                 f"rows={rows} {combiner}{' weighted' if weighted else ''}",
        # one lane group walks a bag in series: the longest sets the tail
        "largest_bag": int(s.offsets.diff().max()) if num_bags else 0,
    }, kernel


def bag_inputs(case: str):
    """``bag_cases``'s case (b) or (c), on the card."""
    *tensors, num_bags = bag_cases(case)
    return [t.to(DEVICE) for t in tensors] + [num_bags]


def embedding_bag_phase(table, pos, flush):
    """(a) the full DeepFM table, one bag per serve_bulk sample over its 39
    positions (unweighted sum), whose sums must also equal the forward
    pass's ``emb.sum(1)``; (b) and (c) weighted with out-of-range entries
    (:func:`bag_inputs`); (d) (b)'s entries unweighted under ``mean``.
    Returns the kernel line's entry (a), the cases, (a)'s bags and each
    case's kernel call on sorted entries."""
    b, k = pos.shape
    idx = pos.reshape(-1).contiguous()
    seg = torch.arange(b, dtype=torch.int32, device=DEVICE) \
        .repeat_interleave(k)
    main, main_call = embedding_bag_case(table, idx, seg, None, b, "sum",
                                         flush)
    bags = eb_ops.embedding_bag(table, idx, seg, b)
    emb = fixed_hot_lookup(table, pos)
    torch.cuda.synchronize()
    require(bool(((bags - emb.sum(1)).abs()
                  <= BAG_TOL * emb.abs().sum(1)).all()),
            "embedding_bag (a) differs from the forward pass's emb.sum(1)")
    tab_b, idx_b, seg_b, w_b, nb = bag_inputs("b")
    cases, calls = {"a": main}, {"a": main_call}
    for case, args in (("b", (tab_b, idx_b, seg_b, w_b, nb, "sum")),
                       ("c", (*bag_inputs("c")[:4], 8192, "sum")),
                       ("d", (tab_b, idx_b, seg_b, None, nb, "mean"))):
        cases[case], calls[case] = embedding_bag_case(*args, flush)
    entry = {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:47",
        **main,
    }
    return entry, cases, (idx, seg, bags), calls


def embedding_bag_layout_cases_on_card() -> dict:
    """Each shared layout case (``bag_layout_case``: every layout of
    ``bag_layout``, bags of 0, 1, K - 1, K, K + 1, 39 and 3,000 entries, a
    table at a storage offset) on the card, weighted and not, under sum
    and mean: bit-equal to the plain version run on the CPU, two calls
    bit-equal, empty bags zero.  Returns each case's layout and largest
    error against the card's plain version."""
    cases = {}
    for case in BAG_LAYOUT_CASES:
        tab, idx, seg, w, b, offset = bag_layout_case(case)
        idx, seg, w = (torch.from_numpy(a) for a in (idx, seg, w))
        t = layout_table(tab, offset, DEVICE)
        layout = bag_layout(t.shape[1], t.data_ptr())
        require(not offset or layout.vec == 1,
                f"embedding_bag layout case {case}: {layout}")
        errs = {}
        for weighted in (False, True):
            for combiner in ("sum", "mean"):
                ww = w if weighted else None
                want = embedding_bag_ref(layout_table(tab, offset), idx,
                                         seg, b, ww, combiner=combiner)
                args = [None if a is None else a.to(DEVICE)
                        for a in (idx, seg, ww)]
                got = eb_ops.embedding_bag(t, args[0], args[1], b, args[2],
                                           combiner=combiner)
                again = eb_ops.embedding_bag(t, args[0], args[1], b,
                                             args[2], combiner=combiner)
                torch.cuda.synchronize()
                label = (f"embedding_bag layout case {case} {combiner}"
                         f"{' weighted' if weighted else ''}")
                bits = got.view(torch.int32)
                require(torch.equal(bits, again.view(torch.int32)),
                        f"{label}: two calls differ")
                require(torch.equal(bits.cpu(), want.view(torch.int32)),
                        f"{label}: differs from the CPU run")
                require(not got[[0, b - 1]].any(),
                        f"{label}: an empty bag is not zero")
                errs[f"{combiner}{' weighted' if weighted else ''}"] = \
                    max_abs_err(got, embedding_bag_ref(
                        t, *args[:2], b, args[2], combiner=combiner))
        cases[case] = {"D": tab.shape[1], "I": int(idx.shape[0]),
                       "layout": layout._asdict(),
                       "max_abs_err_vs_card_plain": errs}
    return cases


def bag_profile(calls: dict, flush) -> dict:
    """``embedding_bag``'s device launches per call (1) and its kernel's
    own mean device time at each case of ``calls``."""
    out = {}
    for case, fn in calls.items():
        launches, by_key = device_profile(fn, flush, 1)
        require(launches == 1, f"embedding_bag ({case}): {launches} device "
                "launches in one call, want 1")
        out[case] = {"device_launches_per_call": launches,
                     "kernel_device_ms": kernel_times(
                         by_key, ("embedding_bag_kernel",),
                         f"embedding_bag ({case})")["embedding_bag_kernel"]}
    return out


# ---------------------------------------------------------------------------
# DeepFM serving at the published Criteo width
# ---------------------------------------------------------------------------

class RecsysRequest(NamedTuple):
    kind: str                       # serve_p99 | serve_bulk | retrieval_cand
    dense: torch.Tensor             # on the host, as a request arrives
    sparse: torch.Tensor
    cand: torch.Tensor | None = None

    def __str__(self) -> str:
        n = f" C={self.cand.shape[0]}" if self.cand is not None else ""
        return f"deepfm {self.kind} B={self.dense.shape[0]}{n}"


def make_recsys_requests() -> list[RecsysRequest]:
    """8 serve_p99 batches ``recsys_batch(1, r, 512)``, the serve_bulk
    batch ``recsys_batch(0, 0, 262144)``, and one retrieval context
    ``recsys_batch(2, 0, 1)`` against 1,000,000 candidate items of the
    widest categorical field (C1, 7,912,889 ids), drawn with numpy seed 3."""
    vocabs = vocab_sizes(DEEPFM.vocab_scale)

    def host(seed: int, step: int, batch: int):
        b = recsys_batch(seed, step, batch, vocabs=vocabs)
        return torch.from_numpy(b["dense"]), torch.from_numpy(b["sparse"])

    reqs = [RecsysRequest("serve_p99", *host(1, r, P99_BATCH))
            for r in range(P99_REQUESTS)]
    reqs.append(RecsysRequest("serve_bulk", *host(0, 0, BULK_BATCH)))
    c1 = int(recsys.field_offsets(DEEPFM)[DEEPFM.n_dense])
    cand = c1 + np.random.default_rng(3).integers(0, vocabs[0], N_CANDIDATES)
    reqs.append(RecsysRequest("retrieval_cand", *host(2, 0, 1),
                              torch.from_numpy(cand.astype(np.int32))))
    return reqs


def params_mb(params) -> float:
    tensors = [params["table"], params["first_order"], params["bias"],
               *(t for lp in params["mlp"] for t in lp.values())]
    return sum(t.nbytes for t in tensors) / 2 ** 20


def serve(params, offsets, req: RecsysRequest):
    """One request as a user makes it: its features copied to the
    parameters' device, then ``serve_scores`` or ``retrieval_scores``."""
    device = offsets.device
    dense, sparse = req.dense.to(device), req.sparse.to(device)
    if req.cand is None:
        return recsys.serve_scores(params, DEEPFM, dense, sparse, offsets)
    return recsys.retrieval_scores(params, DEEPFM, dense, sparse, offsets,
                                   req.cand.to(device))


def check_recsys(reqs, got, want, positions, want_positions) -> dict:
    """Positions card against CPU: every difference is a bucket flip, one
    bucket apart where ``1000 * sigmoid(x)`` (float64) lies within 1e-3 of
    an integer.  Scores within DEEPFM_TOL on every sample whose positions
    agree (retrieval: all candidates, if its context's agree).  Returns the
    flip counts by request kind."""
    flips = dict.fromkeys((req.kind for req in reqs), 0)
    for req, g, w, pos, wpos in zip(reqs, got, want, positions,
                                    want_positions):
        pos = pos.cpu()
        label = str(req)
        require(g.shape == w.shape and bool(torch.isfinite(g).all()),
                f"{label}: shape or non-finite scores")
        diff = pos != wpos
        require(not bool(diff[:, DEEPFM.n_dense:].any()),
                f"{label}: a categorical position differs")
        rows, cols = torch.nonzero(diff, as_tuple=True)
        x = req.dense[rows, cols].double()
        scaled = 1000.0 / (1.0 + torch.exp(-x))
        require(bool(((pos[rows, cols] - wpos[rows, cols]).abs() == 1).all()
                     and ((scaled - scaled.round()).abs() < 1e-3).all()),
                f"{label}: a position differs away from a bucket boundary")
        flips[req.kind] += int(rows.numel())
        agree = ~diff.any(1)
        g = g.cpu()
        if req.cand is not None:
            if bool(agree.all()):
                require(bool(torch.isclose(g, w, **DEEPFM_TOL).all()),
                        f"{label}: scores differ beyond {DEEPFM_TOL}")
            else:
                print(f"{label}: the context's positions flipped, so its "
                      f"{g.numel()} candidate scores were not compared")
            continue
        require(bool(torch.isclose(g[agree], w[agree], **DEEPFM_TOL).all()),
                f"{label}: scores differ beyond {DEEPFM_TOL}")
    return flips


def profile_call(label: str, fn, warm_ms: float) -> dict:
    """Where one warm request's time goes: device time per kernel from
    ``torch.profiler``, and the device's idle share against the request's
    unprofiled warm latency ``warm_ms``.  A session that lost every
    device event is taken again (:func:`profiled`)."""
    # device-side events only (kernels, copies, fills): the host ops that
    # launched them carry the same time again
    kernels = profiled(fn, bool)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {
        "request": label, "warm_ms": warm_ms,
        "device_ms": device_ms,
        "idle_share": 1 - device_ms / warm_ms if device_ms else None,
        "device_launches": sum(e.count for e in kernels),
        "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                for e in top],
    }


def warm_latency_ms(fn) -> float:
    """Median of 3 warm runs, host clock around the request and a sync."""
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def check_path(label, requests, got, expected, launches, want_launches,
               levels, values, id_to_pos) -> None:
    """One path's results against the CPU run, its root-0 rows against
    the BFS oracle (and its root-0 vertex values against ``values``), and
    its launch counts against the CPU run's levels."""
    for req, r, want in zip(requests, got, expected):
        check_result_shape(r, CAPS, str(req))
        require_equal(r, want, str(req))
        if req.direction == "outbound" and req.root == 0:
            check_root0(r, levels, SPEC, str(req),
                        real_positions(req.engine, r, id_to_pos))
            if req.workload != "reach":
                require(torch.equal(r.vertex_values.cpu(), torch.from_numpy(
                    values[req.workload])),
                    f"{req}: vertex values differ from the path oracle")
    for kernel, n in want_launches.items():
        require(launches[kernel] == n,
                f"{label} path: {kernel} launched {launches[kernel]} times, "
                f"the CPU run's levels call for {n}")
    print(f"{label} path: {len(requests)} requests equal to the CPU run; "
          f"launches {json.dumps(launches)}")


# ---------------------------------------------------------------------------
# batched roots (run_query_batch)
# ---------------------------------------------------------------------------

class Batch(NamedTuple):
    engine: str
    direction: str
    roots: tuple
    workload: str = "reach"

    def __str__(self) -> str:
        label = f"{self.engine} {self.direction} x{len(self.roots)}"
        return label if self.workload == "reach" else \
            f"{label} {self.workload}"


def make_batches(cols: dict, num_vertices: int) -> list[Batch]:
    """Each reach-batch engine outbound over the BATCH_ROOTS roots of
    :func:`batch_roots`; PRecursive inbound and both ways over the same
    roots with the deepest vertex in place of the last random root; and
    PRecursive outbound over a serving bucket of BUCKET_ROOTS (the eight
    and seeded random roots)."""
    eight = tuple(batch_roots(cols, num_vertices))
    back = eight[:-1] + (num_vertices - 1,)
    more = np.random.default_rng(ROOT_SEED + 1).integers(
        0, num_vertices, BUCKET_ROOTS - len(eight)).tolist()
    return ([Batch(engine, "outbound", eight) for engine in BATCH_ENGINES]
            + [Batch("precursive", "inbound", back),
               Batch("precursive", "both", back),
               Batch("precursive", "outbound", eight + tuple(more))])


def make_value_batches(cols: dict, num_vertices: int
                       ) -> tuple[list[Batch], list[Batch]]:
    """The weighted batches over the eight roots of :func:`batch_roots`:
    ``precursive`` outbound under each semiring and shortest_path inbound
    and both ways (the deepest vertex in place of the last random root),
    ``bitmap`` outbound under each semiring and shortest_path and
    aggregate_sum inbound (the aggregate_sum batches run the lane-axis
    ``spmm_segment``); and the value-engine batches: each of the six
    outbound, ``trecursive`` and ``trecursive_rewrite`` inbound and both
    ways."""
    eight = tuple(batch_roots(cols, num_vertices))
    back = eight[:-1] + (num_vertices - 1,)
    sp = "shortest_path"
    weighted = ([Batch("precursive", "outbound", eight, s)
                 for s in SEMIRINGS]
                + [Batch("precursive", d, back, sp)
                   for d in ("inbound", "both")]
                + [Batch("bitmap", "outbound", eight, s) for s in SEMIRINGS]
                + [Batch("bitmap", "inbound", back, s)
                   for s in (sp, "aggregate_sum")])
    value = ([Batch(engine, "outbound", eight)
              for engine in VALUE_ENGINE_NAMES]
             + [Batch(engine, d, back)
                for engine in ("trecursive", "trecursive_rewrite")
                for d in ("inbound", "both")])
    return weighted, value


def result_buffer_mib(ds, b: Batch) -> float | None:
    """The working result a value-engine batch holds: L x (cap_r + cap_f)
    rows of the columns its recursion appends (full 4 W-byte rows on the
    row store, the output columns on ``trecursive``, the id alone on a
    rewrite); None for the positional and dense engines."""
    if b.engine not in VALUE_ENGINE_NAMES:
        return None
    if b.engine.endswith("_rewrite"):
        row = 4
    elif b.engine.startswith("rowstore"):
        row = 4 * sum(int(np.prod(c.shape[1:]))
                      for c in ds.table.columns.values())
    else:
        row = sum(c.element_size() * int(np.prod(c.shape[1:]))
                  for name, c in ds.table.columns.items()
                  if name in query(b.engine).out_cols)
    return len(b.roots) * (CAPS.result + CAPS.frontier) * row / 2 ** 20


def run_batch(ds, b: Batch, levels: list, card: str, id_to_pos=None,
              values=None) -> dict:
    """One ``run_query_batch`` call with the counters zeroed just before
    and read just after: every lane bit-equal to the card's run of its
    root alone, root 0's lane (outbound) equal to the BFS oracle (its ids
    mapped back to positions through ``id_to_pos`` where the recursion
    carried values) and, weighted, to the path oracle ``values``, and
    each per-level kernel called once on each level where some lane calls
    it (a lane's levels from :func:`launch_levels` of its own run), so a
    level is one C call for all lanes; ``late_gather`` once, or, on the
    tuple and row-store engines, once a level of the deepest lane, once
    for the seed blocks and once more for a rewrite's join.  Returns the
    ``batch:`` line's numbers."""
    q = query(b.engine, b.direction, b.workload)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    got = run_query_batch(q, ds, list(b.roots))
    launches = read_launches()
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    lane_levels, one_by_one_ms = [], 0.0
    for i, root in enumerate(b.roots):
        one = run_query(q, ds, root)
        lane = result_lane(got, i)
        label = f"batch {b} lane {i} root {root}"
        require_equal(lane, one, label, "the single-root card run")
        if b.direction == "outbound" and root == 0:
            check_root0(lane, levels, SPEC, label,
                        real_positions(b.engine, lane, id_to_pos)
                        if id_to_pos is not None else None)
            if b.workload != "reach":
                require(torch.equal(lane.vertex_values.cpu(),
                                    torch.from_numpy(values[b.workload])),
                        f"{label}: vertex values differ from the path "
                        f"oracle")
        lane_levels.append(launch_levels(
            Request(b.engine, b.direction, root, b.workload), one,
            SPEC.num_vertices))
        one_by_one_ms += warm_latency_ms(lambda root=root: run_query(
            q, ds, root))
    depths = got.depth.tolist()
    deepest = [i for i, d in enumerate(depths) if d == max(depths)]
    want = {k: len(set().union(*(lv[k] for lv in lane_levels)))
            for k in LEVEL_KERNELS}
    gathers = (max(depths) + 1 + b.engine.endswith("_rewrite")
               if b.engine in VALUE_ENGINE_NAMES else 1)
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0), **want,
                         "late_gather": gathers},
            f"batch {b}: launches {launches}, want {want} and "
            f"{gathers} late_gather")
    warm = warm_latency_ms(lambda: run_query_batch(q, ds, list(b.roots)))
    line = {
        "call": str(b), "lanes": len(b.roots), "levels": max(depths),
        "lane_depths": depths, "launches": launches,
        "deepest_lane_launches": {k: max(len(lane_levels[i][k])
                                         for i in deepest)
                                  for k in LEVEL_KERNELS},
        "summed_lane_launches": {k: sum(len(lv[k]) for lv in lane_levels)
                                 for k in LEVEL_KERNELS},
        "warm_ms": warm, "one_by_one_warm_ms": one_by_one_ms,
        "peak_mib": peak_mib, "count": got.count.tolist(),
        "overflow": got.overflow.tolist(), "card": card}
    reckoned = result_buffer_mib(ds, b)
    if reckoned is not None:
        line["result_buffer_mib"] = reckoned
    return line


def run_weighted_buckets(ds, roots: list, card: str) -> tuple[dict, dict]:
    """``run_query_buckets`` of ``precursive`` shortest_path over the eight
    roots in two buckets of 4: every root bit-equal to its single-root
    card run, ``late_gather`` once a bucket.  Returns the ``weighted
    buckets:`` line and the launches."""
    q = query("precursive", workload="shortest_path")
    size = len(roots) // 2
    buckets = [types.SimpleNamespace(indices=tuple(range(k, k + size)),
                                     roots=tuple(roots[k:k + size]),
                                     caps=CAPS)
               for k in range(0, len(roots), size)]
    reset_launches()
    out = run_query_buckets(q, ds, buckets)
    launches = read_launches()
    require(launches["late_gather"] == len(buckets)
            and launches["frontier_expand"] > 0
            and launches["frontier_pull"] == launches["spmm_segment"]
            == launches["embedding_bag"] == 0,
            f"weighted buckets: launches {launches}")
    for i, root in enumerate(roots):
        require_equal(out[i], run_query(q, ds, root),
                      f"weighted buckets root {root}",
                      "the single-root card run")
    return {"engine": "precursive", "workload": "shortest_path",
            "buckets": len(buckets), "lanes": len(roots),
            "launches": launches,
            "warm_ms": warm_latency_ms(
                lambda: run_query_buckets(q, ds, buckets)),
            "card": card}, launches


def value_batch_phase(ds, ds_paper, cols: dict, levels: list, values: dict,
                      id_to_pos, card: str, by_path: dict) -> None:
    """The weighted batches on ``ds`` and the value-engine batches on
    ``ds_paper`` (:func:`make_value_batches`), each through
    :func:`run_batch` with its counters zeroed just before it, summed
    into the ``batch_values`` path; a profile line for the aggregate_sum
    ``bitmap`` batch and the ``rowstore`` batch; then the weighted
    ``run_query_buckets`` call (``weighted_buckets``)."""
    t0 = time.perf_counter()
    weighted, value = make_value_batches(cols, SPEC.num_vertices)
    by_path["batch_values"] = dict.fromkeys(KERNEL_OPS, 0)
    lines = {}
    for on, batches in ((ds, weighted), (ds_paper, value)):
        for b in batches:
            line = run_batch(on, b, levels, card, id_to_pos, values)
            lines[str(b)] = line
            for name, n in line["launches"].items():
                by_path["batch_values"][name] += n
            print("batch: " + json.dumps(line))
    eight = list(weighted[0].roots)
    for on, b in ((ds, Batch("bitmap", "outbound", tuple(eight),
                             "aggregate_sum")),
                  (ds_paper, Batch("rowstore", "outbound", tuple(eight)))):
        q = query(b.engine, b.direction, b.workload)

        def batch_call(q=q, on=on):
            return run_query_batch(q, on, eight)
        print("profile: " + json.dumps({**profile_call(
            f"batch {b}", batch_call, lines[str(b)]["warm_ms"]),
            "card": card}))
    line, by_path["weighted_buckets"] = run_weighted_buckets(ds, eight, card)
    print("weighted buckets: " + json.dumps(line))
    torch.cuda.empty_cache()
    print(f"weighted and value batches: {len(weighted) + len(value)} "
          f"batches in {time.perf_counter() - t0:.3f} s (host clock)")


# ---------------------------------------------------------------------------
# MS-BFS (run_query_multi) and the bucket executor
# ---------------------------------------------------------------------------

MQ_DEPTH_CAPS = {0: 2, 1: 5, 5: 2, 9: 5}   # lane -> its depth cap
EVICT_RESULT_CAP = 1 << 12     # root 0's lane overflows it, leaf lanes not
BUCKET_SPLIT = 4               # run_query_buckets: four buckets of 8


def mq_query(direction: str = "outbound", caps: EngineCaps | None = None
             ) -> RecursiveQuery:
    return RecursiveQuery("multiquery", MAX_DEPTH, SPEC.payload_cols,
                          caps or CAPS, direction=direction,
                          lanes=BUCKET_ROOTS)


def timed(label: str, fn, card: str) -> dict:
    """Warm ms (host median of 3), then busy ms, launches, idle share and
    the costliest device ops from one ``torch.profiler`` session of
    ``fn``."""
    warm = warm_latency_ms(fn)
    prof = profile_call(label, fn, warm)
    return {**exp_numbers(warm, prof), "top": prof["top"][:5],
            "card": card}


def run_multiquery(ds, ds_cpu, roots: list, direction: str, levels: list,
                   card: str) -> tuple[dict, object, dict]:
    """One ``run_query_multi`` over the serving bucket's roots, with the
    counters zeroed just before and read just after (``late_gather`` once,
    nothing else), every lane the same rows as lane i of the card's
    ``diropt`` batch over the same roots, root 0's lane equal to the BFS
    oracle, and (``ds_cpu`` given) the whole result equal to the port's
    CPU run.  Returns the ``multiquery:`` line, the result and the
    launches."""
    q = mq_query(direction)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    got = run_query_multi(q, ds, roots)
    launches = read_launches()
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0), "late_gather": 1},
            f"multiquery {direction}: launches {launches}, want one "
            f"late_gather")
    dq = query("diropt", direction)
    batch = run_query_batch(dq, ds, roots)
    check_result_shape(result_lane(got, 0), CAPS, f"multiquery {direction}")
    for i, root in enumerate(roots):
        label = f"multiquery {direction} lane {i} root {root}"
        lane = result_lane(got, i)
        require_same_rows(lane, result_lane(batch, i), label,
                          "the diropt batch")
        if direction == "outbound" and root == 0:
            check_root0(lane, levels, SPEC, label)
    cpu_s = None
    if ds_cpu is not None:
        t0 = time.perf_counter()
        require_equal(got, run_query_multi(q, ds_cpu, roots),
                      f"multiquery {direction}")
        cpu_s = time.perf_counter() - t0
    mq = timed(f"multiquery {direction} x{len(roots)}",
               lambda: run_query_multi(q, ds, roots), card)
    lockstep = timed(f"batch diropt {direction} x{len(roots)}",
                     lambda: run_query_batch(dq, ds, roots), card)
    line = {"direction": direction, "lanes": len(roots),
            "levels": int(got.depth.max()),
            "rows": int(got.count.sum()), **mq,
            "busy_ms_per_root": mq["busy_ms"] / len(roots),
            "peak_mib": peak_mib, "cpu_run_s": cpu_s,
            "diropt_batch": {k: lockstep[k] for k in ("warm_ms", "busy_ms",
                                                      "launches",
                                                      "idle_share", "top")},
            "busy_ratio_vs_diropt_batch": mq["busy_ms"] / lockstep["busy_ms"]}
    return line, got, launches


def run_multiquery_caps(ds, roots: list, full) -> dict:
    """``run_query_multi`` with ``lane_limits`` capping the lanes of
    MQ_DEPTH_CAPS: each capped lane equal to ``diropt`` at that
    ``max_depth`` on the card, every other lane to the uncapped run."""
    limits = [MQ_DEPTH_CAPS.get(i, MAX_DEPTH) for i in range(len(roots))]
    reset_launches()
    got = run_query_multi(mq_query(), ds, roots, limits)
    launches = read_launches()
    for i, root in enumerate(roots):
        label = f"multiquery depth caps lane {i} root {root}"
        if limits[i] < MAX_DEPTH:
            want = run_query(RecursiveQuery("diropt", limits[i],
                                            SPEC.payload_cols, CAPS), ds,
                             root)
            require_same_rows(result_lane(got, i), want, label,
                              f"diropt at max_depth {limits[i]}")
        else:
            require_same_rows(result_lane(got, i), result_lane(full, i),
                              label, "the uncapped run")
    print("multiquery depth caps: " + json.dumps(
        {"lane_caps": MQ_DEPTH_CAPS, "lane_depths": got.depth.tolist(),
         "launches": launches}))
    return launches


def run_eviction(ds, roots: list, full) -> dict:
    """``dispatch_buckets`` on one MS-BFS bucket of the roots at result cap
    EVICT_RESULT_CAP, fallback CAPS: exactly the lanes whose rows exceed
    the cap (root 0's among them) are evicted, each then equal to
    ``diropt`` at the fallback caps, and every other lane keeps its
    bucket-caps rows."""
    small = EngineCaps(CAPS.frontier, EVICT_RESULT_CAP)
    over = [c > EVICT_RESULT_CAP for c in full.count.tolist()]
    require(over[0] and not all(over),
            f"eviction: lanes over the cap {over}, want root 0's and not "
            f"all")
    bucket = types.SimpleNamespace(indices=tuple(range(len(roots))),
                                   roots=tuple(roots), caps=small)

    def dispatch(i, b, caps):
        return run_query_multi(mq_query("outbound", caps), ds, list(b.roots))
    before, timings = lane_eviction_count(), []
    reset_launches()
    out = dispatch_buckets([bucket], dispatch, fallback_caps=CAPS,
                           observer=timings.append)
    launches = read_launches()
    evicted = lane_eviction_count() - before
    require(evicted == sum(over) == timings[0].evicted_lanes
            and not timings[0].retried,
            f"eviction: {evicted} lanes evicted, {sum(over)} overflowed")
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0),
                         "late_gather": 1 + evicted},
            f"eviction: launches {launches}")
    for i, root in enumerate(roots):
        caps = CAPS if over[i] else small
        want = run_query(RecursiveQuery("diropt", MAX_DEPTH,
                                        SPEC.payload_cols, caps), ds, root)
        require_same_rows(out[i], want, f"eviction lane {i} root {root}",
                          f"diropt at caps {tuple(caps)}")
    print("multiquery eviction: " + json.dumps(
        {"result_cap": EVICT_RESULT_CAP, "fallback_caps": list(CAPS),
         "evicted_lanes": [i for i, o in enumerate(over) if o],
         "lane_eviction_count_delta": evicted, "launches": launches}))
    return launches


def run_buckets(ds, roots: list, card: str) -> tuple[dict, dict]:
    """``run_query_buckets`` of ``precursive`` over the roots cut into
    BUCKET_SPLIT buckets: every root's result bit-equal to its single-root
    card run, ``late_gather`` once a bucket.  Returns the ``buckets:``
    line (beside the one 32-root batch) and the launches."""
    q = query("precursive")
    size = len(roots) // BUCKET_SPLIT
    buckets = [types.SimpleNamespace(indices=tuple(range(k, k + size)),
                                     roots=tuple(roots[k:k + size]),
                                     caps=CAPS)
               for k in range(0, len(roots), size)]
    reset_launches()
    out = run_query_buckets(q, ds, buckets)
    launches = read_launches()
    require(launches["late_gather"] == len(buckets)
            and launches["frontier_expand"] > 0
            and launches["frontier_pull"] == launches["spmm_segment"]
            == launches["embedding_bag"] == 0,
            f"buckets: launches {launches}")
    for i, root in enumerate(roots):
        require_equal(out[i], run_query(q, ds, root),
                      f"buckets root {root}", "the single-root card run")
    line = {"engine": "precursive", "buckets": len(buckets),
            "lanes": len(roots), "launches": launches,
            **timed(f"buckets precursive {len(buckets)} x{size}",
                    lambda: run_query_buckets(q, ds, buckets), card),
            "one_batch": timed(f"batch precursive x{len(roots)}",
                               lambda: run_query_batch(q, ds, roots),
                               card)}
    return line, launches


def multiquery_phase(ds, cols: dict, levels: list, card: str,
                     by_path: dict) -> None:
    """MS-BFS over the serving bucket on ``ds`` (the card's dataset of
    ``cols``), held against the diropt batch over the same roots and,
    outbound, against the CPU run; then its per-lane depth caps, the
    bucket executor's eviction of its overflowing lanes, and
    ``run_query_buckets``; each call's counters zeroed just before it and
    added to ``by_path`` (``multiquery``, ``buckets``)."""
    t_mq = time.perf_counter()
    ds_cpu = dataset_from_numpy(cols, SPEC.num_vertices, "cpu")
    bucket_roots = list(make_batches(cols, SPEC.num_vertices)[-1].roots)
    by_path["multiquery"] = dict.fromkeys(KERNEL_OPS, 0)
    mq_full = None
    for direction in ("outbound", "inbound", "both"):
        line, got_mq, launches = run_multiquery(
            ds, ds_cpu if direction == "outbound" else None,
            bucket_roots, direction, levels, card)
        print("multiquery: " + json.dumps(line))
        for name, n in launches.items():
            by_path["multiquery"][name] += n
        if direction == "outbound":
            mq_full = got_mq
        del got_mq
    for launches in (run_multiquery_caps(ds, bucket_roots, mq_full),
                     run_eviction(ds, bucket_roots, mq_full)):
        for name, n in launches.items():
            by_path["multiquery"][name] += n
    del mq_full
    line, by_path["buckets"] = run_buckets(ds, bucket_roots, card)
    print("buckets: " + json.dumps(line))
    print(f"multiquery and buckets: {time.perf_counter() - t_mq:.3f} s "
          f"(host clock)")


# ---------------------------------------------------------------------------
# the planner path: SQL in, engine chosen by cost, result out
# ---------------------------------------------------------------------------

# calibrate's micro-benchmark of each kernel factor
MEASURE_FNS = {"frontier_expand": "_measure_expand_factor",
               "frontier_pull": "_measure_pull_factor",
               "spmm_segment": "_measure_spmm_factor"}

PLANNER_QUERIES = (
    ("listing 1", paper_listing(1, root=0, depth=MAX_DEPTH)),
    ("listing 2", paper_listing(2, root=0, depth=MAX_DEPTH,
                                payload_cols=SPEC.payload_cols)),
    ("listing 3", paper_listing(3, root=0, depth=MAX_DEPTH)),
    ("shortest_path", weighted_listing("shortest_path", depth=MAX_DEPTH,
                                       weight_col=WEIGHT_COL)),
    ("aggregate_sum", weighted_listing("aggregate_sum", depth=MAX_DEPTH,
                                       weight_col=WEIGHT_COL)),
)


def ranking(report) -> list:
    """A planner report's ranked labels with their prices, and its skipped
    candidates with their reasons."""
    return ([(c.label, c.cost.est_us) for c in report.ranked],
            list(report.skipped))


def require_dressed(got, want, choice, label: str, other: str) -> None:
    """A planner result (dressed: the requested columns, ``depth`` and,
    weighted, ``value``) against an undressed ``run_query`` result of the
    same query: every field equal, each requested column equal to
    ``want``'s, ``depth`` to its row depths and ``value`` to the value
    plane at each row's target, all bit for bit."""
    for field in ("positions", "count", "depth", "overflow", "row_depths",
                  "level_dirs", "vertex_values"):
        x, y = getattr(got, field), getattr(want, field)
        require((x is None and y is None) or (
            x is not None and y is not None and x.dtype == y.dtype
            and torch.equal(x, y)), f"{label}: field {field} differs from "
            f"{other}")
    dressed = {k: want.values[k] for k in choice.logical.want_cols}
    if choice.logical.want_depth:
        dressed["depth"] = want.row_depths
    if choice.logical.workload != "reach":
        dressed["value"] = want.vertex_values[
            want.values["to"].long().clamp(0, SPEC.num_vertices - 1)]
    require(got.values.keys() == dressed.keys(),
            f"{label}: columns {sorted(got.values)}, want "
            f"{sorted(dressed)}")
    for k, v in dressed.items():
        require(torch.equal(got.values[k], v),
                f"{label}: column {k} differs from {other}")


def require_live_rows(got, want, label: str, other: str) -> None:
    """Two results of one root at different caps: the loop accounting and
    the live rows, ``want``'s count of them, bit for bit, compared on
    ``got``'s device."""
    n = int(want.count)
    for field in ("count", "depth", "overflow", "level_dirs"):
        x, y = getattr(got, field), getattr(want, field)
        require((x is None and y is None) or (
            x is not None and y is not None
            and torch.equal(x, y.to(x.device))),
            f"{label}: field {field} differs from {other}")
    for field in ("positions", "row_depths"):
        x = getattr(got, field)
        require(torch.equal(x[:n], getattr(want, field)[:n].to(x.device)),
                f"{label}: live {field} differ from {other}")
    require(got.values.keys() == want.values.keys(), f"{label}: columns")
    for k, v in want.values.items():
        x = got.values[k]
        require(torch.equal(x[:n], v[:n].to(x.device)),
                f"{label}: live column {k} differs from {other}")


def counted_into(path: dict, fn):
    """``fn()`` with the launch counters zeroed just before and read just
    after, the reading added to ``path``'s counts; returns (result,
    reading)."""
    reset_launches()
    out = fn()
    launches = read_launches()
    for name, n in launches.items():
        path[name] += n
    return out, launches


def planner_request(choice, root: int) -> Request:
    return Request(choice.engine, choice.query.direction, root,
                   choice.query.workload)


def planner_phase(ds, ds_cpu, cols: dict, levels: list, values: dict,
                  card: str, by_path: dict) -> None:
    """The cost-based planner through its entry points on the deployment's
    table with ``w``: the statistics of each direction on the card equal to
    the CPU dataset's; five queries planned (the same ranking and prices
    as on the CPU), their picks run (bit-equal to ``run_query`` of the
    chosen engine, root 0 to the BFS and path oracles, launches equal to
    the levels that call each kernel); listing 1 over the eight batch roots
    and the 32 serving roots in reach buckets (each root against the CPU
    dataset's run, root 0 against the oracle, launches exact); the three
    measured kernel factors and the ``precursive+kernel`` candidate they
    price (against the oracle, and its expansion kernel at the
    candidate's capacity against the plain version); the admission guards
    over the serving roots.  Every counted run adds to
    ``by_path["planner"]``."""
    t_phase = time.perf_counter()
    nv = SPEC.num_vertices
    by_path["planner"] = dict.fromkeys(KERNEL_OPS, 0)

    def counted(fn):
        return counted_into(by_path["planner"], fn)

    stats_ms = {}
    for d in ("outbound", "inbound", "both"):
        t0 = time.perf_counter()
        st = ds.stats(d)
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        st_cpu = ds_cpu.stats(d)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        require(dataclasses.asdict(st) == dataclasses.asdict(st_cpu),
                f"planner stats {d}: the card dataset's differ from the "
                f"CPU dataset's")
        stats_ms[d] = {"ms": card_ms, "cpu_dataset_ms": cpu_ms,
                       "is_forest": st.is_forest, "levels": st.max_levels,
                       "max_level_edges": st.max_level_edges}
    print("planner stats: " + json.dumps({**stats_ms, "card": card}))

    chosen = {}
    for label, sql in PLANNER_QUERIES:
        report = plan(sql, ds, constants=DEFAULT_CONSTANTS)
        require(ranking(report) == ranking(plan(sql, ds_cpu,
                                                constants=DEFAULT_CONSTANTS)),
                f"planner {label}: the ranking differs from the CPU "
                f"dataset's")
        best = chosen[label] = report.best
        got, launches = counted(lambda: best.run(ds, 0))
        want = run_query(best.query, ds, 0)
        require_dressed(got, want, best, f"planner {label}",
                        f"run_query of {best.label}")
        check_root0(got, levels, SPEC, f"planner {label}")
        if best.query.workload != "reach":
            require(torch.equal(got.vertex_values.cpu(), torch.from_numpy(
                values[best.query.workload])),
                f"planner {label}: vertex values differ from the path "
                f"oracle")
        req = planner_request(best, 0)
        require(launches == expected_launches([req], [want], nv),
                f"planner {label}: launches {launches}, want "
                f"{expected_launches([req], [want], nv)}")
        plan_ms = statistics.median(
            timed_ms(lambda: plan(sql, ds)) for _ in range(3))
        line = {"query": label, "chosen": best.label,
                "top3": ranking(report)[0][:3], "plan_ms": plan_ms,
                "plan_and_run_warm_ms": warm_latency_ms(
                    lambda: plan_and_run(sql, ds, 0)),
                "run_query_warm_ms": warm_latency_ms(
                    lambda: run_query(best.query, ds, 0)),
                "caps": list(best.query.caps), "launches": launches,
                "card": card}
        line["planner_overhead_ms"] = (line["plan_and_run_warm_ms"]
                                       - line["run_query_warm_ms"])
        print("planner: " + json.dumps(line))

    # batches: listing 1 over the eight batch roots in one dispatch, and
    # the 32 serving roots in reach buckets
    sql1 = PLANNER_QUERIES[0][1]
    best = chosen["listing 1"]
    eight = batch_roots(cols, nv)
    got, launches = counted(lambda: plan_and_run(sql1, ds, eight))
    want = run_query_batch(best.query, ds, eight)
    lane_levels = []
    for i, root in enumerate(eight):
        require_dressed(result_lane(got, i), result_lane(want, i), best,
                        f"planner batch lane {i} root {root}",
                        "run_query_batch of the chosen engine")
        lane_levels.append(launch_levels(planner_request(best, root),
                                         result_lane(want, i), nv))
    # each per-level kernel once on each level where some lane calls it,
    # one take of every lane's rows
    want_launches = {**dict.fromkeys(KERNEL_OPS, 0), "late_gather": 1,
                     **{k: len(set().union(*(lv[k] for lv in lane_levels)))
                        for k in LEVEL_KERNELS}}
    require(launches == want_launches, f"planner batch: launches "
            f"{launches}, want {want_launches}")
    serving = list(make_batches(cols, nv)[-1].roots)
    buckets = plan_buckets(ds, serving, direction=best.query.direction,
                           max_depth=best.query.max_depth,
                           dedup=best.query.dedup, caps=best.query.caps)
    got_b, launches_b = counted(lambda: best.run_bucketed(ds, serving))
    # every root against the port's CPU run (plain versions, no kernel),
    # root 0 also against the BFS oracle
    cpu_b = [best.run(ds_cpu, root) for root in serving]
    for root, r, w in zip(serving, got_b, cpu_b):
        require_live_rows(r, w, f"planner bucket root {root}",
                          "its single-root CPU run")
    check_root0(got_b[serving.index(0)], levels, SPEC, "planner bucket "
                "root 0")
    # a bucket whose lanes outgrow its caps is dispatched again at the
    # plan's caps; these buckets hold their lanes, so one dispatch each:
    # one take, and each per-level kernel once on each level where some
    # lane of the bucket calls it
    for b in buckets:
        require(all(int(cpu_b[i].count) <= b.caps.result
                    for i in b.indices),
                f"planner buckets: a lane of the bucket with caps "
                f"{tuple(b.caps)} outgrows them")
    want_b = bucket_launches(((b, best) for b in buckets), cpu_b, serving)
    require(launches_b == want_b, f"planner buckets: launches "
            f"{launches_b}, want {want_b}")
    print("planner batches: " + json.dumps({
        "chosen": best.label, "batch_roots": eight,
        "batch_launches": launches, "serving_roots": len(serving),
        "buckets": [{"lanes": len(b.indices), "padded": len(b.roots),
                     "caps": list(b.caps),
                     "predicted_reach": b.predicted_reach}
                    for b in buckets],
        "bucket_launches": launches_b, "card": card}))

    # the measured kernel factors, then the kernel candidate they price
    factors = {}
    for kernel, name in MEASURE_FNS.items():
        # the micro-benchmark's (kernel, plain) microseconds, read as
        # measured_kernel_factor takes them
        measure, times = getattr(calibrate, name), []

        def recorded(device, measure=measure, times=times):
            times.append(measure(device))
            return times[-1]
        setattr(calibrate, name, recorded)
        try:
            factor = calibrate.measured_kernel_factor(kernel=kernel)
        finally:
            setattr(calibrate, name, measure)
        require(len(times) == 1, f"planner factor {kernel}: measured "
                f"{len(times)} times")
        t_kern, t_plain = times[0]
        require(factor == float(np.clip(t_kern / t_plain, 1e-3, 1e6))
                and calibrate.measured_factors_state()[f"cuda/{kernel}"]
                == factor, f"planner factor {kernel}: not the ratio of "
                f"its times, or not cached on cuda")
        factors[kernel] = {"factor": factor, "kernel_us": t_kern,
                           "plain_us": t_plain}
    print("planner factors: " + json.dumps({**factors, "card": card}))
    report = plan(sql1, ds, include_kernel=True)
    require(report.constants.kernel_factor
            == factors["frontier_expand"]["factor"],
            "planner kernel candidate: not priced with the measured factor")
    rank, kern = next((i, c) for i, c in enumerate(report.ranked)
                      if c.use_kernel)
    got, launches = counted(lambda: kern.run(ds, 0))
    want = run_query(kern.query, ds, 0)
    require_dressed(got, want, kern, "planner precursive+kernel",
                    "run_query of precursive")
    check_root0(got, levels, SPEC, "planner precursive+kernel")
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0),
                         "frontier_expand": int(want.depth),
                         "late_gather": 1},
            f"planner precursive+kernel: launches {launches}")
    # the expansion kernel at the capacity the planner gives it, root 0's
    # widest level, against its plain version
    capacity = kern.query.caps.frontier
    require(kern.query.direction == "outbound",
            "planner precursive+kernel: not outbound")
    targets, valid, level, emitted = widest_level(got, cols, capacity)
    t, v = targets.to(DEVICE), valid.to(DEVICE)
    got_fe = fe_ops.frontier_expand_fused(ds.csr, t, v, capacity)
    want_fe = expand_frontier(ds.csr, t, v, capacity)
    torch.cuda.synchronize()
    for g, w, name in zip(got_fe, want_fe, ("positions", "total",
                                            "overflow")):
        require(g.dtype == w.dtype and torch.equal(g, w),
                f"planner frontier_expand at capacity {capacity}: {name} "
                f"differs from the plain version")
    require(int(got_fe[1]) == emitted, f"planner frontier_expand at "
            f"capacity {capacity}: level total")
    print("planner kernel candidate: " + json.dumps({
        "label": kern.label, "rank": rank, "est_us": kern.cost.est_us,
        "best": report.best.label, "launches": launches,
        "caps": list(kern.query.caps),
        "frontier_expand_check": {"capacity": capacity, "level": level,
                                  "live": int(valid.sum()),
                                  "emitted": emitted},
        "card": card}))

    # the admission guards over the serving roots
    guards = admit_roots(ds, best.query.direction, serving, MAX_DEPTH,
                         DEFAULT_CONSTANTS)
    guards_cpu = admit_roots(ds_cpu, best.query.direction, serving,
                             MAX_DEPTH, DEFAULT_CONSTANTS)
    require([tuple(g) for g in guards] == [tuple(g) for g in guards_cpu],
            "planner guards: the card dataset's decisions differ from the "
            "CPU dataset's")
    print("planner guards: " + json.dumps({
        d: sum(g.decision == d for g in guards)
        for d in ("traverse", "degrade", "reject")}))
    print(f"planner path: {time.perf_counter() - t_phase:.3f} s (host "
          f"clock); launches {json.dumps(by_path['planner'])}")


# ---------------------------------------------------------------------------
# the serving layer (repro_torch.planner.serving) on the card
# ---------------------------------------------------------------------------

SERVING_WARM = 3               # checked warm submits of the 32 roots
TRACER_REPS = 5                # warm submits each with the tracer on and off
REFIT_MAX_ROUNDS = 30          # rounds of the request mix toward a refit
STRAGGLER_SLEEP_S = 0.05       # straggler_sleep against DEADLINE_US
DEADLINE_US = 20_000.0
ENTRY_ARGS = ("--traversal", "--vertices", str(1 << 20), "--height", "16",
              "--depth", "16", "--batch", "8", "--requests", "16")


def require_lanes(got: list, want: list, label: str,
                  other: str = "the CPU session's") -> None:
    """Served lanes (host tensors) against another session's, field for
    field and bit for bit."""
    require(len(got) == len(want), f"{label}: {len(got)} lanes, want "
            f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        require_equal(g, w, f"{label} lane {i}", other)


def bucket_launches(buckets, lanes: list, roots: list) -> dict:
    """The launches one dispatch of ``buckets``, (bucket, choice) pairs,
    makes, read off the lanes of a CPU run of ``roots``: for each bucket
    one take of every lane's rows
    (on the tuple and row-store engines one a level of the deepest lane,
    one for the seed blocks and one more for a rewrite's join), and each
    per-level kernel once on each level where some lane of the bucket
    calls it (:func:`launch_levels`); MS-BFS calls no per-level kernel."""
    want = dict.fromkeys(KERNEL_OPS, 0)
    nv = SPEC.num_vertices
    for b, c in buckets:
        rs = [lanes[i] for i in b.indices]
        if c.engine in VALUE_ENGINE_NAMES:
            want["late_gather"] += (max(int(r.depth) for r in rs) + 1
                                    + c.engine.endswith("_rewrite"))
        else:
            want["late_gather"] += 1
        if c.engine == "multiquery":
            continue
        lv = [launch_levels(Request(c.engine, c.query.direction, roots[i],
                                    c.query.workload), lanes[i], nv)
              for i in b.indices]
        for k in LEVEL_KERNELS:
            want[k] += len(set().union(*(x[k] for x in lv)))
    return want


def entry_line(entry) -> list:
    return [{"engine": c.label, "lanes": len(b.indices),
             "padded": len(b.roots), "caps": list(b.caps)}
            for b, c in zip(entry.buckets, entry.bucket_choices)]


def quantile(ms: list, q: float) -> float:
    """The ``q`` quantile of a sample by linear interpolation."""
    return float(np.quantile(np.asarray(ms), q))


def serving_phase(ds, ds_cpu, cols: dict, levels: list, values: dict,
                  id_to_pos, card: str, by_path: dict) -> None:
    """:func:`serving_checks` with a temporary directory for its plan
    stores and traces, removed after."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="serving_") as tmp:
        serving_checks(ds, ds_cpu, cols, levels, values, id_to_pos, card,
                       by_path, tmp)


def serving_checks(ds, ds_cpu, cols: dict, levels: list, values: dict,
                   id_to_pos, card: str, by_path: dict, tmp: str) -> None:
    """The traversal serving layer through its entry points on the
    deployment's table with ``w``: coalesced submits of listing 1 over the
    32 serving roots (cold, then warm) and of aggregate_sum over the eight
    batch roots, every lane bit-equal to a CPU session's, root 0 to the
    BFS and path oracles, the buckets' engines and the plan equal to the
    CPU session's, and each kernel's launches exactly what the buckets'
    engines and levels imply; ``enqueue`` x 32 + ``flush`` (one coalesced
    dispatch); a plan store saved and rehydrated (zero planning passes,
    the same lanes); EXPLAIN and EXPLAIN ANALYZE against the CPU
    dataset's; the first calibrator refit on the card; a traced warm
    request checked by the port's ``check_trace``, and the tracer's cost;
    the admission ladder and a deadline that skips buckets under an
    injected straggler; and ``serve_traversals`` run twice, the second
    rehydrated.  Every counted run adds to ``by_path["serving"]``."""
    import contextlib
    import io

    from repro_torch.launch import serve as serve_mod
    from repro_torch.obs import Tracer, faultinject, read_jsonl
    from repro_torch.obs.check_trace import check_trace

    t_phase = time.perf_counter()
    nv = SPEC.num_vertices
    by_path["serving"] = dict.fromkeys(KERNEL_OPS, 0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def counted(fn):
        return counted_into(by_path["serving"], fn)

    def timed_counted(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches = counted(fn)
        return out, launches, (time.perf_counter() - t0) * 1e3

    sql1 = PLANNER_QUERIES[0][1]
    sql_sum = PLANNER_QUERIES[4][1]
    serving = list(make_batches(cols, nv)[-1].roots)
    eight = batch_roots(cols, nv)

    # coalesced submits: one session on the card, one on the CPU dataset
    sess = ServingSession(ds, calibrate_every=0)
    sess_cpu = ServingSession(ds_cpu, calibrate_every=0)
    got, launches, cold_ms = timed_counted(lambda: sess.submit(sql1,
                                                               serving))
    want = sess_cpu.submit(sql1, serving)
    entry = sess.plan_for(sql1, serving)
    entry_cpu = sess_cpu.plan_for(sql1, serving)
    require([c.label for c in entry.bucket_choices]
            == [c.label for c in entry_cpu.bucket_choices]
            and entry.bucket_signature == entry_cpu.bucket_signature,
            "serving: the buckets or their engines differ from the CPU "
            "session's")
    require(sess.plan_json(sql1, serving) == sess_cpu.plan_json(sql1,
                                                                serving),
            "serving: plan_json differs from the CPU session's")
    rep, rep_cpu = sess.last_report, sess_cpu.last_report
    require([g.to_json() for g in rep.admission]
            == [g.to_json() for g in rep_cpu.admission],
            "serving: the admission decisions differ from the CPU "
            "session's")
    require((rep.retries, rep.evictions, rep.truncated)
            == (rep_cpu.retries, rep_cpu.evictions, False) == (0, 0, False),
            f"serving: the request was retried, evicted or truncated "
            f"({rep}); the launch counts below assume one dispatch a "
            f"bucket")
    want_launches = bucket_launches(
        zip(entry.buckets, entry.bucket_choices), want, serving)
    require_lanes(got, want, "serving listing 1 cold")
    i0 = serving.index(0)
    c0 = next(c for b, c in zip(entry.buckets, entry.bucket_choices)
              if i0 in b.indices)
    check_root0(got[i0], levels, SPEC, "serving listing 1 root 0",
                real_positions(c0.engine, got[i0], id_to_pos))
    require(launches == want_launches, f"serving cold: launches "
            f"{launches}, want {want_launches}")
    warm_ms = []
    for k in range(SERVING_WARM):
        got_w, launches_w, ms = timed_counted(lambda: sess.submit(sql1,
                                                                  serving))
        require_lanes(got_w, want, f"serving listing 1 warm {k}")
        require(launches_w == want_launches, f"serving warm {k}: launches "
                f"{launches_w}, want {want_launches}")
        warm_ms.append(ms)
    got_s, launches_s = counted(lambda: sess.submit(sql_sum, eight))
    want_s = sess_cpu.submit(sql_sum, eight)
    entry_s = sess.plan_for(sql_sum, eight)
    require([c.label for c in entry_s.bucket_choices]
            == [c.label for c in sess_cpu.plan_for(sql_sum, eight)
                .bucket_choices]
            and sess.plan_json(sql_sum, eight)
            == sess_cpu.plan_json(sql_sum, eight),
            "serving aggregate_sum: buckets or plan differ from the CPU "
            "session's")
    require_lanes(got_s, want_s, "serving aggregate_sum")
    check_root0(got_s[0], levels, SPEC, "serving aggregate_sum root 0")
    require(torch.equal(got_s[0].vertex_values,
                        torch.from_numpy(values["aggregate_sum"])),
            "serving aggregate_sum root 0: vertex values differ from the "
            "path oracle")
    want_ls = bucket_launches(
        zip(entry_s.buckets, entry_s.bucket_choices), want_s, eight)
    require(launches_s == want_ls, f"serving aggregate_sum: launches "
            f"{launches_s}, want {want_ls}")
    best = plan(sql1, ds).best
    pr_ms = warm_latency_ms(lambda: plan_and_run(sql1, ds, serving))
    batch_ms = warm_latency_ms(lambda: run_query_batch(best.query, ds,
                                                       serving))
    st = sess.stats

    # enqueue x 32 + flush: one coalesced dispatch
    tickets = [sess.enqueue(sql1, r) for r in serving]
    require(sess.stats["pending_requests"] == len(serving),
            "serving enqueue: pending count")
    n, launches_f = counted(sess.flush)
    require(n == 1, f"serving flush: {n} dispatches, want 1")
    require_lanes([t.result() for t in tickets], want, "serving flush")
    require(launches_f == want_launches, f"serving flush: launches "
            f"{launches_f}, want {want_launches}")
    stf = sess.stats
    require((stf["coalesced_dispatches"], stf["coalesced_roots"],
             stf["pending_requests"]) == (1, len(serving), 0),
            f"serving flush: coalesced counters {stf}")
    print("serving: " + json.dumps({
        "query": "listing 1", "roots": len(serving),
        "buckets": entry_line(entry), "cold_ms": cold_ms,
        "warm_ms": warm_ms, "warm_ms_per_root": statistics.median(warm_ms)
        / len(serving),
        "roots_per_s": len(serving) / statistics.median(warm_ms) * 1e3,
        "plan_and_run_warm_ms": pr_ms, "run_query_batch_warm_ms": batch_ms,
        "batch_engine": best.label, "launches": want_launches,
        "aggregate_sum": {"roots": len(eight),
                          "buckets": entry_line(entry_s),
                          "launches": launches_s},
        "plan_hit_rate": st["plan_hit_rate"],
        "admission": {d: st[f"admission_{d}"]
                      for d in ("traverse", "degrade", "reject")},
        "flush": {"dispatches": n, "coalesced_roots":
                  stf["coalesced_roots"]}, "card": card}))
    print("profile: " + json.dumps({**profile_call(
        f"serving listing 1 x{len(serving)} warm",
        lambda: sess.submit(sql1, serving), statistics.median(warm_ms)),
        "card": card}))

    # the plan store: saved, then a new card session rehydrated from it
    path = f"{tmp}/plans.json"
    sess.save_plan_store(path)
    warm_sess = ServingSession(ds, calibrate_every=0, plan_store=path)
    (got_r, got_rs), launches_r = counted(lambda: (
        warm_sess.submit(sql1, serving), warm_sess.submit(sql_sum, eight)))
    require(warm_sess.counters == {"parse_calls": 0, "stats_calls": 0,
                                   "cost_calls": 0},
            f"serving store: the rehydrated session paid planning "
            f"{warm_sess.counters}")
    require_lanes(got_r, got, "serving store listing 1", "the cold "
                  "session's")
    require_lanes(got_rs, got_s, "serving store aggregate_sum",
                  "the cold session's")
    require(launches_r == {k: want_launches[k] + want_ls[k]
                           for k in KERNEL_OPS},
            f"serving store: launches {launches_r}")
    print("serving store: " + json.dumps({
        "bytes": Path(path).stat().st_size,
        "plans": len(warm_sess._plans),
        "counters": warm_sess.counters, "launches": launches_r,
        "card": card}))

    # EXPLAIN and EXPLAIN ANALYZE against the CPU dataset's
    require(explain(sql1, ds) == explain(sql1, ds_cpu)
            and explain_json(sql1, ds) == explain_json(sql1, ds_cpu),
            "serving explain: differs from the CPU dataset's")
    doc, launches_a = counted(lambda: explain_analyze(sql1, ds, root=0))
    doc_cpu = explain_analyze(sql1, ds_cpu, root=0)
    elapsed = doc["analyze"].pop("elapsed_us")
    elapsed_cpu = doc_cpu["analyze"].pop("elapsed_us")
    require(doc == doc_cpu, "serving explain_analyze: differs from the "
            "CPU dataset's")
    require(doc["analyze"]["result_count"] == SPEC.num_edges,
            "serving explain_analyze: root 0 rows")
    sdoc, launches_sa = counted(lambda: sess.explain_analyze(sql1,
                                                             serving))
    seen = sorted(r for b in sdoc["analyze"]["buckets"] for r in b["roots"])
    require(seen == sorted(serving)
            and all(a["actual"]["rows"] == a["result_count"]
                    for b in sdoc["analyze"]["buckets"]
                    for a in b["analyze"]),
            "serving session explain_analyze: roots or actual rows")
    print("serving explain: " + json.dumps({
        "engine": doc["analyze"]["engine"],
        "elapsed_us": elapsed, "cpu_elapsed_us": elapsed_cpu,
        "predicted_rows": doc["analyze"]["predicted"]["rows"],
        "actual_rows": doc["analyze"]["actual"]["rows"],
        "levels_taken": doc["analyze"]["actual"]["level_dirs"],
        "launches": launches_a, "session_launches": launches_sa,
        "card": card}))

    # the first calibrator refit on the card: default calibrate_every, a
    # mix of three request shapes (the 32 roots and the eight under
    # listing 1, the eight under aggregate_sum), served warm until a refit
    # is accepted or REFIT_MAX_ROUNDS rounds have run
    cal_sess = ServingSession(ds)
    # each bucket's BucketTiming as the executor reports it, read beside
    # the session's own observer
    bucket_timings = []
    session_observer = cal_sess._observer

    def tapped_observer(entry, calibrate):
        inner = session_observer(entry, calibrate)

        def observe(t):
            bucket_timings.append(
                (t, entry.bucket_choices[t.index].engine))
            inner(t)
        return observe
    cal_sess._observer = tapped_observer
    mix = ((sql1, serving), (sql1, eight), (sql_sum, eight))
    for sql, roots in mix:                       # cold: not observed
        cal_sess.submit(sql, roots)
    cal_ms, rounds, last_buckets = [], 0, []
    cal = cal_sess.calibrator
    while cal.refits == 0 and rounds < REFIT_MAX_ROUNDS:
        for k, (sql, roots) in enumerate(mix):
            del bucket_timings[:]
            _, _, ms = timed_counted(lambda: cal_sess.submit(sql, roots))
            if k == 0:
                cal_ms.append(ms)
                last_buckets = [{"bucket": t.index, "lanes": t.lanes,
                                 "engine": engine,
                                 "elapsed_us": t.elapsed_us,
                                 "retried": t.retried}
                                for t, engine in bucket_timings]
                last_request_ms = ms
        rounds += 1
    require(len(last_buckets) >= 1 and all(
        b["elapsed_us"] < last_request_ms * 1e3 for b in last_buckets),
        f"serving calibration: bucket timings {last_buckets} against a "
        f"{last_request_ms} ms request")
    require(cal.refits + cal.rejected_refits >= 1,
            f"serving calibration: no refit after {rounds} rounds "
            f"({cal.count} observations)")
    picks = {}
    for label, sql in PLANNER_QUERIES:
        before = plan(sql, ds, constants=DEFAULT_CONSTANTS).best
        after = plan(sql, ds, constants=cal.constants).best
        picks[label] = {"default": before.label, "refit": after.label}
        if after.label != before.label:
            r, _ = counted(lambda: after.run(ds, 0))
            require_equal(r, after.run(ds_cpu, 0), f"serving calibration "
                          f"{label} refit pick {after.label}")
    # what the refits were fitted to: each plan signature's mean measured
    # bucket interval beside the prior's prediction for it
    signatures = [{"engine": sig[0], "caps": [sig[2], sig[3]],
                   "lanes": sig[-4], "dispatches": n,
                   "mean_us": us / n, "levels": levels,
                   "plain_bytes": plain,
                   "prior_us": cal._predict(cal.prior, levels, plain,
                                            kern)}
                  for sig, (n, us, levels, plain, kern)
                  in cal._sig_stats.items()]
    print("serving calibration: " + json.dumps({
        "observations": cal.count, "refits_accepted": cal.refits,
        "refits_rejected": cal.rejected_refits,
        "refits": f"{cal.refits} accepted of "
                  f"{cal.refits + cal.rejected_refits}",
        "rejection": cal.last_rejection,
        "last_32_root_request_ms": last_request_ms,
        "last_32_root_buckets": last_buckets,
        "bucket_elapsed_us_sum": sum(b["elapsed_us"] for b in last_buckets),
        "signatures": signatures,
        "constants": cal.constants._asdict(),
        "prior": DEFAULT_CONSTANTS._asdict(), "picks": picks,
        "rounds": rounds, "warm_requests": len(cal_ms),
        "warm_p50_ms": quantile(cal_ms, 0.5),
        "warm_p99_ms": quantile(cal_ms, 0.99),
        "roots_per_s": len(serving) / quantile(cal_ms, 0.5) * 1e3,
        "card": card}))

    # tracing: one warm request traced and checked, then the tracer's cost
    tracer = Tracer(meta={"phase": "serving"})
    sess.tracer = tracer
    counted(lambda: sess.submit(sql1, serving))
    sess.tracer = None
    trace_path = f"{tmp}/trace.jsonl"
    tracer.write_jsonl(trace_path)
    records = read_jsonl(trace_path)
    errors = check_trace(records, min_spans=5)
    names = {r["name"] for r in records if r.get("type") == "span"}
    require(not errors, f"serving trace: {errors}")
    require({"request", "parse", "plan", "dispatch", "transfer"} <= names,
            f"serving trace: spans {sorted(names)}")
    on_ms, off_ms = [], []
    for _ in range(TRACER_REPS):
        for on, ms in ((False, off_ms), (True, on_ms)):
            sess.tracer = Tracer() if on else None
            _, _, t = timed_counted(lambda: sess.submit(sql1, serving))
            ms.append(t)
    sess.tracer = None
    spans = [r for r in records if r.get("type") == "span"]

    def span_ms(name):
        return sum(r["dur_us"] for r in spans if r["name"] == name) / 1e3
    print("serving trace: " + json.dumps({
        "records": len(records), "spans": sorted(names),
        "request_span_ms": span_ms("request"),
        "transfer_span_ms": span_ms("transfer"),
        "level_event_span_ms": span_ms("dispatch"),
        "events": sum(r.get("type") == "event" for r in records),
        "traced_warm_ms": statistics.median(on_ms),
        "untraced_warm_ms": statistics.median(off_ms),
        "tracer_cost_ms": statistics.median(on_ms)
        - statistics.median(off_ms), "card": card}))

    # the guards and a deadline that skips buckets behind a straggler
    dl = ServingSession(ds, calibrate_every=0)
    dl.submit(sql1, serving)                       # warm the plan
    with faultinject.injected("straggler_sleep", STRAGGLER_SLEEP_S,
                              times=None):
        out, _ = counted(lambda: dl.submit(sql1, serving,
                                           deadline_us=DEADLINE_US))
    rep = dl.last_report
    skipped = set(rep.skipped_roots)
    require(rep.truncated and rep.skipped_buckets >= 1 and skipped,
            f"serving deadline: nothing skipped ({rep})")
    for i, (root, r, w) in enumerate(zip(serving, out, want)):
        if root in skipped:
            require(int(r.count) == 0, f"serving deadline lane {i}: a "
                    f"skipped root has rows")
        else:
            require_equal(r, w, f"serving deadline lane {i}")
    require([g.to_json() for g in rep.admission]
            == [g.to_json() for g in rep_cpu.admission],
            "serving deadline: admission decisions")
    print("serving guards: " + json.dumps({
        "admission": {d: sum(g.decision == d for g in rep.admission)
                      for d in ("traverse", "degrade", "reject")},
        "deadline_us": DEADLINE_US, "skipped_buckets": rep.skipped_buckets,
        "skipped_roots": len(skipped), "served_roots": len(serving)
        - len(skipped), "card": card}))

    # the entry point, twice: the second run rehydrates its store
    entry_store = f"{tmp}/entry_plans.json"
    runs = []
    for k in range(2):
        trace = f"{tmp}/entry_trace_{k}.jsonl"
        argv = [*ENTRY_ARGS, "--plan-store", entry_store, "--trace", trace]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            stats, launches_e = counted(lambda: serve_mod.main(argv))
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        errors = check_trace(read_jsonl(trace), min_spans=5)
        require(not errors, f"serving entry run {k}: trace {errors}")
        runs.append({"seconds": secs, "stats": {
            key: stats[key] for key in (
                "requests", "plan_hits", "plan_misses", "parse_calls",
                "stats_calls", "cost_calls", "latency_us_p50",
                "latency_us_p99", "overflow_retries",
                "overflow_lane_evictions", "calibration_observations")},
            "rehydrated": "(rehydrated)" in text, "launches": launches_e})
    require(not runs[0]["rehydrated"] and runs[1]["rehydrated"],
            "serving entry: the second run did not rehydrate")
    require("planning paid: 0 parse / 0 stats / 0 costing" in text
            and all(runs[1]["stats"][k] == 0 for k in (
                "parse_calls", "stats_calls", "cost_calls")),
            f"serving entry: the rehydrated run paid planning: {text}")
    print("serving entry: " + json.dumps({
        "args": " ".join(ENTRY_ARGS), "runs": runs, "card": card}))
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    print(f"serving path: {time.perf_counter() - t_phase:.3f} s (host "
          f"clock); peak device memory {peak_mib:.1f} MiB above the "
          f"{held / 2 ** 20:.1f} MiB held before the phase; launches "
          f"{json.dumps(by_path['serving'])}")


def timed_ms(fn) -> float:
    """One host-clock run of ``fn`` (host work only: no device to wait
    for)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# the paper's tuple-based and row-store engines, and Exp 1-3
# ---------------------------------------------------------------------------

def inverse_ids(cols: dict) -> torch.Tensor:
    """The position of each id: the inverse of the table's id column (a
    permutation of the edge positions)."""
    ids = torch.from_numpy(cols["id"]).long()
    out = torch.empty_like(ids)
    out[ids] = torch.arange(ids.shape[0])
    return out


def widest_row_block(r, id_to_pos: torch.Tensor, capacity: int,
                     num_rows: int) -> tuple[torch.Tensor, int]:
    """The block of positions that ``rowstore``'s ``take_rows`` gathers at
    the widest level of a root-0 run, rebuilt from its rows: the level's
    positions in ascending order (as the scan compacts them), padded to
    ``capacity`` with the sentinel ``num_rows``.  Returns (positions on
    the CPU, level)."""
    count = int(r.count)
    depth = r.row_depths[:count].cpu()
    level = int(torch.bincount(depth.long()).argmax())
    pos = real_positions("rowstore", r, id_to_pos)[:count][depth == level]
    out = torch.full((capacity,), num_rows, dtype=torch.int32)
    out[:pos.shape[0]] = pos.sort().values.to(torch.int32)
    return out, level


def exp_entry(ds, engine: str, payload_cols: int, spec: TreeSpec,
              levels: list, id_to_pos: torch.Tensor) -> dict:
    """One engine's root 0 outbound at depth 16 on ``ds``: its rows
    checked against the BFS oracle's ``levels``, then its warm ms (median
    of 3, host clock) and its ``torch.profiler`` busy ms, launches and
    idle share."""
    q = query(engine, payload_cols=payload_cols)
    label = f"{engine} outbound root 0 N={payload_cols}"
    r = run_query(q, ds, 0)
    check_root0(r, levels, spec, label, real_positions(engine, r, id_to_pos))
    warm = warm_latency_ms(lambda: run_query(q, ds, 0))
    return exp_numbers(warm, profile_call(label, lambda: run_query(q, ds, 0),
                                          warm))


def exp_numbers(warm_ms: float, prof: dict) -> dict:
    """An experiment's numbers of one request from its warm ms and its
    :func:`profile_call`."""
    return {"warm_ms": warm_ms, "busy_ms": prof["device_ms"],
            "launches": prof["device_launches"],
            "idle_share": prof["idle_share"]}


def exp_line(name: str, fig: str, engines, payload_cols: int, baseline: str,
             ds, spec: TreeSpec, levels: list, id_to_pos: torch.Tensor,
             card: str, measured: dict) -> dict:
    """One of the paper's experiments on the card: each engine's numbers
    from ``measured`` (keyed by payload columns and engine), measured by
    :func:`exp_entry` where they are not there yet, and its speedup
    against ``baseline`` in warm and in busy ms.  Reports; it gates only
    the rows' correctness."""
    entries = {}
    for e in engines:
        if (payload_cols, e) not in measured:
            measured[payload_cols, e] = exp_entry(ds, e, payload_cols, spec,
                                                  levels, id_to_pos)
        entries[e] = dict(measured[payload_cols, e])
    base = entries[baseline]
    for entry in entries.values():
        entry[f"speedup_vs_{baseline}"] = base["warm_ms"] / entry["warm_ms"]
        entry[f"busy_speedup_vs_{baseline}"] = \
            base["busy_ms"] / entry["busy_ms"]
    return {"exp": name, "paper": fig, "payload_cols": payload_cols,
            "row_bytes": 4 * ds.rows.width, "root": 0, "depth": MAX_DEPTH,
            "caps": list(CAPS), "engines": entries, "card": card}


# ---------------------------------------------------------------------------
# GNN inference (phase 7)
# ---------------------------------------------------------------------------

GNN_SEED = 0                   # coordinates and minibatch seeds
# the graphs' seeds are the training cells' (launch/steps.py: 3 for a full
# graph or molecule batch, 4 for the minibatch graph), so phase 8's cells
# take phase 7's host arrays (make_graph_once) instead of generating them
# again (~46 s of host time at ogb_products and minibatch_lg)
GRAPH_SEEDS = {"full_graph": 3, "molecule": 3, "minibatch": 4}
_GRAPHS: dict = {}


def make_graph_once(*args, **kwargs):
    """``graphgen.make_graph`` of these arguments, generated once in the
    script (the arrays are read only)."""
    key = (args, tuple(sorted(kwargs.items())))
    if key not in _GRAPHS:
        _GRAPHS[key] = graphgen.make_graph(*args, **kwargs)
    return _GRAPHS[key]
SAMPLE_SEED = 1                # the card generator of the sampler's draws
# tests/test_torch_gnn.py's tolerance between the port and the reference:
# matmuls and segment sums add in another order on the card and the CPU
GNN_TOL = dict(rtol=1e-4, atol=1e-4)
# the rows, in the order they run: (arch, shape), each at its published
# width (src/repro/configs/*.py) and its published shape
# (src/repro/configs/registry.py GNN_SHAPES); GatedGCN stays off
# ogb_products, where each (E, 70) float32 edge tensor would be 17 GB
GNN_ROWS = (("gat-cora", "full_graph_sm"), ("gatedgcn", "full_graph_sm"),
            ("gatedgcn", "molecule"), ("egnn", "molecule"),
            ("graphsage-reddit", "ogb_products"),
            ("graphsage-reddit", "minibatch_lg"))
# rows whose float32 logits drift from float64 past GNN_TOL on the CPU
# itself (EGNN's molecule logits reach ~8,000; the CPU float32 run sits
# 0.8-5.2x GNN_TOL off float64): held against the CPU run in float64, the
# card's largest error no larger than GNN_F64_FACTOR times the CPU float32
# run's own, or within GNN_TOL's atol of the largest float64 logit
GNN_F64_ROWS = (("egnn", "molecule"),)
GNN_F64_FACTOR = 4.0


def tree_to(tree, device):
    """A parameter tree (dicts and lists of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def gnn_graph(arch: str, shape: str, card: str) -> tuple[dict, dict, dict]:
    """The shape's seeded graph as numpy arrays (src, dst, feats and, for
    EGNN, coords), its dims, and the same arrays on the card; prints the
    host's generation time and the copy's on a line of their own."""
    dims = GNN_SHAPES[shape]
    t0 = time.perf_counter()
    if dims["kind"] == "molecule":
        g = graphgen.make_molecule_batch(dims["batch"], dims["n_nodes"],
                                         dims["n_edges"], dims["d_feat"],
                                         seed=GRAPH_SEEDS["molecule"])
    else:
        g = make_graph_once(dims["n_nodes"], dims["n_edges"],
                            dims["d_feat"], num_classes=dims["n_classes"],
                            seed=GRAPH_SEEDS[dims["kind"]])
    host = {"src": g.src, "dst": g.dst, "feats": g.feats}
    if arch == "egnn":
        host["coords"] = np.random.default_rng(GNN_SEED + 1).standard_normal(
            (g.num_vertices, 3)).astype(np.float32)
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    print("gnn graph: " + json.dumps({
        "shape": shape, "arch": arch, "V": g.num_vertices,
        "E": int(g.src.shape[0]), "d_feat": dims["d_feat"],
        "max_in_degree": int(np.bincount(g.dst).max()),
        "generate_s": gen_s, "to_card_s": copy_s,
        "to_card_mib": sum(v.nbytes for v in host.values()) / 2 ** 20,
        "card": card}), flush=True)
    return host, dims, graph


def gnn_params(cfg, dims: dict) -> dict:
    """Random weights at the config's width on the card, from a seeded
    CUDA generator."""
    return gnn.init_gnn(cfg, dims["d_feat"], dims["n_classes"],
                        torch.Generator(device=DEVICE).manual_seed(PARAM_SEED),
                        DEVICE)


def gnn_run(label: str, fn, by_path: dict, want_spmm: int) -> tuple:
    """One counted run of ``fn`` (the path's), its launches checked
    (``spmm_segment`` ``want_spmm`` times, nothing else), then its warm
    ms, profile and peak device memory above what was held before it."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, launches = counted_into(by_path["gnn"], fn)
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0),
                         "spmm_segment": want_spmm},
            f"{label}: launches {launches}, want spmm_segment {want_spmm} "
            f"times and nothing else")
    warm = warm_latency_ms(fn)
    prof = profile_call(label, fn, warm)
    return out, {"warm_ms": warm, "device_ms": prof["device_ms"],
                 "host_share": prof["idle_share"],
                 "device_launches": prof["device_launches"],
                 "peak_mib": peak_mib, "spmm_segment_launches": want_spmm,
                 "launches": launches, "top": prof["top"]}


def require_close(got: torch.Tensor, want: torch.Tensor, label: str,
                  other: str) -> float:
    require(got.shape == want.shape and bool(got.isfinite().all()),
            f"{label}: shape {tuple(got.shape)} or a non-finite value")
    require(bool(torch.isclose(got, want, **GNN_TOL).all()),
            f"{label}: differs from {other} beyond {GNN_TOL}")
    return max_abs_err(got, want)


def require_near_f64(got: torch.Tensor, want: torch.Tensor,
                     wide: torch.Tensor, label: str) -> dict:
    """The card's float32 logits ``got`` against the CPU run in float64
    (``wide``): their largest error no larger than GNN_F64_FACTOR times the
    CPU float32 run's (``want``) own, or within GNN_TOL's atol of the
    largest float64 logit; both distances returned."""
    require(got.shape == wide.shape and bool(got.isfinite().all()),
            f"{label}: shape {tuple(got.shape)} or a non-finite value")
    card = float((got.double() - wide).abs().max())
    cpu = float((want.double() - wide).abs().max())
    largest = float(wide.abs().max())
    limit = max(GNN_F64_FACTOR * cpu, GNN_TOL["atol"] * largest)
    require(card <= limit,
            f"{label}: {card} off the CPU run in float64, beyond {limit} "
            f"({GNN_F64_FACTOR} x the CPU float32 run's {cpu}, or "
            f"{GNN_TOL['atol']} of the largest logit {largest})")
    return {"max_abs_err": max_abs_err(got, want),
            "max_abs_err_f64": card, "cpu_max_abs_err_f64": cpu,
            "largest_logit_f64": largest, "f64_limit": limit,
            "against": "the port's CPU run in float64 (the CPU float32 "
                       "run's own distance beside it)",
            "tol": f"{GNN_F64_FACTOR} x the CPU float32 run's distance "
                   f"from float64, or {GNN_TOL['atol']} of the largest "
                   f"logit"}


def plain_sage_forward(params: dict, graph: dict) -> torch.Tensor:
    """GraphSAGE's full-graph forward assembled here from its layers with
    the plain aggregation (``spmm_segment_ref``), on the graph's device."""
    src, dst, feats = graph["src"], graph["dst"], graph["feats"]
    n = feats.shape[0]
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    deg = torch.clamp(torch.bincount(dst, minlength=n).to(torch.float32),
                      min=1.0)

    def dense(p, x):
        return x @ p["w"] + p["b"]
    h = dense(params["embed_in"], feats)
    for lp in params["layers"]:
        mean = spmm_segment_ref(h, src, dst, ones, n) / deg[:, None]
        h = torch.relu(dense(lp["self"], h) + dense(lp["nbr"], mean))
    return dense(params["head"], h)


def gnn_full_graph_row(arch: str, shape: str, card: str, by_path: dict,
                       flush) -> dict:
    """``gnn_forward`` of ``arch`` on ``shape`` through the path's counters
    and against its check: the port's CPU run of the same graph and
    weights, or, on ogb_products, the forward with the plain aggregation
    on the card and ``spmm_segment`` against its plain version at each
    layer's input (``kernel``, the kernel's numbers there)."""
    cfg, _ = registry.get_config(arch)
    host, dims, graph = gnn_graph(arch, shape, card)
    params = gnn_params(cfg, dims)
    n = host["feats"].shape[0]
    label = f"gnn {arch} {shape}"
    want_spmm = cfg.n_layers if cfg.kind == "graphsage" else 0
    logits, row = gnn_run(label, lambda: gnn.gnn_forward(params, cfg, graph),
                          by_path, want_spmm)
    require(tuple(logits.shape) == (n, dims["n_classes"]),
            f"{label}: logits {tuple(logits.shape)}")
    row = {"arch": arch, "config": cfg.name, "shape": shape,
           "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
           "heads": cfg.n_heads, "V": n, "E": int(host["src"].shape[0]),
           "d_feat": dims["d_feat"], "classes": dims["n_classes"], **row}
    if shape != "ogb_products":
        cpu_graph = {k: torch.from_numpy(v) for k, v in host.items()}
        want = gnn.gnn_forward(tree_to(params, "cpu"), cfg, cpu_graph)
        if (arch, shape) in GNN_F64_ROWS:
            wide = gnn.gnn_forward(
                tree_map(lambda t: t.cpu().double(), params), cfg,
                {k: t.double() if t.is_floating_point() else t
                 for k, t in cpu_graph.items()})
            row.update(require_near_f64(logits.cpu(), want, wide, label))
            return {**row, "card": card}
        row["max_abs_err"] = require_close(logits.cpu(), want, label,
                                           "the port's CPU run")
        row["against"] = "the port's CPU run"
        row["tol"] = GNN_TOL
        return {**row, "card": card}
    # the whole forward against the plain aggregation on the card, then
    # the kernel at each sage_layer's input
    want = plain_sage_forward(params, graph)
    row["max_abs_err"] = require_close(logits, want, label,
                                       "the plain-aggregation forward")
    row["against"] = "the plain-aggregation forward on the card"
    row["tol"] = GNN_TOL
    del want
    src, dst = graph["src"], graph["dst"]
    row["sort_ms"] = time_ms(lambda: gnn.sort_edges(src, dst, n), flush)
    edges = gnn.sort_edges(src, dst, n)
    ones = edges.ones
    h = graph["feats"] @ params["embed_in"]["w"] + params["embed_in"]["b"]
    del graph["feats"]
    kernel = {}
    for li, lp in enumerate(params["layers"]):
        case, _ = spmm_case(h, src, dst, ones, n, "f64", flush)
        e, d = src.shape[0], h.shape[1]
        gathered = e * d * 4 + (n + 1) * 4 + e * 8 + n * d * 4
        case.update({
            "bound_uses": "the compulsory bytes: offsets, src and w once, "
                          "each distinct x row once, the output once",
            "gathered_bytes": gathered,
            "bound_gathered_ms": bound_ms(gathered, 2.0 * e * d),
            "tol": "1e-5 of each row's sum of absolute terms, against "
                   "the plain version in float64"})
        kernel[f"layer{li}"] = case
        print("gnn spmm_segment: " + json.dumps({
            "layer": li, **case, "card": card}), flush=True)
        if li + 1 < len(params["layers"]):
            h = gnn.sage_layer(lp, h, src, dst, n, edges)
    row["kernel"] = kernel
    return {**row, "card": card}


def gnn_minibatch_row(card: str, by_path: dict) -> dict:
    """GraphSAGE-Reddit on minibatch_lg: ``sample_block`` (draws from a
    seeded card generator) + ``gather_block_features`` +
    ``sage_block_forward`` for 1,024 seeds at fan-out (15, 10); the layers
    equal to the port's CPU sampler fed the same draws (regenerated from
    the same seed) over the card's CSR, the logits to its CPU forward."""
    arch, shape = "graphsage-reddit", "minibatch_lg"
    base, _ = registry.get_config(arch)
    host, dims, graph = gnn_graph(arch, shape, card)
    fanouts = tuple(dims["fanout"])
    cfg = dataclasses.replace(base, sample_sizes=fanouts)
    v = host["feats"].shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    csr = build_csr(graph.pop("src"), v)
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    dst, feats = graph["dst"], graph["feats"]
    seeds = torch.from_numpy(np.random.default_rng(GNN_SEED).choice(
        v, dims["batch_nodes"], replace=False).astype(np.int32)).to(DEVICE)
    params = gnn_params(cfg, dims)
    label = f"gnn {arch} {shape}"

    def step(draws=None):
        gen = None if draws is not None else \
            torch.Generator(device=DEVICE).manual_seed(SAMPLE_SEED)
        layers = sample_block(gen, csr, dst, seeds, fanouts, draws=draws)
        block = {"layer_feats": gather_block_features(feats, layers)}
        return layers, gnn.sage_block_forward(params, cfg, block)
    (layers, logits), row = gnn_run(label, step, by_path, 0)
    sizes = [t.shape[0] for t in layers]
    want_sizes = [dims["batch_nodes"]]
    for f in fanouts:
        want_sizes.append(want_sizes[-1] * f)
    require(sizes == want_sizes, f"{label}: layer sizes {sizes}")
    # the same draws, regenerated from the seed on the card
    gen = torch.Generator(device=DEVICE).manual_seed(SAMPLE_SEED)
    draws, n = [], dims["batch_nodes"]
    for f in fanouts:
        draws.append(torch.randint(0, DRAW_HIGH, (n, f), generator=gen,
                                   device=DEVICE, dtype=torch.int32))
        n *= f
    again, _ = step(draws=draws)
    require(all(torch.equal(a, b) for a, b in zip(again, layers)),
            f"{label}: the regenerated draws give other layers")
    csr_cpu = CSRIndex(csr.indptr.cpu(), csr.perm.cpu())
    t0 = time.perf_counter()
    layers_cpu = sample_block(None, csr_cpu, torch.from_numpy(host["dst"]),
                              seeds.cpu(), fanouts,
                              draws=[d.cpu() for d in draws])
    require(all(torch.equal(a.cpu(), b) for a, b in zip(layers, layers_cpu)),
            f"{label}: the card's layers differ from the CPU sampler's")
    want = gnn.sage_block_forward(tree_to(params, "cpu"), cfg, {
        "layer_feats": gather_block_features(torch.from_numpy(host["feats"]),
                                             layers_cpu)})
    cpu_s = time.perf_counter() - t0
    err = require_close(logits.cpu(), want, label, "the port's CPU run")
    return {"arch": arch, "config": cfg.name, "shape": shape,
            "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
            "fanout": list(fanouts), "seeds": dims["batch_nodes"], "V": v,
            "E": int(host["dst"].shape[0]), "d_feat": dims["d_feat"],
            "classes": dims["n_classes"], "sampled": sizes,
            "csr_build_s": csr_s, **row, "max_abs_err": err,
            "against": "the port's CPU sampler and forward (same draws)",
            "tol": GNN_TOL, "cpu_s": cpu_s, "card": card}


def gnn_phase(card: str, by_path: dict, flush) -> dict:
    """Phase 7: every row of GNN_ROWS on the card (one ``gnn:`` line each);
    returns ``spmm_segment``'s numbers at ogb_products by layer."""
    t_phase = time.perf_counter()
    by_path["gnn"] = dict.fromkeys(KERNEL_OPS, 0)
    kernel = None
    for arch, shape in GNN_ROWS:
        if shape == "minibatch_lg":
            row = gnn_minibatch_row(card, by_path)
        else:
            row = gnn_full_graph_row(arch, shape, card, by_path, flush)
            kernel = row.pop("kernel", kernel)
        print("gnn: " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    require(by_path["gnn"]["spmm_segment"] > 0,
            "the GNN path never launched spmm_segment")
    print(f"gnn phase: {time.perf_counter() - t_phase:.3f} s (host clock), "
          f"launches {json.dumps(by_path['gnn'])}", flush=True)
    return kernel


# ---------------------------------------------------------------------------
# phase 8: training through the cells a trainer builds (launch/steps.py)
# ---------------------------------------------------------------------------

TRAIN_SMOKE = False            # True: the smoke shapes (a CPU rehearsal)
TRAIN_STEPS = 3                # AdamW steps of the ogb_products row
# the gradients' tolerance, relative to each leaf's largest gradient
# (tests/test_torch_gnn.py's: sums and matmuls in another order)
TRAIN_TOL = 1e-4
LAZY_TOL = 1e-5                # the lazy step's rows against its CPU run
# (arch, shape) of the rows with no kernel, each against its CPU run in
# float32 and in float64 (the witness of which side drifts)
TRAIN_SMALL_ROWS = (("gat-cora", "full_graph_sm"),
                    ("gatedgcn", "full_graph_sm"), ("gatedgcn", "molecule"),
                    ("egnn", "molecule"))
# a row's own gradient limit where float32 itself drifts past TRAIN_TOL
# from the float64 run: GatedGCN's 16 residual layers on full_graph_sm,
# where the card and the CPU float32 run both read 1.27-1.31e-4 of a
# leaf's largest off float64 on an H100 (PERF.md section 7)
TRAIN_ROW_TOL = {("gatedgcn", "full_graph_sm"): 3e-4}


def train_cell(arch: str, shape: str, card: str):
    """The cell, built on the card, and its build seconds (host generation
    included, but for a graph phase 7 made: ``make_graph_once``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = with_patched(train_steps, "make_graph", make_graph_once,
                        lambda: train_steps.build_cell(
                            arch, shape, smoke=TRAIN_SMOKE, device=DEVICE))
    torch.cuda.synchronize()
    return plan, time.perf_counter() - t0


def leaf_errors(got, want, label: str, other: str, rows=None,
                tol: float = TRAIN_TOL) -> float:
    """Every leaf of the gradient tree ``got`` within ``tol`` of
    ``want``'s (relative to the leaf's largest, with the same rtol);
    ``rows`` maps a leaf's index to the rows to compare (DeepFM's touched
    table rows), the other rows required zero in both.  Returns the
    largest error over the leaf's largest."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        g, w = g.to(w.device), w
        if rows is not None and i in rows:
            keep = torch.zeros(w.shape[0], dtype=torch.bool, device=w.device)
            keep[rows[i]] = True
            require(not bool(g[~keep].any()) and not bool(w[~keep].any()),
                    f"{label}: leaf {i} has a gradient on an untouched row")
            g, w = g[keep], w[keep]
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        require(bool(((g - w).abs() <= tol * w.abs()
                      + tol * max(scale, 1e-30)).all()),
                f"{label}: leaf {i} differs from {other} by {err} "
                f"(largest {scale}), beyond {tol} of its largest")
        worst = max(worst, err / scale if scale else err)
    return worst


def train_timing(label: str, fn, by_path: dict, want: dict) -> tuple:
    """The counted run of ``fn`` (the path's steps) with its launches
    held to ``want`` and nothing else, then the warm ms of one step (host
    median of 3 after the counted run), its profile and the peak device
    memory above what was held before it."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, launches = counted_into(by_path["train"], fn)
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0), **want},
            f"{label}: launches {launches}, want {want} and nothing else")
    return out, {"launches": launches, "peak_mib": peak_mib}


def step_profile(label: str, step) -> dict:
    warm = warm_latency_ms(step)
    prof = profile_call(label, step, warm)
    return {"warm_ms": warm, "device_ms": prof["device_ms"],
            "host_share": prof["idle_share"],
            "device_launches": prof["device_launches"], "top": prof["top"]}


class PlainSpmm(torch.autograd.Function):
    """``spmm_segment`` with the plain version in both directions: the
    forward over the destination-sorted edges, the backward over the same
    edges read the other way (``spmm_segment_ref`` takes them in any
    order, so no grouping by source is involved)."""

    @staticmethod
    def forward(ctx, x, src, seg, weights, offsets):
        ctx.save_for_backward(src, seg, weights)
        ctx.num_src = x.shape[0]
        return spmm_segment_ref(x, src, seg, weights, offsets.shape[0] - 1)

    @staticmethod
    def backward(ctx, grad_out):
        src, seg, weights = ctx.saved_tensors
        return (spmm_segment_ref(grad_out.contiguous(), seg, src, weights,
                                 ctx.num_src), None, None, None, None)


def plain_spmm_sorted(x, src, seg, weights, offsets, mask=None, *,
                      transposed=None):
    return PlainSpmm.apply(x, src, seg, weights, offsets)


def plain_lookup(table, ids):
    """DeepFM's lookup with ``late_gather``'s plain version, whose own
    autograd (``index_select``'s backward) carries the gradient."""
    b, k = ids.shape
    return late_gather_ref(table, ids.reshape(-1).to(torch.int32)) \
        .reshape(b, k, table.shape[1])


def with_patched(module, name: str, value, fn):
    """``fn()`` with ``module.name`` set to ``value`` for its duration."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        return fn()
    finally:
        setattr(module, name, old)


def require_same_step(got, want, label: str) -> dict:
    """Two runs of one step (params, state, metrics), bit-equal in every
    leaf and in the loss."""
    pairs = list(zip(tree_leaves(list(got[:2]) + [got[2]["loss"]]),
                     tree_leaves(list(want[:2]) + [want[2]["loss"]])))
    unequal = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
    require(not unequal, f"{label}: leaves {unequal} differ from the "
            f"uninterrupted step, by up to "
            f"{max(max_abs_err(*pairs[i]) for i in unequal) if unequal else 0}")
    return {"bit_equal": True, "leaves": len(pairs)}


def train_sage_full_row(card: str, by_path: dict, flush) -> tuple:
    """GraphSAGE-Reddit on ogb_products: TRAIN_STEPS AdamW steps through
    the cell; step 1's loss and gradients against the same step with the
    plain aggregation on the card; the backward kernel at each layer's
    gradient against the plain version in float64 over the transposed
    edges, timed; a checkpoint after step 2 restored into zeroed trees
    and step 3 run again."""
    arch, shape = "graphsage-reddit", "ogb_products"
    label = f"train {arch} {shape}"
    plan, build_s = train_cell(arch, shape, card)
    params, state, batch = plan.args
    n = batch["feats"].shape[0]

    def steps():
        p, s, out = params, state, []
        for _ in range(TRAIN_STEPS):
            p, s, m = plan.fn(p, s, batch)
            out.append((p, s, m))
        return out
    layers = len(params["layers"])
    # forward and backward, each layer, each step
    hist, row = train_timing(label, steps, by_path,
                             {"spmm_segment": 2 * layers * TRAIN_STEPS})
    losses = [float(m["loss"]) for _, _, m in hist]
    require(all(np.isfinite(losses)), f"{label}: losses {losses}")
    row.update(step_profile(label, lambda: plan.fn(params, state, batch)))

    # step 1's gradients through the kernels, each layer's gradient
    # captured where it enters spmm_segment's backward
    grads_out = []

    def recording(x, src, seg, weights, offsets, mask=None, *,
                  transposed=None):
        out = spmm_ops.spmm_segment_sorted(x, src, seg, weights, offsets,
                                           mask, transposed=transposed)
        out.register_hook(lambda g: grads_out.append(g.detach()))
        return out
    loss, grads = with_patched(gnn, "spmm_segment_sorted", recording,
                               lambda: value_and_grad(plan.loss, params,
                                                      batch))
    want_loss, want = with_patched(
        gnn, "spmm_segment_sorted", plain_spmm_sorted,
        lambda: value_and_grad(plan.loss, params, batch))
    require(abs(float(loss) - float(want_loss))
            <= TRAIN_TOL * abs(float(want_loss)),
            f"{label}: loss {float(loss)} against the plain aggregation's "
            f"{float(want_loss)}")
    require(float(loss) == losses[0],
            f"{label}: step 1's loss {losses[0]} is not value_and_grad's "
            f"{float(loss)}")
    row["grad_max_rel_err"] = leaf_errors(
        grads, want, label, "the plain-aggregation step on the card")
    row["loss_plain"] = float(want_loss)
    del grads, want
    # the backward kernel at each layer's gradient: the sum over the
    # edges grouped by source (spmm_case groups them by the forward's
    # source, the transposed edges), against the float64 plain version
    require(len(grads_out) == layers, f"{label}: {len(grads_out)} "
            f"gradients captured for {layers} layers")
    src, dst = batch["src"], batch["dst"]
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    backward = {}
    for li, g in enumerate(reversed(grads_out)):
        case, _ = spmm_case(g.contiguous(), dst, src, ones, n, "f64", flush)
        case["sort_ms"] = time_ms(lambda: spmm_ops.transpose_grouping(
            src, dst, ones, n), flush)
        case.update({
            "bound_uses": "the compulsory bytes: offsets, src and w once, "
                          "each distinct gradient row once, grad_x once",
            "tol": "1e-5 of each row's sum of absolute terms, against "
                   "the plain version in float64 over the transposed "
                   "edges"})
        backward[f"layer{li}"] = case
        print("train spmm_segment backward: " + json.dumps(
            {"layer": li, **case, "card": card}), flush=True)
    del grads_out

    # a checkpoint after step 2, restored into zeroed trees, then step 3
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2, async_save=True)
        t0 = time.perf_counter()
        mgr.save(2, {"params": hist[1][0], "opt_state": hist[1][1]})
        mgr.wait()
        save_s = time.perf_counter() - t0
        like = tree_map(torch.zeros_like, {"params": params,
                                           "opt_state": state})
        step, restored = mgr.restore_latest(like)
    require(step == 2, f"{label}: restored step {step}")
    again = plan.fn(restored["params"], restored["opt_state"], batch)
    row["checkpoint"] = {"save_s": save_s, **require_same_step(
        again, hist[2], f"{label} restored at step 2")}
    return {"arch": arch, "shape": shape, "V": n, "E": int(src.shape[0]),
            "steps": TRAIN_STEPS, "losses": losses, "build_s": build_s,
            **row, "card": card}, backward


def train_sage_minibatch_row(card: str, by_path: dict) -> dict:
    """GraphSAGE-Reddit on minibatch_lg: one sampled step, its draws from
    the card generator the cell seeds; the sampled layers equal to the
    CPU sampler's fed the same draws, the loss and gradients to the port's
    CPU step on that block."""
    arch, shape = "graphsage-reddit", "minibatch_lg"
    label = f"train {arch} {shape}"
    plan, build_s = train_cell(arch, shape, card)
    params, state, graph, seeds, seed_scalar = plan.args
    fanouts = tuple(registry.shapes_for("gnn", TRAIN_SMOKE)[shape]["fanout"])
    (_, _, m), row = train_timing(label, lambda: plan.fn(*plan.args),
                                  by_path, {})
    row.update(step_profile(label, lambda: plan.fn(*plan.args)))
    # the step's draws, regenerated from its seed, and the layers
    gen = torch.Generator(device=DEVICE).manual_seed(int(seed_scalar))
    draws, n = [], seeds.shape[0]
    for f in fanouts:
        draws.append(torch.randint(0, DRAW_HIGH, (n, f), generator=gen,
                                   device=DEVICE, dtype=torch.int32))
        n *= f
    csr = CSRIndex(graph["indptr"], graph["perm"])
    own = sample_block(
        torch.Generator(device=DEVICE).manual_seed(int(seed_scalar)), csr,
        graph["dst"], seeds, fanouts)
    layers = sample_block(None, csr, graph["dst"], seeds, fanouts,
                          draws=draws)
    require(all(torch.equal(a, b) for a, b in zip(own, layers)),
            f"{label}: the regenerated draws give other layers")
    t0 = time.perf_counter()
    graph_cpu = {k: v.cpu() for k, v in graph.items()}
    draws_cpu = [d.cpu() for d in draws]
    layers_cpu = sample_block(None, CSRIndex(graph_cpu["indptr"],
                                             graph_cpu["perm"]),
                              graph_cpu["dst"], seeds.cpu(), fanouts,
                              draws=draws_cpu)
    require(all(torch.equal(a.cpu(), b) for a, b in zip(layers, layers_cpu)),
            f"{label}: the card's layers differ from the CPU sampler's")
    loss, grads = value_and_grad(plan.loss, params, graph, seeds,
                                 seed_scalar)
    want_loss, want = value_and_grad(plan.loss, tree_to(params, "cpu"),
                                     graph_cpu, seeds.cpu(),
                                     seed_scalar.cpu(), draws=draws_cpu)
    cpu_s = time.perf_counter() - t0
    require(abs(float(loss) - float(want_loss))
            <= TRAIN_TOL * abs(float(want_loss)),
            f"{label}: loss {float(loss)} against the CPU's "
            f"{float(want_loss)}")
    require(float(loss) == float(m["loss"]),
            f"{label}: the step's loss {float(m['loss'])} is not "
            f"value_and_grad's {float(loss)}")
    err = leaf_errors(grads, want, label, "the port's CPU step")
    return {"arch": arch, "shape": shape, "seeds": int(seeds.shape[0]),
            "fanout": list(fanouts), "sampled": [int(t.shape[0])
                                                 for t in layers],
            "E": int(graph["dst"].shape[0]), "loss": float(m["loss"]),
            "loss_cpu": float(want_loss), "grad_max_rel_err": err,
            "build_s": build_s, "cpu_s": cpu_s, **row, "card": card}


def float64_witness(plan, cpu_args) -> tuple:
    """The loss and gradients of ``plan``'s cell on the CPU with every
    floating tensor of its weights and batch in float64."""
    wide = tree_map(lambda t: t.double() if t.is_floating_point() else t,
                    cpu_args)
    return value_and_grad(plan.loss, wide[0], *wide[2:])


def train_small_row(arch: str, shape: str, card: str, by_path: dict) -> dict:
    """One step of a cell that runs no kernel, its loss and gradients
    against the port's CPU run of the same cell and weights, and both
    against that run in float64 (the control: the CPU float32 run's own
    distance from it); the card's gradients taken twice, their distance
    printed."""
    label = f"train {arch} {shape}"
    tol = TRAIN_ROW_TOL.get((arch, shape), TRAIN_TOL)
    plan, build_s = train_cell(arch, shape, card)
    (_, _, m), row = train_timing(label, lambda: plan.fn(*plan.args),
                                  by_path, {})
    row.update(step_profile(label, lambda: plan.fn(*plan.args)))
    loss, grads = value_and_grad(plan.loss, plan.args[0], *plan.args[2:])
    _, again = value_and_grad(plan.loss, plan.args[0], *plan.args[2:])
    repeat = leaf_errors(again, grads, label, "a second card run", tol=tol)
    cpu_args = tree_to(list(plan.args), "cpu")
    want_loss, want = value_and_grad(plan.loss, cpu_args[0], *cpu_args[2:])
    wit_loss, wit = float64_witness(plan, cpu_args)
    require(abs(float(loss) - float(want_loss))
            <= TRAIN_TOL * abs(float(want_loss)),
            f"{label}: loss {float(loss)} against the CPU's "
            f"{float(want_loss)}")
    err = leaf_errors(grads, want, label, "the port's CPU run", tol=tol)
    err_f64 = leaf_errors(grads, wit, label, "the CPU run in float64",
                          tol=tol)
    control = leaf_errors(want, wit, f"{label} (CPU float32)",
                          "the CPU run in float64", tol=tol)
    return {"arch": arch, "shape": shape, "loss": float(m["loss"]),
            "loss_cpu": float(want_loss), "loss_f64": float(wit_loss),
            "grad_tol": tol, "grad_max_rel_err": err,
            "grad_max_rel_err_f64": err_f64, "cpu_max_rel_err_f64": control,
            "grad_repeat_rel_err": repeat,
            "build_s": build_s, **row, "card": card}


def train_deepfm_row(card: str, by_path: dict, flush) -> tuple:
    """DeepFM on train_batch at the full table: one dense AdamW step
    (``late_gather``'s kernel forward, its scatter-add backward, moments
    over the whole table), its loss and gradients against the same step
    with the plain lookup on the card (touched table rows row by row);
    then one lazy step, its untouched rows and moments bit-equal to
    before and its touched rows within LAZY_TOL of its CPU run."""
    arch, shape = "deepfm", "train_batch"
    label = f"train {arch} {shape}"
    plan, build_s = train_cell(arch, shape, card)
    params, state, batch = plan.args
    cfg, _ = registry.get_config(arch, smoke=TRAIN_SMOKE)
    (_, _, m), row = train_timing(label, lambda: plan.fn(*plan.args),
                                  by_path, {"late_gather": 1})
    row.update(step_profile(label, lambda: plan.fn(*plan.args)))
    loss, grads = value_and_grad(plan.loss, params, batch)
    want_loss, want = with_patched(
        recsys, "fixed_hot_lookup", plain_lookup,
        lambda: value_and_grad(plan.loss, params, batch))
    pos = recsys.featurize(cfg, batch["dense"], batch["sparse"],
                           batch["offsets"]).reshape(-1)
    touched = torch.unique(pos).long()
    order = tree_leaves(params)
    rows = {i: touched for i, leaf in enumerate(order)
            if leaf is params["table"] or leaf is params["first_order"]}
    require(abs(float(loss) - float(want_loss))
            <= TRAIN_TOL * abs(float(want_loss)),
            f"{label}: loss {float(loss)} against the plain lookup's "
            f"{float(want_loss)}")
    row["grad_max_rel_err"] = leaf_errors(grads, want, label,
                                          "the plain-lookup step", rows)
    del grads, want
    # the gradient's own cost: late_gather's backward at this batch
    table = params["table"].detach().requires_grad_(True)
    out = lg_ops.late_gather(table, pos)
    cot = torch.randn(out.shape, device=out.device,
                      generator=torch.Generator(device=DEVICE).manual_seed(0))
    r, w = table.shape
    grad_bytes = r * w * 4 + pos.shape[0] * (w * 4 + 4)
    gradient = {
        "positions": int(pos.shape[0]), "touched_rows": int(touched.numel()),
        "ms": time_ms(lambda: torch.autograd.grad(out, table, cot,
                                                  retain_graph=True), flush),
        "forward_ms": time_ms(lambda: lg_ops.late_gather(
            params["table"], pos), flush),
        "bound_ms": bound_ms(grad_bytes), "bound_by": "bytes",
        "bound_uses": "the dense (R, W) gradient written once, the (P, W) "
                      "output gradient and the positions read once",
        "what": "index_add_ of the output gradient into a zeroed (R, W) "
                "table gradient (atomics), the zeroing included"}
    del out, cot, table
    print("train late_gather gradient: " + json.dumps({**gradient,
                                                       "card": card}),
          flush=True)
    # the lazy positional step from the same parameters and state
    lazy = recsys.make_deepfm_train_step_lazy(cfg,
                                              train_steps.make_optimizer())
    (lp, ls, lm), lazy_row = train_timing(
        f"{label} lazy", lambda: lazy(params, state, batch), by_path,
        {"late_gather": 1})
    lazy_row.update(step_profile(f"{label} lazy",
                                 lambda: lazy(params, state, batch)))
    keep = torch.ones(r, dtype=torch.bool, device=touched.device)
    keep[touched] = False
    for name in ("table", "first_order"):
        for got, before in ((lp[name], params[name]),
                            (ls["mu"][name], state["mu"][name]),
                            (ls["nu"][name], state["nu"][name])):
            require(torch.equal(got[keep], before[keep]),
                    f"{label} lazy: an untouched row of {name} changed")
    t0 = time.perf_counter()
    cpu = lazy(tree_to(params, "cpu"), tree_to(state, "cpu"),
               tree_to(batch, "cpu"))
    lazy_cpu_s = time.perf_counter() - t0
    touched_cpu = touched.cpu()
    lazy_err = 0.0
    for name in ("table", "first_order"):
        for got, want_t in ((lp[name], cpu[0][name]),
                            (ls["mu"][name], cpu[1]["mu"][name]),
                            (ls["nu"][name], cpu[1]["nu"][name])):
            g = got[touched].cpu()
            w_ = want_t[touched_cpu]
            require(bool(torch.isclose(g, w_, rtol=LAZY_TOL,
                                       atol=LAZY_TOL).all()),
                    f"{label} lazy: touched rows of {name} differ from the "
                    f"CPU run beyond {LAZY_TOL}")
            lazy_err = max(lazy_err, max_abs_err(g, w_))
    require(abs(float(lm["loss"]) - float(cpu[2]["loss"]))
            <= LAZY_TOL * abs(float(cpu[2]["loss"])),
            f"{label} lazy: loss differs from the CPU run")
    lazy_row.update({"loss": float(lm["loss"]),
                     "loss_cpu": float(cpu[2]["loss"]),
                     "max_abs_err_touched": lazy_err,
                     "cpu_s": lazy_cpu_s})
    return {"arch": arch, "shape": shape, "B": int(batch["dense"].shape[0]),
            "rows": r, "touched_rows": int(touched.numel()),
            "loss": float(m["loss"]), "loss_plain": float(want_loss),
            "build_s": build_s, **row, "lazy": lazy_row,
            "card": card}, gradient


def train_phase(card: str, by_path: dict, flush) -> tuple:
    """Phase 8: the training rows (one ``train:`` line each); returns
    ``spmm_segment``'s backward numbers at ogb_products by layer and
    ``late_gather``'s gradient's at DeepFM's train batch."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    by_path["train"] = dict.fromkeys(KERNEL_OPS, 0)
    seconds = {}

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn()
        row = out[0] if isinstance(out, tuple) else out
        seconds[name] = row["s"] = time.perf_counter() - t0
        MEASURED[f"train {name}"] = row
        print("train: " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
        return out

    _, backward = run("graphsage-reddit ogb_products",
                      lambda: train_sage_full_row(card, by_path, flush))
    run("graphsage-reddit minibatch_lg",
        lambda: train_sage_minibatch_row(card, by_path))
    for arch, shape in TRAIN_SMALL_ROWS:
        run(f"{arch} {shape}",
            lambda arch=arch, shape=shape: train_small_row(arch, shape,
                                                           card, by_path))
    _, gradient = run("deepfm train_batch",
                      lambda: train_deepfm_row(card, by_path, flush))
    require(by_path["train"]["spmm_segment"] > 0
            and by_path["train"]["late_gather"] > 0,
            f"the training path launched {by_path['train']}")
    print(f"train phase: {time.perf_counter() - t_phase:.3f} s (host clock), "
          f"rows {json.dumps(seconds)}, launches "
          f"{json.dumps(by_path['train'])}", flush=True)
    return backward, gradient


# ---------------------------------------------------------------------------
# phase 9: LM serving (models/transformer.py, launch/serve.py's LM mode)
# ---------------------------------------------------------------------------

LM_SMOKE = False               # True: the SMOKE configs, small shapes (a CPU
#                                rehearsal)
LM_SEED = 0                    # weights (a CUDA generator) and token streams
QWEN, DEEPSEEK = "qwen2-0.5b", "deepseek-v2-lite-16b"
# the card against the port's CPU run of the same weights, float32, TF32
# off: every block's logits within LM_TOL of the largest; the card's greedy
# token equal to the CPU's argmax where the CPU's top two differ by more
LM_TOL = 1e-4
DEEPSEEK_CHECK_LAYERS = 2      # of 27: its float32 copy on the host ~6.3 GB
# the timed rows, each a cut of LM_SHAPES (src/repro/configs/registry.py:33)
# at the config's bfloat16: prefill_32k at batch 1 of 32; decode_32k at
# batch 32 (qwen2) or 16 (deepseek) of 128 against a seeded cache of
# 32,768 positions, 8 steps filling its last 8; serve_batch end to end
LM_FULL = dict(check=dict(batch=2, seq=64, steps=8),
               prefill=dict(batch=1, seq=LM_SHAPES["prefill_32k"]["seq"]),
               decode=dict(batch={QWEN: 32, DEEPSEEK: 16},
                           seq=LM_SHAPES["decode_32k"]["seq"], steps=8),
               serve=dict(batch=8, prompt=512, gen=16))
LM_REHEARSAL = dict(check=dict(batch=2, seq=16, steps=2),
                    prefill=dict(batch=1, seq=48),
                    decode=dict(batch={QWEN: 2, DEEPSEEK: 2}, seq=40,
                                steps=6),
                    serve=dict(batch=2, prompt=12, gen=3))
# warm runs after the counted one; none for a 32k prefill (8-14 s on an
# H100, its counted run within 1.5% of a warm one), whose ms is the
# counted run's
LM_WARM_RUNS = {"prefill": 0, "decode": 1, "serve": 1}
LM_PROFILE_STEPS = 4           # decode steps in a decode row's profile


def lm_shapes() -> dict:
    return LM_REHEARSAL if LM_SMOKE else LM_FULL


def lm_config(arch: str, **changes):
    cfg, family = registry.get_config(arch, smoke=LM_SMOKE)
    require(family == "lm", f"{arch} is not an LM arch")
    return dataclasses.replace(cfg, **changes)


def lm_gathers(cfg) -> int:
    """``late_gather`` launches of one block through the model: the token
    lookup, and the dispatch and combine of each MoE layer."""
    return 1 + (2 * cfg.n_layers if cfg.moe is not None else 0)


def lm_tokens(cfg, batch: int, seq: int, step: int = 0) -> torch.Tensor:
    return torch.from_numpy(lm_batch(LM_SEED, step, batch, seq,
                                     cfg.vocab)["tokens"]).to(DEVICE)


def lm_init(cfg, dtype) -> tuple[dict, float]:
    """Random weights from a seeded CUDA generator, drawn a layer at a time
    and held in ``dtype``, and the seconds it took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tfm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(
        LM_SEED), DEVICE, dtype=dtype)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def tree_mib(tree) -> float:
    return sum(t.nbytes for t in tree_leaves(tree)) / 2 ** 20


def greedy_blocks(params, cfg, prompts, steps: int, max_len: int):
    """Prefill, then ``steps`` greedy decode steps: each block's logits and
    the tokens fed."""
    logits, cache = tfm.prefill(params, prompts, cfg, max_len=max_len)
    outs, fed = [logits], []
    for _ in range(steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        fed.append(tok)
        logits, cache = tfm.decode_step(params, tok, cache, cfg)
        outs.append(logits)
    return outs, fed


def lm_check(label: str, cfg, params, card: str, by_path: dict) -> dict:
    """The card's greedy prefill + decode (counted into the lm path)
    against the port's CPU run of the same float32 weights fed the card's
    tokens."""
    c = lm_shapes()["check"]
    prompts = lm_tokens(cfg, c["batch"], c["seq"])
    max_len = c["seq"] + c["steps"]
    (outs, fed), launches = counted_into(
        by_path["lm"],
        lambda: greedy_blocks(params, cfg, prompts, c["steps"], max_len))
    want_lg = lm_gathers(cfg) * (1 + c["steps"])
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0),
                         "late_gather": want_lg},
            f"{label}: launches {launches}, want late_gather {want_lg} "
            "times and nothing else")
    t0 = time.perf_counter()
    cpu = tree_to(params, "cpu")
    logits, cache = tfm.prefill(cpu, prompts.cpu(), cfg, max_len=max_len)
    want = [logits]
    for tok in fed:
        logits, cache = tfm.decode_step(cpu, tok.cpu(), cache, cfg)
        want.append(logits)
    cpu_s = time.perf_counter() - t0
    del cpu, cache
    worst, unclear = 0.0, 0
    for i, (g, w) in enumerate(zip(outs, want)):
        g = g.cpu()
        require(g.shape == w.shape and bool(torch.isfinite(g).all()),
                f"{label}: block {i} logits {tuple(g.shape)} or non-finite")
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        require(err <= LM_TOL * scale,
                f"{label}: block {i} logits differ from the CPU run by "
                f"{err}, beyond {LM_TOL} of {scale}")
        worst = max(worst, err / scale)
        if i < len(fed):
            top2 = torch.topk(w, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > LM_TOL * scale
            unclear += int((~clear).sum())
            require(torch.equal(fed[i].cpu()[clear],
                                torch.argmax(w, -1).to(torch.int32)[clear]),
                    f"{label}: block {i}'s greedy token differs from the "
                    "CPU run's with a clear margin")
    return {"check": label, "batch": c["batch"], "prompt": c["seq"],
            "decode_steps": c["steps"], "max_rel_err": worst, "tol": LM_TOL,
            "tokens_within_tol_of_a_tie": unclear,
            "late_gather_launches": want_lg, "cpu_s": cpu_s,
            "layers": cfg.n_layers, "dtype": cfg.dtype, "card": card}


def lm_time_ms(fn, reps: int) -> float:
    """Median of ``reps`` device times of ``fn`` (CUDA events), after one
    warm run."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return statistics.median(ms)


def lm_row(label: str, fn, by_path: dict, want_lg: int, *, kind: str,
           tokens: int, steps: int, cuts: str, card: str,
           profile_fn=None, profile_steps: int = 0) -> tuple:
    """One counted run of ``fn`` (its launches held to ``want_lg``
    ``late_gather`` launches and nothing else) with its peak device memory
    above what was held, then its warm ms (host clock and a sync, median of
    LM_WARM_RUNS[kind] runs after the counted one, or the counted run's
    where there are none), and one profiled run:
    of ``fn``, or of ``profile_fn``, which decodes ``profile_steps`` of the
    ``steps`` tokens (a profile of every step's ~15k launches costs the
    session tens of seconds), the host's share then read per token."""
    torch.cuda.synchronize()
    t_row = time.perf_counter()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = counted_into(by_path["lm"], fn)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
    require(launches == {**dict.fromkeys(KERNEL_OPS, 0),
                         "late_gather": want_lg},
            f"{label}: launches {launches}, want late_gather {want_lg} "
            "times and nothing else")
    ms, last = [], out
    for _ in range(LM_WARM_RUNS[kind]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    warm = statistics.median(ms) if ms else first_ms
    row = {"row": label, "warm_ms": warm, "warm_runs": len(ms),
           "first_ms": first_ms,
           "ms_per_token": warm / steps if steps else None,
           "tok_per_s": tokens / (warm / 1e3)}
    if profile_fn is None:
        prof = profile_call(label, fn, warm)
        row.update(device_ms=prof["device_ms"],
                   host_share=prof["idle_share"])
    else:
        prof = profile_call(label, profile_fn, warm * profile_steps / steps)
        per_token = prof["device_ms"] / profile_steps
        row.update(profiled_steps=profile_steps, device_ms=prof["device_ms"],
                   device_ms_per_token=per_token,
                   host_share=1 - per_token / row["ms_per_token"])
    row.update({"device_launches": prof["device_launches"],
                "late_gather_launches": want_lg, "peak_mib": peak_mib,
                "held_mib": held / 2 ** 20, "cuts": cuts,
                "top": prof["top"], "s": time.perf_counter() - t_row,
                "card": card})
    return out, last, row


def lm_prefill_row(arch: str, cfg, params, by_path: dict, card: str):
    p = lm_shapes()["prefill"]
    toks = lm_tokens(cfg, p["batch"], p["seq"], step=1)
    (logits, _), _, row = lm_row(
        f"{arch} prefill_32k", lambda: tfm.prefill(params, toks, cfg),
        by_path, lm_gathers(cfg), kind="prefill",
        tokens=p["batch"] * p["seq"], steps=0,
        cuts=(f"batch {LM_SHAPES['prefill_32k']['batch']} -> {p['batch']}"
              f"; seq {p['seq']}"), card=card)
    require(tuple(logits.shape) == (p["batch"], cfg.vocab)
            and bool(torch.isfinite(logits).all()),
            f"{arch} prefill: logits {tuple(logits.shape)} or non-finite")
    return row


def lm_decode_row(arch: str, cfg, params, by_path: dict, card: str):
    """``decode_step`` ``steps`` times against a cache of ``seq`` positions
    seeded with normal values (a CUDA generator), the first seq - steps of
    them taken as written, so the steps fill the rest."""
    d = lm_shapes()["decode"]
    b, smax, steps = d["batch"][arch], d["seq"], d["steps"]
    cache = tfm.init_cache(cfg, b, smax, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(LM_SEED + 1)
    for t in (cache.a, cache.b):
        t.normal_(generator=gen)
    first = lm_tokens(cfg, b, 1, step=2)[:, 0]

    def run(n=steps):
        c = cache._replace(length=smax - n)
        tok = first
        for _ in range(n):
            logits, c = tfm.decode_step(params, tok, c, cfg)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, c

    (logits, c), _, row = lm_row(
        f"{arch} decode_32k", run, by_path, lm_gathers(cfg) * steps,
        kind="decode", tokens=b * steps, steps=steps,
        cuts=(f"batch {LM_SHAPES['decode_32k']['batch']} -> {b}; a cache of "
              f"{smax} positions, {smax - steps} seeded, {steps} steps "
              "fill the rest"), card=card,
        profile_fn=lambda: run(LM_PROFILE_STEPS),
        profile_steps=LM_PROFILE_STEPS)
    require(c.length == smax and bool(torch.isfinite(logits).all()),
            f"{arch} decode: length {c.length} or non-finite logits")
    row["cache_mib"] = (cache.a.nbytes + cache.b.nbytes) / 2 ** 20
    return row


def lm_serve_row(arch: str, cfg, params, by_path: dict, card: str):
    s = lm_shapes()["serve"]
    prompts = lm_tokens(cfg, s["batch"], s["prompt"], step=3)
    (toks, _), (_, stats), row = lm_row(
        f"{arch} serve_batch", lambda: serve_batch(cfg, params, prompts,
                                                   s["gen"]),
        by_path, lm_gathers(cfg) * (1 + s["gen"]), kind="serve",
        tokens=s["batch"] * s["gen"], steps=s["gen"],
        cuts=f"batch {s['batch']}, prompt {s['prompt']}, gen {s['gen']}",
        card=card)
    row["ms_per_token"] = stats["decode_s"] * 1e3 / s["gen"]
    require(tuple(toks.shape) == (s["batch"], s["gen"])
            and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
            f"{arch} serve_batch: tokens {tuple(toks.shape)} out of range")
    row.update({f"serve_batch_{k}": v for k, v in stats.items()})
    return row


def lm_attention_yardstick(cfg, card: str) -> dict:
    """The ported ``chunked_attention`` at qwen2's prefill shape beside
    ``F.scaled_dot_product_attention`` (causal) on the same bfloat16 q, k
    and v, the KV heads repeated for it; a yardstick, not a path."""
    import torch.nn.functional as F
    s = lm_shapes()["prefill"]["seq"]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // hkv
    gen = torch.Generator(device=DEVICE).manual_seed(LM_SEED + 2)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(
            torch.bfloat16)
    q, k, v = normal(1, hkv, g, s, hd), normal(1, hkv, s, hd), \
        normal(1, hkv, s, hd)
    qh = q.reshape(1, hkv * g, s, hd)
    kh = k[:, :, None].expand(1, hkv, g, s, hd).reshape(1, hkv * g, s, hd)
    vh = v[:, :, None].expand(1, hkv, g, s, hd).reshape(1, hkv * g, s, hd)

    def ours():
        return lm_layers.chunked_attention(q, k, v, causal=True,
                                           chunk=cfg.attn_chunk, q_start=0,
                                           kv_len=s)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    err = max_abs_err(ours().reshape(1, hkv * g, s, hd).float(),
                      sdpa().float())
    ms, sdpa_ms = lm_time_ms(ours, 2), lm_time_ms(sdpa, 10)
    return {"shape": f"q (1, {hkv}, {g}, {s}, {hd}) bf16, causal, chunk "
                     f"{cfg.attn_chunk}",
            "chunked_attention_ms": ms, "sdpa_ms": sdpa_ms,
            "ratio": ms / sdpa_ms, "max_abs_err": err,
            "chunked_float32_flops": 4.0 * hkv * g * s * s * hd,
            "card": card}


def moe_layer0(params, cfg, toks: torch.Tensor) -> tuple:
    """Layer 0's MoE inputs of ``toks`` ((B, S) tokens) through the model
    in ``cfg.dtype``: the (T, D) tokens ``xt`` its FFN sees, their routing,
    and the experts' (E·cap, D) output rows ``y``."""
    lp = tfm.layer_params(params["layers"], 0)
    dt = getattr(torch, cfg.dtype)
    t = toks.numel()
    b, s = toks.shape
    x = lg_ops.late_gather(params["embed"], toks.reshape(-1)).reshape(
        b, s, cfg.d_model).to(dt)
    a, _ = lm_layers.mla_attention(
        lp["attn"], lm_layers.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
        positions=torch.arange(s, device=DEVICE))
    xt = lm_layers.rmsnorm(x + a, lp["ln2"], cfg.norm_eps).reshape(
        t, cfg.d_model).contiguous()
    del x, a
    route = lm_layers.moe_route(lp["ffn"], xt, cfg)
    e = cfg.moe.num_experts
    xg = lg_ops.late_gather(xt, route.dispatch).reshape(e, route.cap, -1)
    w = lp["ffn"]
    h = torch.nn.functional.silu(torch.einsum(
        "ecd,edf->ecf", xg, w["w1"].to(dt))) * torch.einsum(
            "ecd,edf->ecf", xg, w["w3"].to(dt))
    y = torch.einsum("ecf,efd->ecd", h, w["w2"].to(dt)).reshape(
        e * route.cap, -1).contiguous()
    return xt, route, y


def lm_gather_cases(qwen_embed, ds_params, ds_cfg, flush) -> dict:
    """``late_gather`` against its plain version at the LM path's shapes:
    qwen2's float32 token lookup at the prefill tokens, and deepseek's
    layer-0 MoE dispatch (its bfloat16 tokens at the (E·cap,) positions of
    the layer's own routing of the prefill tokens, empty slots T) and
    combine (the experts' rows at the (T·k,) slots, dropped choices
    E·cap)."""
    p = lm_shapes()["prefill"]
    qcfg = lm_config(QWEN)
    qtoks = lm_tokens(qcfg, p["batch"], p["seq"], step=1).reshape(-1)
    cases = {"token_lookup": late_gather_case([qwen_embed], qtoks, flush)}
    toks = lm_tokens(ds_cfg, p["batch"], p["seq"], step=1)
    with torch.no_grad():
        xt, route, y = moe_layer0(ds_params, ds_cfg, toks)
    cases["moe_dispatch"] = late_gather_case([xt], route.dispatch, flush)
    cases["moe_combine"] = late_gather_case([y], route.slot, flush)
    cases["moe_dispatch"]["empty_slots"] = int(
        (route.dispatch == toks.numel()).sum())
    cases["moe_combine"]["dropped_choices"] = int((~route.keep).sum())
    cases["moe_dispatch"]["cap"] = route.cap
    return cases


def lm_phase(card: str, by_path: dict, flush) -> dict:
    """Phase 9: qwen2-0.5b at full width and depth and deepseek-v2-lite-16b
    at full width, each against the port's CPU run in float32, then timed
    in bfloat16 (one ``lm:`` line a row); ``late_gather`` at the path's
    shapes.  Returns ``late_gather``'s LM cases."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    by_path["lm"] = dict.fromkeys(KERNEL_OPS, 0)
    bf16 = torch.bfloat16

    # qwen2-0.5b: float32 against the CPU, then its weights cast to the
    # config's bfloat16 for the timed rows
    cfg32 = lm_config(QWEN, dtype="float32")
    params32, init_s = lm_init(cfg32, torch.float32)
    print("lm model: " + json.dumps({
        "arch": QWEN, "layers": cfg32.n_layers, "d_model": cfg32.d_model,
        "params": cfg32.param_count(), "float32_mib": tree_mib(params32),
        "init_s": init_s, "card": card}), flush=True)
    print("lm check: " + json.dumps(lm_check(f"{QWEN} float32", cfg32,
                                             params32, card, by_path)),
          flush=True)
    cfg = lm_config(QWEN)
    params = tree_map(lambda t: t.to(getattr(torch, cfg.dtype)), params32)
    qwen_embed = params32["embed"]
    del params32
    torch.cuda.empty_cache()
    for row in (lm_prefill_row, lm_decode_row, lm_serve_row):
        line = row(QWEN, cfg, params, by_path, card)
        MEASURED[f"lm {line['row']}"] = line
        print("lm: " + json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    print("lm attention: " + json.dumps(lm_attention_yardstick(cfg, card)),
          flush=True)
    del params
    torch.cuda.empty_cache()

    # deepseek-v2-lite-16b: 2 of its 27 layers in float32 against the CPU,
    # then all 27 held in bfloat16 (a layer at a time) for the timed rows
    full = lm_config(DEEPSEEK)
    cfg32 = lm_config(DEEPSEEK, dtype="float32",
                      n_layers=min(DEEPSEEK_CHECK_LAYERS, full.n_layers))
    params32, init_s = lm_init(cfg32, torch.float32)
    check = lm_check(f"{DEEPSEEK} float32, {cfg32.n_layers} of "
                     f"{full.n_layers} layers", cfg32, params32, card,
                     by_path)
    check["float32_mib"] = tree_mib(params32)
    print("lm check: " + json.dumps(check), flush=True)
    del params32
    torch.cuda.empty_cache()
    params, init_s = lm_init(full, bf16)
    print("lm model: " + json.dumps({
        "arch": DEEPSEEK, "layers": full.n_layers, "d_model": full.d_model,
        "params": full.param_count(), "bfloat16_mib": tree_mib(params),
        "init_s": init_s, "card": card}), flush=True)
    cases = lm_gather_cases(qwen_embed, params, full, flush)
    del qwen_embed
    torch.cuda.empty_cache()
    print("lm late_gather: " + json.dumps({**cases, "card": card}),
          flush=True)
    for row in (lm_prefill_row, lm_decode_row):
        print("lm: " + json.dumps(row(DEEPSEEK, full, params, by_path,
                                      card)), flush=True)
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    require(by_path["lm"]["late_gather"] > 0,
            "the LM path never launched late_gather")
    print(f"lm phase: {time.perf_counter() - t_phase:.3f} s (host clock), "
          f"launches {json.dumps(by_path['lm'])}", flush=True)
    return cases


# ---------------------------------------------------------------------------
# phase 10: LM training (models/transformer.py's make_train_step,
# launch/train.py's TrainRun)
# ---------------------------------------------------------------------------

# (the phase collects Python's garbage between runs: the first recomputed
# call in a process leaves its frames, and with them that step's tensors,
# in a reference cycle that only the cyclic collector frees, through the
# lazy imports torch.utils.checkpoint makes on its first call)
# the card against the port's CPU run of the same float32 weights and
# lm_batch batch: the loss within TRAIN_LM_TOL relative, each gradient leaf
# within TRAIN_LM_TOL of the leaf's largest (phase 8's training tolerance)
TRAIN_LM_TOL = 1e-4
# layers of the check rows: qwen2's 24 and deepseek's 27 cut to 2 for the
# CPU run (deepseek's float32 weights and gradients ~12 GB on the host; the
# CPU takes no optimizer step, the card's gradients are read off its step)
TRAIN_LM_CHECK_LAYERS = 2
# the timed rows: train_4k (S = 4096, B = 256) cut in batch, deepseek also
# cut in layers to what its float32 weights, gradients and AdamW moments
# leave room for on 80 GB; qwen2's run saves a checkpoint at resume_at,
# from which a restored run takes the remaining steps again
TRAIN_LM_FULL = dict(check=dict(batch=2, seq=64),
                     rows={QWEN: dict(batch=16, layers=None, resume=True),
                           DEEPSEEK: dict(batch=8, layers=2, resume=False)},
                     seq=LM_SHAPES["train_4k"]["seq"], steps=4, resume_at=2)
TRAIN_LM_REHEARSAL = dict(check=dict(batch=2, seq=16),
                          rows={QWEN: dict(batch=2, layers=None, resume=True),
                                DEEPSEEK: dict(batch=2, layers=2,
                                               resume=False)},
                          seq=32, steps=4, resume_at=2)
# a resumed run on the card against the straight one: the gradients' adds
# (index_add_) are atomics, so the runs are not bit-equal; the losses
# within TRAIN_RESUME_TOL relative, each parameter leaf within
# TRAIN_RESUME_TOL of its largest plus twice the sum of the steps' learning
# rates (AdamW's update is close to lr * sign(g), so a gradient near zero
# may take either sign in either run), and the moments within
# TRAIN_RESUME_TOL of the largest moment of their tree (mu or nu), not of
# their leaf's: a leaf whose gradient is a small difference of large terms,
# as the key bias's is, carries the two runs' differences at a larger share
# of its own size (2e-3 of the largest key-bias first moment in one run on
# an H100)
TRAIN_RESUME_TOL = 1e-3


def train_lm_shapes() -> dict:
    return TRAIN_LM_REHEARSAL if LM_SMOKE else TRAIN_LM_FULL


def lm_train_gathers(cfg, remat: bool) -> int:
    """``late_gather`` launches of one train step: the token lookup once,
    and each MoE layer's dispatch and combine, again in the backward's
    recompute under ``remat`` (the gradients are ``index_add_``s)."""
    if cfg.moe is None:
        return 1
    return 1 + (4 if remat else 2) * cfg.n_layers


def first_step_grads(state: dict, metrics: dict, b1: float):
    """The unclipped gradient of a first AdamW step, off its new first
    moments (zero before; the clipping's max norm is 1)."""
    unclip = max(1.0, float(metrics["grad_norm"]))
    return tree_map(lambda m: m / (1 - b1) * unclip, state["mu"])


def train_lm_check(arch: str, card: str, by_path: dict) -> dict:
    """One ``make_train_step`` step on the card with ``remat`` and without,
    each counted into the lm_train path, against the port's CPU run of the
    same float32 weights (TRAIN_LM_CHECK_LAYERS layers at full width) and
    ``lm_batch`` batch: its loss and gradients."""
    c = train_lm_shapes()["check"]
    gc.collect()
    full = lm_config(arch)
    cfg = lm_config(arch, dtype="float32",
                    n_layers=min(TRAIN_LM_CHECK_LAYERS, full.n_layers))
    params, _ = lm_init(cfg, torch.float32)
    host = lm_batch(LM_SEED, 0, c["batch"], c["seq"], cfg.vocab)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    label = f"train lm check {arch}"
    t0 = time.perf_counter()
    (want_loss, _), want = value_and_grad(
        tfm.lm_loss, tree_to(params, "cpu"),
        {k: torch.from_numpy(v) for k, v in host.items()}, cfg,
        has_aux=True)
    cpu_s = time.perf_counter() - t0
    want = tree_map(lambda t: t.to(DEVICE), want)  # compared on the card
    opt = train_steps.make_optimizer()
    row = {"check": label, "layers": f"{cfg.n_layers} of {full.n_layers}",
           "d_model": cfg.d_model, "batch": c["batch"], "seq": c["seq"],
           "loss_cpu": float(want_loss), "tol": TRAIN_LM_TOL,
           "cpu_s": cpu_s}
    grads = {}
    for remat in (True, False):
        step = tfm.make_train_step(dataclasses.replace(cfg, remat=remat),
                                   opt)
        state = opt.init(params)
        (new_params, new_state, m), launches = counted_into(
            by_path["lm_train"], lambda: step(params, state, batch))
        del new_params
        want_lg = lm_train_gathers(cfg, remat)
        require(launches == {**dict.fromkeys(KERNEL_OPS, 0),
                             "late_gather": want_lg},
                f"{label} remat={remat}: launches {launches}, want "
                f"late_gather {want_lg} times and nothing else")
        del state
        g = first_step_grads(new_state, m, opt.b1)
        del new_state
        loss_err = abs(float(m["loss"]) - float(want_loss)) / abs(
            float(want_loss))
        require(loss_err <= TRAIN_LM_TOL,
                f"{label} remat={remat}: loss {float(m['loss'])} against "
                f"the CPU's {float(want_loss)}")
        key = "remat" if remat else "no_remat"
        row[key] = {"loss": float(m["loss"]), "loss_rel_err": loss_err,
                    "grad_max_rel_err": leaf_errors(
                        g, want, f"{label} {key}", "the port's CPU run",
                        tol=TRAIN_LM_TOL),
                    "grad_norm": float(m["grad_norm"]),
                    "late_gather_launches": want_lg}
        grads[key] = g
        del g
        gc.collect()
        torch.cuda.empty_cache()
    row["remat_vs_no_remat_grad_rel_err"] = leaf_errors(
        grads["remat"], grads["no_remat"], f"{label} remat",
        "the step without remat", tol=TRAIN_LM_TOL)
    row["card"] = card
    del grads, want, params
    gc.collect()
    torch.cuda.empty_cache()
    return row


def timed_steps(run) -> tuple:
    """Wrap ``run.step_fn`` so each call's time (host clock, synchronized
    before and after) is appended to the returned list; returns the list
    and the unwrapped step."""
    inner, ms = run.step_fn, []

    def step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out
    run.step_fn = step
    return ms, inner


def gather_gradient_case(table: torch.Tensor, positions: torch.Tensor,
                         flush) -> dict:
    """``late_gather``'s gradient in the table (``LateGather``'s backward,
    an ``index_add_`` of the output gradient into zeroed rows) against the
    plain gather's own (``index_select``'s backward), both held against the
    sum in float64 within n·u of each element's sum of absolute terms (n
    the most terms a row gets, u the table dtype's unit roundoff: the
    worst rounding of a sum of n in any order); timed with its bound."""
    r, w = table.shape
    t = table.detach().requires_grad_(True)
    out = lg_ops.late_gather(t, positions)
    cot = torch.randn(out.shape, device=out.device,
                      generator=torch.Generator(device=DEVICE).manual_seed(
                          LM_SEED + 3)).to(table.dtype)
    plain_t = table.detach().requires_grad_(True)
    plain_out = late_gather_ref(plain_t, positions)

    def grad():
        return torch.autograd.grad(out, t, cot, retain_graph=True)[0]

    def plain():
        return torch.autograd.grad(plain_out, plain_t, cot,
                                   retain_graph=True)[0]
    got, want = grad(), plain()
    p = positions.long()
    p = torch.where(p < 0, p + r, p)
    slot = torch.where((p >= 0) & (p < r), p, r)
    wide = torch.zeros((r + 1, w), dtype=torch.float64, device=out.device
                       ).index_add_(0, slot, cot.double())[:r]
    sums = torch.zeros((r + 1, w), dtype=torch.float64, device=out.device
                       ).index_add_(0, slot, cot.double().abs())[:r]
    terms = int(torch.bincount(slot, minlength=r + 1)[:r].max())
    unit = 2.0 ** -8 if table.dtype == torch.bfloat16 else 2.0 ** -24
    tol = max(terms, 1) * unit
    errs = {}
    for name, g in (("kernel", got), ("plain", want)):
        err = (g.double() - wide).abs()
        require(bool((err <= tol * sums + 1e-30).all()),
                f"late_gather gradient {tuple(table.shape)} ({name}) off "
                f"the float64 sum beyond {tol} of the absolute sums")
        errs[name] = float((err / sums.clamp(min=1e-30)).max())
    del got, want, wide, sums
    es = table.element_size()
    p_n = positions.shape[0]
    nbytes = r * w * es + p_n * w * es + p_n * 4
    return {"shape": f"R={r} W={w} {str(table.dtype)[6:]} P={p_n}",
            "max_terms_a_row": terms, "tol_of_abs_sum": tol,
            "max_rel_err": errs["kernel"],
            "plain_max_rel_err": errs["plain"],
            "ms": time_ms(grad, flush), "plain_ms": time_ms(plain, flush),
            "library_ms": None, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes",
            "bound_uses": "the dense (R, W) gradient written once, the "
                          "(P, W) output gradient and the positions read "
                          "once",
            "what": "index_add_ into zeroed rows (atomics), the zeroing "
                    "included, as the reference's gradient is XLA's "
                    "scatter-add; plain_ms is index_select's backward"}


def saving_manager(directory: str) -> tuple:
    """A ``CheckpointManager`` over ``directory`` whose saves are timed
    (host clock from a synchronized card; the list it returns)."""
    mgr = CheckpointManager(directory)
    save, seconds = mgr.save, []

    def timed_save(step, tree):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(step, tree)
        seconds.append(time.perf_counter() - t0)
    mgr.save = timed_save
    return mgr, seconds


def train_lm_resume(arch: str, build, run, hist: list, tmp: str,
                    save_s: list) -> dict:
    """A run built from the checkpoint the straight run saved into ``tmp``
    at its step resume_at, and its remaining steps, against the straight
    run's state and losses."""
    sh = train_lm_shapes()
    at, steps, b = sh["resume_at"], sh["steps"], sh["rows"][arch]["batch"]
    opt = train_steps.make_optimizer()
    ckpt_mib = sum(f.stat().st_size for f in Path(tmp).iterdir()) / 2 ** 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = build(resume_dir=tmp)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    gc.collect()
    require(resumed.step == at, f"train lm {arch}: resumed at step "
            f"{resumed.step}, want {at}")
    tail = resumed.run(steps=steps, batch=b, seq=sh["seq"], seed=LM_SEED,
                       ckpt=None, log_every=steps)
    losses = [m["loss"] for m in tail]
    loss_err = max(abs(a - m["loss"]) / abs(m["loss"])
                   for a, m in zip(losses, hist[at:]))
    require(loss_err <= TRAIN_RESUME_TOL,
            f"train lm {arch}: resumed losses {losses} against "
            f"{[m['loss'] for m in hist[at:]]}")
    lr_sum = sum(float(opt.lr(torch.tensor(s + 1))) for s in range(steps))
    p_err = 0.0
    for g, w in zip(tree_leaves(resumed.params), tree_leaves(run.params)):
        scale = float(w.abs().max())
        err = float((g.float() - w.float()).abs().max())
        require(err <= TRAIN_RESUME_TOL * scale + 2 * lr_sum,
                f"train lm {arch}: a resumed parameter is {err} off (its "
                f"leaf's largest {scale})")
        p_err = max(p_err, err / scale)
    m_err = 0.0
    for name in ("mu", "nu"):
        got, want = (tree_leaves(t.opt_state[name]) for t in (resumed, run))
        largest = max(float(w.abs().max()) for w in want)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        require(err <= TRAIN_RESUME_TOL * largest,
                f"train lm {arch}: a resumed {name} leaf is {err} off (the "
                f"largest {name} {largest})")
        m_err = max(m_err, err / largest)
    require(int(resumed.opt_state["step"]) == steps,
            f"train lm {arch}: resumed state at step "
            f"{int(resumed.opt_state['step'])}")
    return {"resume_at": at, "save_s": save_s, "checkpoint_mib": ckpt_mib,
            "build_and_restore_s": restore_s, "losses": losses,
            "loss_max_rel_err": loss_err, "param_max_rel_err": p_err,
            "lr_sum": lr_sum, "moment_max_rel_err": m_err,
            "tol": TRAIN_RESUME_TOL}


def train_lm_row(arch: str, card: str, by_path: dict, flush) -> tuple:
    """``launch.train.build_run`` and ``TrainRun.run`` of ``arch`` for the
    steps of train_lm_shapes() (counted into the lm_train path, each
    step's ms read off a wrapper of the run's step; with ``resume``, the
    run saves a checkpoint at step resume_at through its
    ``CheckpointManager`` and goes on, and a run restored from it takes
    the remaining steps again), one step profiled, and ``late_gather``'s
    gradient at the row's lookup or layer-0 MoE; returns the row and the
    gradient cases."""
    sh = train_lm_shapes()
    r = sh["rows"][arch]
    b, seq, steps = r["batch"], sh["seq"], sh["steps"]
    base = lm_config(arch)
    cfg = base if r["layers"] is None else dataclasses.replace(
        base, n_layers=r["layers"])
    label = f"train lm {arch} train_4k"
    gc.collect()

    def build(resume_dir=None):
        def call():
            return train_launch.build_run(arch, smoke=LM_SMOKE,
                                          resume_dir=resume_dir,
                                          device=DEVICE)
        if cfg is base:
            return call()
        return with_patched(train_launch, "get_config",
                            lambda arch, smoke=False: (cfg, "lm"), call)
    t_row = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ms, inner = timed_steps(run)
    monitor = StragglerMonitor()
    with tempfile.TemporaryDirectory() as tmp:
        mgr, save_s = saving_manager(tmp)

        def straight():
            kw = dict(batch=b, seq=seq, seed=LM_SEED, log_every=steps,
                      monitor=monitor)
            head = run.run(steps=sh["resume_at"], ckpt=mgr, **kw) \
                if r["resume"] else []
            return head + run.run(steps=steps, ckpt=None, **kw)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        hist, launches = counted_into(by_path["lm_train"], straight)
        peak_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        want_lg = steps * lm_train_gathers(cfg, cfg.remat)
        require(launches == {**dict.fromkeys(KERNEL_OPS, 0),
                             "late_gather": want_lg},
                f"{label}: launches {launches}, want late_gather {want_lg} "
                "times and nothing else")
        require(len(hist) == steps and all(np.isfinite(v) for m in hist
                                           for v in m.values()),
                f"{label}: metrics {hist}")
        resume = train_lm_resume(arch, build, run, hist, tmp, save_s) \
            if r["resume"] else None
    warm = statistics.median(ms[1:])
    host = lm_batch(LM_SEED, steps, b, seq, cfg.vocab)
    data = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
    prof = profile_call(label, lambda: inner(run.params, run.opt_state,
                                             data), warm)
    row = {"row": label, "layers": f"{cfg.n_layers} of {base.n_layers}",
           "d_model": cfg.d_model, "batch": b, "seq": seq,
           "tokens_per_step": b * seq, "steps": steps, "remat": cfg.remat,
           "dtype": f"float32 weights, {cfg.dtype} compute",
           "cuts": (f"batch {LM_SHAPES['train_4k']['batch']} -> {b}"
                    + ("" if r["layers"] is None else
                       f"; layers {base.n_layers} -> {r['layers']}")),
           "step_ms": ms, "warm_ms": warm,
           "tok_per_s": b * seq / (warm / 1e3),
           "device_ms": prof["device_ms"], "host_share": prof["idle_share"],
           "device_launches": prof["device_launches"],
           "late_gather_launches": want_lg,
           "late_gather_launches_a_step": lm_train_gathers(cfg, cfg.remat),
           "peak_mib": peak_mib, "held_mib": held / 2 ** 20,
           "params_mib": tree_mib(run.params),
           "opt_state_mib": tree_mib(run.opt_state),
           "losses": [m["loss"] for m in hist],
           "stragglers": monitor.stragglers, "build_s": build_s,
           "resume": resume, "top": prof["top"]}
    del data
    torch.cuda.empty_cache()
    toks = torch.from_numpy(lm_batch(LM_SEED, 0, b, seq, cfg.vocab)[
        "tokens"]).to(DEVICE)
    if cfg.moe is None:
        cases = {"token_lookup": gather_gradient_case(
            run.params["embed"], toks.reshape(-1).to(torch.int32), flush)}
    else:
        with torch.no_grad():
            xt, route, y = moe_layer0(run.params, cfg, toks)
        cases = {"moe_dispatch": gather_gradient_case(xt, route.dispatch,
                                                      flush),
                 "moe_combine": gather_gradient_case(y, route.slot, flush)}
        del xt, route, y
    del run
    torch.cuda.empty_cache()
    row.update({"s": time.perf_counter() - t_row, "card": card})
    return row, cases


def train_lm_phase(card: str, by_path: dict, flush) -> dict:
    """Phase 10: ``make_train_step`` on the card against the port's CPU
    run (``train lm check:``, qwen2-0.5b and deepseek-v2-lite-16b at full
    width), then the timed rows through ``launch.train`` (``train lm:``)
    and ``late_gather``'s gradient at their shapes (``train lm late_gather
    gradient:``).  Returns the gradient cases."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    by_path["lm_train"] = dict.fromkeys(KERNEL_OPS, 0)
    for arch in (QWEN, DEEPSEEK):
        print("train lm check: " + json.dumps(train_lm_check(arch, card,
                                                             by_path)),
              flush=True)
        torch.cuda.empty_cache()
    cases, seconds = {}, {}
    for arch in (QWEN, DEEPSEEK):
        row, arch_cases = train_lm_row(arch, card, by_path, flush)
        seconds[arch] = row["s"]
        MEASURED[f"train lm {arch}"] = row
        print("train lm: " + json.dumps(row), flush=True)
        for name, case in arch_cases.items():
            print("train lm late_gather gradient: " + json.dumps(
                {"case": f"{arch} {name}", **case, "card": card}),
                flush=True)
        cases.update(arch_cases)
        torch.cuda.empty_cache()
    require(by_path["lm_train"]["late_gather"] > 0,
            "the LM training path never launched late_gather")
    print(f"train lm phase: {time.perf_counter() - t_phase:.3f} s (host "
          f"clock), rows {json.dumps(seconds)}, launches "
          f"{json.dumps(by_path['lm_train'])}", flush=True)
    return cases


# ---------------------------------------------------------------------------
# phase 11: the launch tooling (launch/{count,roofline,probe,dryrun,
# hillclimb}.py) and the examples (repro_torch/examples)
# ---------------------------------------------------------------------------

# the rows phases 8-10 printed, by label, whose warm ms the roofline reads
MEASURED: dict = {}
# the examples on the card at the reference scripts' widths, their steps
# and requests cut for the script's time (the cuts are printed)
EXAMPLES = dict(
    gnn_reddit=dict(nodes=20_000, edges=400_000, batch=512, steps=20),
    recsys_serve=dict(train_steps=10, train_batch=4096, serve_batch=512,
                      serve_requests=20, vocab_scale=0.01),
    train_lm=dict(steps=20, d_model=256, layers=4, batch=8, seq=128,
                  vocab=8192))
EXAMPLE_CUTS = {"gnn_reddit": "steps 100 -> 20",
                "recsys_serve": "train steps 50 -> 10, requests 50 -> 20",
                "train_lm": "steps 200 -> 20"}
# launch/hillclimb.py's documented variant of qwen2-prefill
HILLCLIMB_VARIANT = {"attn_q_block": 4096, "attn_chunk": 8192}
# the keys of a dry-run row and of a hillclimb row that phase 11 prints
DRYRUN_KEYS = ("arch", "shape", "flops_by_dtype", "hbm_bytes",
               "compulsory_bytes", "compute_s", "memory_s", "collective_s",
               "dominant", "model_flops", "useful_flops_ratio", "count_s",
               "counted_on")
HILLCLIMB_KEYS = ("arch", "shape", "label", "overrides", "flops",
                  "flops_by_dtype", "hbm_bytes", "compute_s", "memory_s",
                  "dominant", "roofline_frac", "count_s")


def count_on(build, device) -> launch_count.Count:
    """The count of one step built by ``build(device) -> (fn, args)``."""
    fn, args = build(device)
    _, c = launch_count.count_call(fn, *args)
    if str(device) != "meta":
        torch.cuda.synchronize()
    del fn, args
    return c


def lm_train_builder(arch: str, batch: int, layers):
    """``build(device) -> (fn, args)`` of phase 10's train step of
    ``arch``: ``train_4k``'s sequence at ``batch``, ``layers`` of the
    config's (``None``: all), float32 weights."""
    sh = train_lm_shapes()
    cfg = lm_config(arch, **({} if layers is None else {"n_layers": layers}))

    def build(device):
        plan = train_steps.build_lm_cell(
            cfg, dict(kind="train", seq=sh["seq"], batch=batch), device)
        return plan.fn, plan.args
    return build, cfg


def cell_builder(arch: str, shape: str):
    """``build(device) -> (fn, args)`` of phase 8's cell: on the card
    through :func:`train_cell` (phase 7's graphs), on ``meta`` through
    ``launch.steps.build_cell``."""
    def build(device):
        if str(device) == "meta":
            plan = train_steps.build_cell(arch, shape, smoke=TRAIN_SMOKE,
                                          device="meta")
        else:
            plan, _ = train_cell(arch, shape, "")
        return plan.fn, plan.args
    return build


def roofline_steps() -> list:
    """(label, build, measured row label, model FLOPs, compute dtype) of
    the steps phases 8 and 10 timed, at their cuts."""
    sh = train_lm_shapes()
    out = []
    for arch in (QWEN, DEEPSEEK):
        r = sh["rows"][arch]
        build, cfg = lm_train_builder(arch, r["batch"], r["layers"])
        out.append((f"{arch} train_4k (batch {r['batch']}, "
                    f"{cfg.n_layers} layers)", build, f"train lm {arch}",
                    roofline.lm_model_flops(cfg, r["batch"], sh["seq"],
                                            train=True), cfg.dtype))
    for arch, shape in (("graphsage-reddit", "ogb_products"),
                        ("deepfm", "train_batch")):
        out.append((f"{arch} {shape}", cell_builder(arch, shape),
                    f"train {arch} {shape}", None, None))
    return out


def prefill_count(arch: str) -> tuple:
    """Phase 9's prefill row on ``meta``: weights held in bfloat16, the
    (batch, seq) prompt of ``lm_shapes()``'s cut."""
    cfg = lm_config(arch)
    p = lm_shapes()["prefill"]
    params = tfm.init_lm(cfg, None, "meta", dtype=torch.bfloat16)
    toks = torch.empty((p["batch"], p["seq"]), dtype=torch.int32,
                       device="meta")
    _, c = launch_count.count_call(tfm.prefill, params, toks, cfg)
    return c, roofline.lm_model_flops(cfg, p["batch"], p["seq"],
                                      train=False), cfg.dtype


def measured_line(label: str, c, warm_ms: float, model_flops, dtype,
                  card: str) -> dict:
    """The count's bound beside a warm time phases 8-10 measured: the
    compulsory bound (arguments read once, outputs written once) and the
    eager one, each with its share of the warm time; for an LM step its
    MFU against the peak of its compute dtype."""
    comp = roofline.analyze(c, model_flops=model_flops,
                            memory_basis="compulsory")
    eager = roofline.analyze(c, memory_basis="hbm")
    warm_s = warm_ms / 1e3
    line = {"step": label, "warm_ms": warm_ms,
            "flops_by_dtype": comp["flops_by_dtype"],
            "compute_s": comp["compute_s"],
            "compulsory_memory_s": comp["memory_s"],
            "eager_memory_s": eager["memory_s"],
            "bound_s": comp["bound_s"], "bound_by": comp["dominant"],
            "share": comp["bound_s"] / warm_s,
            "eager_bound_s": eager["bound_s"],
            "eager_share": eager["bound_s"] / warm_s}
    if model_flops:
        line.update(model_flops=model_flops,
                    useful_flops_ratio=comp["useful_flops_ratio"],
                    mfu=model_flops / (warm_s * roofline.PEAK_FLOPS_BY_DTYPE[
                        dtype]))
    return {**line, "peaks": "data sheet", "card": card}


def run_quiet(fn) -> tuple:
    """``fn()`` with its printing caught: (result, the last printed
    lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().strip().splitlines()[-2:]


def examples_on_card(card: str, by_path: dict) -> dict:
    """The five examples on the card, each counted into the examples path
    (one ``examples:`` line each); returns quickstart's and
    bfs_traversal's results for the CPU comparison."""
    by_path["examples"] = dict.fromkeys(KERNEL_OPS, 0)
    sizes = EXAMPLES
    tree = {}

    def line(name, fn, headline, must, cuts="none"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (out, tail), launches = counted_into(by_path["examples"],
                                             lambda: run_quiet(fn))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        require(all(launches[k] > 0 for k in must)
                and launches["embedding_bag"] == 0
                and (must or not any(launches.values())),
                f"examples {name}: launches {launches}, want {sorted(must)} "
                "(none where that is empty) and no embedding_bag")
        row = {"example": name, "s": s, **headline(out),
               "launches": launches, "cuts": cuts, "tail": tail,
               "card": card}
        print("examples: " + json.dumps(row), flush=True)
        return out

    tree["quickstart"] = line(
        "quickstart", lambda: ex_quickstart.run(device=DEVICE),
        lambda o: {"engines": o["engines"],
                   "ranking": [lab for lab, _ in o["ranking"][:3]]},
        {"frontier_expand", "late_gather"})
    tree["bfs_traversal"] = line(
        "bfs_traversal", lambda: ex_bfs.run(device=DEVICE),
        lambda o: {k: o[k] for k in ("planner", "sweep", "batch",
                                     "directions")},
        {"frontier_expand", "late_gather"},
        cuts="the 8-device distributed section waits for ROADMAP item 11")
    g = sizes["gnn_reddit"]
    losses = line(
        "gnn_reddit", lambda: ex_gnn.run(g["nodes"], g["edges"], g["batch"],
                                         g["steps"], DEVICE),
        lambda o: {"first_loss": o["losses"][0],
                   "last_loss": o["losses"][-1],
                   "seeds_per_s": o["seeds_per_s"]},
        set(), EXAMPLE_CUTS["gnn_reddit"])["losses"]
    require(all(np.isfinite(losses)), f"gnn_reddit: losses {losses}")
    r = sizes["recsys_serve"]
    out = line(
        "recsys_serve", lambda: ex_recsys.run(**r, device=DEVICE),
        lambda o: {"first_loss": o["losses"][0],
                   "last_loss": o["losses"][-1], "p50_ms": o["p50_ms"],
                   "p99_ms": o["p99_ms"], "retrieval_ms": o["retrieval_ms"],
                   "top5": o["top5"]},
        {"late_gather"}, EXAMPLE_CUTS["recsys_serve"])
    require(all(np.isfinite(out["losses"])),
            f"recsys_serve: losses {out['losses']}")
    t = sizes["train_lm"]
    with tempfile.TemporaryDirectory() as ckpt:
        out = line(
            "train_lm", lambda: ex_train_lm.run(**t, ckpt_dir=ckpt,
                                                device=DEVICE),
            lambda o: {"params_m": o["params_m"],
                       "first_loss": o["losses"][0],
                       "last_loss": o["losses"][-1]},
            {"late_gather"}, EXAMPLE_CUTS["train_lm"])
    require(all(np.isfinite(out["losses"])),
            f"train_lm: losses {out['losses']}")
    return tree


def without_times(tree):
    """A result tree less its timings, its keys as JSON writes them."""
    if isinstance(tree, dict):
        return {str(k): without_times(v) for k, v in tree.items()
                if k not in ("ms",)}
    if isinstance(tree, (list, tuple)):
        return [without_times(v) for v in tree]
    return tree


def launch_phase(card: str, by_path: dict) -> None:
    """Phase 11: the roofline's peaks, each timed training step counted on
    the card and on ``meta`` (equal), their bounds beside the warm times
    phases 8-10 measured, the examples on the card and two of them on the
    CPU, then the dry run's qwen2 and deepseek rows and the hillclimb
    counts, all on ``meta``."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("roofline card: " + json.dumps({
        "peak_flops_by_dtype": roofline.PEAK_FLOPS_BY_DTYPE,
        "hbm_bytes_per_s": roofline.HBM_BW,
        "nvlink_bytes_per_s": roofline.NVLINK_BW,
        "source": roofline.PEAKS_SOURCE, "card": card}), flush=True)

    # each step counted on the card and on meta
    checked = {}
    for label, build, measured, model_flops, dtype in roofline_steps():
        t0 = time.perf_counter()
        on_card = count_on(build, DEVICE)
        card_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        on_meta = count_on(build, "meta")
        meta_s = time.perf_counter() - t0
        same = {k: getattr(on_card, k) == getattr(on_meta, k)
                for k in ("flops_by_dtype", "hbm_bytes", "compulsory_bytes",
                          "kernels")}
        require(all(same.values()),
                f"roofline check {label}: card {on_card.row()} and meta "
                f"{on_meta.row()} differ in {same}")
        print("roofline check: " + json.dumps({
            "step": label, "equal": same, **on_meta.row(),
            "card_count_s": card_s, "meta_count_s": meta_s,
            "card": card}), flush=True)
        checked[label] = (on_meta, measured, model_flops, dtype)
    for label, (c, measured, model_flops, dtype) in checked.items():
        warm = MEASURED[measured]["warm_ms"]
        print("roofline measured: " + json.dumps(measured_line(
            label, c, warm, model_flops, dtype, card)), flush=True)
    c, model_flops, dtype = prefill_count(QWEN)
    p = lm_shapes()["prefill"]
    print("roofline measured: " + json.dumps(measured_line(
        f"{QWEN} prefill_32k (batch {p['batch']})", c,
        MEASURED[f"lm {QWEN} prefill_32k"]["warm_ms"], model_flops, dtype,
        card)), flush=True)

    tree = examples_on_card(card, by_path)
    cpu_s = {}
    for name, mod in (("quickstart", ex_quickstart),
                      ("bfs_traversal", ex_bfs)):
        t0 = time.perf_counter()
        want, _ = run_quiet(lambda: mod.run(device="cpu"))
        cpu_s[name] = time.perf_counter() - t0
        got = without_times(json.loads(json.dumps(tree[name])))
        want = without_times(json.loads(json.dumps(want)))
        require(got == want, f"examples {name}: the card's rows and levels "
                f"differ from the CPU run:\n{got}\n{want}")
    print("examples: quickstart and bfs_traversal equal to their CPU runs "
          "(rows, levels, rankings, plans): " + json.dumps(
              {"cpu_s": cpu_s}), flush=True)

    for cell in registry.cells():
        if cell.arch not in (QWEN, DEEPSEEK):
            continue
        if cell.skip:
            line = {"arch": cell.arch, "shape": cell.shape,
                    "skipped": cell.skip}
        else:
            r = dryrun.run_cell(cell.arch, cell.shape, verbose=False,
                                probe=False)
            line = {k: r[k] for k in DRYRUN_KEYS}
            line["argument_gib"] = \
                r["memory_analysis"]["argument_size_in_bytes"] / 2 ** 30
        print("dryrun: " + json.dumps({**line, "card": card}), flush=True)

    runs = [(arch, shape, {}, "baseline")
            for arch, shape in hillclimb.CELLS.values()]
    runs.append((*hillclimb.CELLS["qwen2-prefill"], HILLCLIMB_VARIANT,
                 ",".join(f"{k}={v}" for k, v in HILLCLIMB_VARIANT.items())))
    hc = []
    for arch, shape, overrides, label in runs:
        r, _ = run_quiet(lambda: hillclimb.measure(arch, shape, overrides,
                                                   label=label))
        hc.append({**r, "arch": arch, "shape": shape})
        print("hillclimb: " + json.dumps({k: hc[-1][k]
                                          for k in HILLCLIMB_KEYS}),
              flush=True)
    base, variant = hc[0], hc[-1]
    print("hillclimb qwen2-prefill: " + json.dumps({
        "baseline_float32_flops": base["flops_by_dtype"]["float32"],
        "variant_float32_flops": variant["flops_by_dtype"]["float32"],
        "lower": variant["flops_by_dtype"]["float32"]
        < base["flops_by_dtype"]["float32"]}), flush=True)
    print(f"launch phase: {time.perf_counter() - t_phase:.3f} s (host "
          f"clock), launches {json.dumps(by_path['examples'])}", flush=True)


# ---------------------------------------------------------------------------
# phase 12: the distributed positional BFS

DIST_RANDOM_ROOTS = 2          # seeded inner vertices besides root 0
DIST_GROUP_TIMEOUT_S = 300.0


def counting_all_gathers(fn):
    """``fn()`` with ``ShardTargetExchange``'s all-gathers counted:
    (result, the calls, the bytes each call gathered)."""
    calls, nbytes = [], []
    inner = operators.all_gather_tiled

    def counted(t, group):
        out = inner(t, group)
        calls.append(1)
        nbytes.append(out.numel() * out.element_size())
        return out

    return with_patched(operators, "all_gather_tiled", counted, fn), \
        len(calls), nbytes


def require_same_outputs(got, want, label: str) -> None:
    """The five outputs of ``make_distributed_pbfs`` bit for bit."""
    for name, g, w in zip(("gpos", "vals", "count", "depth", "overflow"),
                          got, want):
        g = g.cpu()
        require(g.dtype == w.dtype and g.shape == w.shape
                and torch.equal(g.view(torch.uint8), w.view(torch.uint8)),
                f"{label}: {name} differs from the CPU run")


def distributed_phase(cols: dict, levels: list, card: str, by_path: dict,
                      flush) -> dict:
    """Phase 12: ``make_distributed_pbfs`` at world size 1 on the card
    (NCCL) against its gloo CPU run and the BFS oracle, counted into
    ``by_path["distributed"]``; ``late_gather`` at its payload take;
    then ``bfs_traversal``'s distributed section on the card.  Returns
    the ``late_gather`` case."""
    t_phase = time.perf_counter()
    v = SPEC.num_vertices
    inner = np.unique(cols["from"])
    roots = [0] + np.random.default_rng(ROOT_SEED + 1).choice(
        inner, DIST_RANDOM_ROOTS, replace=False).tolist()
    payload = np.concatenate([cols[n] for n in
                              payload_names(SPEC.payload_cols)], axis=1)
    host = [torch.from_numpy(cols["from"]), torch.from_numpy(cols["to"]),
            torch.from_numpy(payload)]
    dev = [t.to(DEVICE) for t in host]
    config_caps = EngineCaps(frontier=POSDB.frontier_cap,
                             result=POSDB.result_cap)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    init_default_group(0, 1, os.path.join(tmp, "store"), "cuda",
                       DIST_GROUP_TIMEOUT_S)
    try:
        meshes = {d: make_mesh((1,), ("data",), device_type=d)
                  for d in ("cuda", "cpu")}

        def build(device, caps):
            return make_distributed_pbfs(
                meshes[torch.device(device).type], ("data",), v, caps=caps,
                max_depth=MAX_DEPTH, num_payload_cols=SPEC.payload_cols,
                device=device)

        runs = [(r, CAPS) for r in roots] + [(0, config_caps)]
        card_fns = {c: build(DEVICE, c) for c in (CAPS, config_caps)}
        cpu_fns = {c: build("cpu", c) for c in (CAPS, config_caps)}
        for c in card_fns:      # one warm call each, outside the count
            card_fns[c](*dev, 0)
        torch.cuda.synchronize()

        by_path["distributed"] = dict.fromkeys(KERNEL_OPS, 0)
        (got, launches), gathers, gather_bytes = counting_all_gathers(
            lambda: counted_into(by_path["distributed"], lambda: [
                card_fns[c](*dev, r) for r, c in runs]))
        t0 = time.perf_counter()
        want = [cpu_fns[c](*host, r) for r, c in runs]
        cpu_s = time.perf_counter() - t0
        level_counts = []
        for (r, c), g, w in zip(runs, got, want):
            label = f"distributed root {r} caps {tuple(c)}"
            require_same_outputs(g, w, label)
            gpos, vals, count, depth, ovf = g
            live = gpos >= 0
            require(bool(torch.equal(vals[live], dev[2][gpos[live].long()]))
                    and not bool(vals[~live].any()),
                    f"{label}: values are not the payload rows at gpos")
            level_counts.append(int(depth) + 1)
            if c == config_caps:
                require(bool(ovf), f"{label}: frontier cap "
                        f"{c.frontier} must overflow on this tree")
                continue
            lv = levels if r == 0 else bfs_reference(
                cols["from"], cols["to"], r, MAX_DEPTH, v)
            oracle = set().union(*lv[:MAX_DEPTH + 1])
            require(not bool(ovf) and set(gpos[live].tolist()) == oracle,
                    f"{label}: live positions differ from the BFS oracle")
        want_launches = {**dict.fromkeys(KERNEL_OPS, 0),
                         "frontier_expand": sum(level_counts),
                         "late_gather": len(runs)}
        require(launches == want_launches,
                f"distributed path: launches {launches}, want "
                f"{want_launches}")
        require(gathers == sum(level_counts),
                f"distributed path: {gathers} all-gathers for "
                f"{sum(level_counts)} levels")

        fn0 = card_fns[CAPS]
        warm = warm_latency_ms(lambda: fn0(*dev, 0))
        prof = profile_call("distributed root 0", lambda: fn0(*dev, 0), warm)
        print("profile: " + json.dumps(prof), flush=True)
        gpos0 = got[0][0]
        positions = torch.where(gpos0 >= 0, gpos0,
                                dev[0].shape[0]).to(torch.int32)
        lg_case = late_gather_case([dev[2]], positions, flush)
        print("distributed late_gather case: " + json.dumps(lg_case),
              flush=True)
        print("distributed bfs: " + json.dumps({
            "world_size": 1, "backend": "nccl", "roots": roots,
            "counts": [int(g[2]) for g in got],
            "depths": [int(g[3]) for g in got],
            "overflow": [bool(g[4]) for g in got],
            "caps": [tuple(c) for _, c in runs],
            "warm_ms": warm, "device_ms": prof["device_ms"],
            "device_launches": prof["device_launches"],
            "idle_share": prof["idle_share"],
            "levels": level_counts, "all_gathers": gathers,
            "all_gather_bytes_per_level": sorted(set(gather_bytes)),
            "link_bytes_per_level": 0, "payload_link_bytes": 0,
            "kernel_launches": launches, "cpu_run_s": cpu_s,
            "card": card}), flush=True)

        # the example's section: one NCCL rank a card, spawned, against
        # as many spawned gloo ranks on the CPU
        world = torch.cuda.device_count()
        t0 = time.perf_counter()
        ex, _ = run_quiet(lambda: ex_bfs.run_distributed(device=DEVICE))
        ex_s = time.perf_counter() - t0
        ex_cpu, _ = run_quiet(lambda: ex_bfs.run_distributed(
            device="cpu", world_size=world))
        require(ex["world"] == ex_cpu["world"] == world
                and ex["counts"] == ex_cpu["counts"],
                f"examples distributed: {ex} against the CPU run {ex_cpu}")
        print("examples distributed: " + json.dumps({
            **ex, "cpu_counts": ex_cpu["counts"], "cpu_ms": ex_cpu["ms"],
            "s": ex_s, "card": card}), flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"distributed phase: {time.perf_counter() - t_phase:.3f} s (host "
          f"clock), launches {json.dumps(by_path['distributed'])}",
          flush=True)
    return lg_case


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script drives the port on a CUDA card")
    device_name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # phase 1: the card and the kernels' build
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s for "
          f"{sorted(reports) or 'nothing (already built)'}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # data: the same numpy tree on the card and on the CPU, with the edge
    # weights made as benchmarks/exp_weighted.py makes them
    t0 = time.perf_counter()
    cols = make_edge_table(SPEC)
    cols[WEIGHT_COL] = np.random.default_rng(SPEC.seed + 1).uniform(
        0.5, 2.0, SPEC.num_edges).astype(np.float32)
    ds = dataset_from_numpy(cols, SPEC.num_vertices, DEVICE)
    ds_cpu = dataset_from_numpy(cols, SPEC.num_vertices, "cpu")
    torch.cuda.synchronize()
    table_mb = sum(c.nbytes for c in ds.table.columns.values()) / 2 ** 20
    print(f"data: {SPEC.num_edges} edges, {table_mb:.1f} MiB of columns on "
          f"the card, {time.perf_counter() - t0:.3f} s")
    levels = bfs_reference(cols["from"], cols["to"], 0, MAX_DEPTH,
                           SPEC.num_vertices)
    values = value_oracle(levels, cols, SPEC.num_vertices)
    requests = make_requests(cols, SPEC.num_vertices)
    dense_requests = make_dense_requests(cols, SPEC.num_vertices)
    weighted_requests = make_weighted_requests(SPEC.num_vertices)
    out_cols = query("precursive").out_cols
    forced_plans = {   # (expand_fn, pull_fn) -> the plan, pull forced
        "diropt": lambda expand_fn=None, pull_fn=None: diropt_plan(
            CAPS, MAX_DEPTH, out_cols, pull_fn=pull_fn, **FORCE_PULL),
        "diropt_hybrid": lambda expand_fn=None, pull_fn=None:
            diropt_hybrid_plan(CAPS, MAX_DEPTH, out_cols,
                               expand_fn=expand_fn, pull_fn=pull_fn,
                               **FORCE_PULL)}
    t0 = time.perf_counter()
    expected = run_requests(ds_cpu, requests)
    expected_dense = run_requests(ds_cpu, dense_requests)
    expected_forced = {name: execute(make(), ds_cpu.context(), 0,
                                     SPEC.num_vertices)
                       for name, make in forced_plans.items()}
    t1 = time.perf_counter()
    expected_weighted = run_requests(ds_cpu, weighted_requests)
    print(f"cpu reference: {len(requests) + len(dense_requests)} requests "
          f"and {len(forced_plans)} forced-pull runs in {t1 - t0:.3f} s, "
          f"{len(weighted_requests)} weighted requests in "
          f"{time.perf_counter() - t1:.3f} s (host clock)")
    # the paper's engines on the deployment's table as the paper has it,
    # without the weight column (47 slots a row)
    paper_cols = {k: v for k, v in cols.items() if k != WEIGHT_COL}
    paper_requests = make_paper_requests(SPEC.num_vertices)
    id_to_pos = inverse_ids(cols)
    t0 = time.perf_counter()
    expected_paper = run_requests(
        dataset_from_numpy(paper_cols, SPEC.num_vertices, "cpu"),
        paper_requests)
    print(f"cpu reference: {len(paper_requests)} tuple and row-store "
          f"requests in {time.perf_counter() - t0:.3f} s (host clock)")

    # DeepFM at Criteo width: random weights on the card from a seeded CUDA
    # generator, copied to the CPU for the port's CPU run; TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    params = recsys.init_deepfm(
        DEEPFM, torch.Generator(device=DEVICE).manual_seed(PARAM_SEED),
        DEVICE)
    params_cpu = {k: (v.cpu() if k != "mlp" else
                      [{n: t.cpu() for n, t in lp.items()} for lp in v])
                  for k, v in params.items()}
    offsets_np = recsys.field_offsets(DEEPFM)
    offsets = torch.from_numpy(offsets_np).to(DEVICE)
    offsets_cpu = torch.from_numpy(offsets_np)
    recsys_requests = make_recsys_requests()
    t1 = time.perf_counter()
    expected_recsys = [serve(params_cpu, offsets_cpu, req)
                       for req in recsys_requests]
    expected_positions = [recsys.featurize(DEEPFM, req.dense, req.sparse,
                                           offsets_cpu)
                          for req in recsys_requests]
    print(f"deepfm: {recsys.total_rows(DEEPFM)} x {DEEPFM.embed_dim} "
          f"{DEEPFM.table_dtype} table "
          f"({params['table'].nbytes / 2 ** 20:.1f} MiB), MLP "
          f"{list(DEEPFM.mlp_dims)}, made in {t1 - t0:.3f} s; cpu reference "
          f"of {len(recsys_requests)} requests in "
          f"{time.perf_counter() - t1:.3f} s (host clock)")

    # phase 2: each kernel against its plain version on the card
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    targets, valid, level, emitted = widest_level(expected[0], cols,
                                                  CAPS.frontier)
    print(f"frontier_expand input: level {level} of root 0, "
          f"{int(valid.sum())} targets -> {emitted} edges")
    fe, fe_cases, fe_call = frontier_expand_phase(
        ds, targets, valid, CAPS.frontier, emitted, flush)
    print("frontier_expand cases: " + json.dumps(fe_cases))
    lg, lg_cases = late_gather_phase(ds, expected[0].positions.to(DEVICE),
                                     out_cols, flush)
    print("late_gather cases: " + json.dumps(lg_cases))
    diropt_root0 = expected_dense[DENSE_ENGINES.index("diropt") * 4]
    fp, fp_cases, fp_calls = frontier_pull_phase(
        ds, *pull_input(diropt_root0, cols, SPEC.num_vertices), flush)
    print(f"frontier_pull input: {fp['shape']}")
    print(f"frontier_pull hub input: {fp['hub']['shape']}")
    print("frontier_pull cases: " + json.dumps(fp_cases))
    # the lane axis of both per-level kernels: the batch's lanes at root
    # 0's widest expansion level and at diropt root 0's first pull level
    eight = batch_roots(cols, SPEC.num_vertices)
    lane_t, lane_v, lane_emitted = lane_targets(expected[:BATCH_ROOTS], cols,
                                                level, CAPS.frontier)
    fe_lanes, fe_lane_cases, fe_lane_call = frontier_expand_lane_phase(
        ds, lane_t, lane_v, CAPS.frontier, lane_emitted, flush)
    print("frontier_expand lane cases: " + json.dumps(fe_lane_cases))
    pull_level = pull_input(diropt_root0, cols, SPEC.num_vertices)[2]
    fp_lanes, fp_lane_cases, fp_lane_call = frontier_pull_lane_phase(
        ds, *pull_lane_input(expected[:BATCH_ROOTS], eight, cols,
                             SPEC.num_vertices, pull_level),
        pull_level, flush)
    print("frontier_pull lane cases: " + json.dumps(fp_lane_cases))
    fe["lanes"], fp["lanes"] = fe_lanes, fp_lanes
    bitmap_sum0 = expected_weighted[weighted_requests.index(
        Request("bitmap", "outbound", 0, "aggregate_sum"))]
    sp, sp_cases, sp_calls = spmm_segment_phase(bitmap_sum0, cols,
                                                SPEC.num_vertices, flush)
    print("spmm_segment cases: " + json.dumps(sp_cases))
    print("spmm_segment tile cases: "
          + json.dumps(spmm_tile_cases_on_card()))
    # the lane axis of spmm_segment: the aggregate_sum batch's lanes at
    # root 0's widest dense level
    sum_count = int(bitmap_sum0.count)
    sum_level = int(torch.bincount(bitmap_sum0.row_depths[:sum_count])
                    .argmax())
    sp_lanes, sp_lane_cases, sp_lane_call = spmm_segment_lane_phase(
        ds, *spmm_lane_input(expected[:BATCH_ROOTS], eight, cols,
                             SPEC.num_vertices, sum_level),
        sum_level, flush)
    print("spmm_segment lane cases: " + json.dumps(sp_lane_cases))
    sp["lanes"] = sp_lanes
    bulk = recsys_requests[P99_REQUESTS]
    bulk_pos = recsys.featurize(DEEPFM, bulk.dense.to(DEVICE),
                                bulk.sparse.to(DEVICE), offsets)
    eb, eb_cases, (bag_idx, bag_seg, bag_sums), eb_calls = \
        embedding_bag_phase(params["table"], bulk_pos, flush)
    print("embedding_bag cases: " + json.dumps(eb_cases))
    print("embedding_bag layout cases: "
          + json.dumps(embedding_bag_layout_cases_on_card()))
    lg_deepfm = late_gather_case([params["table"]], bag_idx, flush)
    print("late_gather deepfm case: " + json.dumps(lg_deepfm))
    kernels = {"frontier_expand": fe, "late_gather": lg,
               "frontier_pull": fp, "spmm_segment": sp, "embedding_bag": eb}

    # phase 3: each path at full size; the counters see only that path
    torch.cuda.reset_peak_memory_stats()
    by_path = {}
    paths = (("precursive", requests, expected),
             ("dense", dense_requests, expected_dense),
             ("weighted", weighted_requests, expected_weighted))
    got = {}
    for label, reqs, want in paths:
        reset_launches()
        got[label] = run_requests(ds, reqs)
        by_path[label] = read_launches()
        check_path(label, reqs, got[label], want, by_path[label],
                   expected_launches(reqs, want, SPEC.num_vertices), levels,
                   values, id_to_pos)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    # DeepFM serving, then the embedding_bag op as its users call it
    torch.cuda.reset_peak_memory_stats()
    held_mb = torch.cuda.memory_allocated() / 2 ** 20
    reset_launches()
    got_recsys = [serve(params, offsets, req) for req in recsys_requests]
    by_path["recsys"] = read_launches()
    recsys_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 - held_mb
    positions = [recsys.featurize(DEEPFM, req.dense.to(DEVICE),
                                  req.sparse.to(DEVICE), offsets)
                 for req in recsys_requests]
    flips = check_recsys(recsys_requests, got_recsys, expected_recsys,
                         positions, expected_positions)
    n_serve = sum(1 for req in recsys_requests if req.cand is None)
    require(by_path["recsys"] == {**dict.fromkeys(KERNEL_OPS, 0),
                                  "late_gather": n_serve},
            f"recsys path: launches {by_path['recsys']}, want late_gather "
            f"once per serve_scores call ({n_serve}) and nothing else")
    print(f"recsys path: {len(recsys_requests)} requests equal to the CPU "
          f"run (scores within {DEEPFM_TOL} where positions agree); bucket "
          f"flips {json.dumps(flips)}; launches "
          f"{json.dumps(by_path['recsys'])}; peak device memory "
          f"{recsys_peak_mb:.1f} MiB above the {held_mb:.1f} MiB held "
          f"before the path (the DeepFM parameters "
          f"{params_mb(params):.1f} MiB, the rest earlier phases')")
    reset_launches()
    got_bags = eb_ops.embedding_bag(params["table"], bag_idx, bag_seg,
                                    BULK_BATCH)
    by_path["bags"] = read_launches()
    require(torch.equal(got_bags, bag_sums),
            "bags path: the op differs from phase 2's call")
    require(by_path["bags"] == {**dict.fromkeys(KERNEL_OPS, 0),
                                "embedding_bag": 1},
            f"bags path: launches {by_path['bags']}")
    print(f"bags path: embedding_bag over {bag_idx.shape[0]} positions "
          f"into {BULK_BATCH} bags equal to phase 2; launches "
          f"{json.dumps(by_path['bags'])}")

    # batched roots: each call's counters zeroed just before it and read
    # just after, summed into the batch path
    by_path["batch"] = dict.fromkeys(KERNEL_OPS, 0)
    batch_lines = {}
    for b in make_batches(cols, SPEC.num_vertices):
        line = run_batch(ds, b, levels, card)
        batch_lines[str(b)] = line
        for name, n in line["launches"].items():
            by_path["batch"][name] += n
        print("batch: " + json.dumps(line))

    # the paper's tuple-based and row-store engines: their table and its
    # row table come to the card after the paths above, whose peak memory
    # they leave as it was; the row table is built on the first row-store
    # request
    t_paper = time.perf_counter()
    ds_paper = dataset_from_numpy(paper_cols, SPEC.num_vertices, DEVICE)
    reset_launches()
    got["paper"] = run_requests(ds_paper, paper_requests)
    by_path["paper"] = read_launches()
    check_path("paper", paper_requests, got["paper"], expected_paper,
               by_path["paper"], expected_launches(
                   paper_requests, expected_paper, SPEC.num_vertices),
               levels, values, id_to_pos)
    rows_pos, rows_level = widest_row_block(
        got["paper"][VALUE_ENGINE_NAMES.index("rowstore")], id_to_pos,
        CAPS.frontier, SPEC.num_edges)
    lg["rows_case"] = late_gather_case([ds_paper.rows.data],
                                       rows_pos.to(DEVICE), flush)
    lg["rows_case"]["shape"] += f" level={rows_level} (rowstore root 0)"
    print("late_gather rows case: " + json.dumps({**lg["rows_case"],
                                                  "card": card}))
    paper_s = time.perf_counter() - t_paper

    dense_got = dict(zip(dense_requests, got["dense"]))
    for req, r in dense_got.items():
        if req.engine in PUSH_COUNTERPART:
            twin = req._replace(engine=PUSH_COUNTERPART[req.engine])
            require_same_rows(r, dense_got[twin], str(req))
    root0_pulls = sum(1 for d in dense_got[Request("diropt", "outbound", 0)]
                      .level_dirs.tolist() if d == 1)
    require(root0_pulls >= 2, f"diropt root 0 pulled {root0_pulls} levels")

    # the switch forced to pull on every level, root 0 outbound
    for name, make in forced_plans.items():
        reset_launches()
        r = execute(make(expand_fn=fe_ops.frontier_expand_fused,
                         pull_fn=fp_ops.frontier_pull_fused),
                    ds.context(), 0, SPEC.num_vertices)
        pulls = read_launches()["frontier_pull"]
        label = f"{name} forced pull root 0"
        require_equal(r, expected_forced[name], label)
        require(bool((r.level_dirs[:int(r.depth)] == 1).all()),
                f"{label}: a level was not pulled")
        require(pulls == int(r.depth),
                f"{label}: frontier_pull launched {pulls} times for "
                f"{int(r.depth)} levels")
        require_same_rows(r, dense_got[Request(PUSH_COUNTERPART[name],
                                               "outbound", 0)], label)
        print(f"{label}: {int(r.depth)} pull levels, equal to the CPU run "
              f"and to {PUSH_COUNTERPART[name]}")

    warm = {}
    all_requests = requests + dense_requests + weighted_requests
    for req, r in zip(all_requests, got["precursive"] + got["dense"]
                      + got["weighted"]):
        if req.workload == "reach" and req.engine != "precursive" and \
                (req.direction, req.root) != ("outbound", 0):
            continue
        warm[req] = warm_latency_ms(lambda req=req: run_request(ds, req))
        dirs = ("" if r.level_dirs is None else
                f" level_dirs {r.level_dirs[:int(r.depth)].tolist()}")
        print(f"request {req}: count {int(r.count)} depth {int(r.depth)} "
              f"overflow {bool(r.overflow)} warm latency {warm[req]:.3f} ms "
              f"(median of 3, host clock){dirs}")
    layouts_mb = {d: l.nbytes / 2 ** 20 for d, l in ds.pull_layouts.items()}
    for req, r in zip(paper_requests, got["paper"]):
        warm[req] = warm_latency_ms(lambda req=req: run_request(ds_paper,
                                                                req))
        print(f"request {req}: count {int(r.count)} depth {int(r.depth)} "
              f"overflow {bool(r.overflow)} warm latency {warm[req]:.3f} ms "
              f"(median of 3, host clock)")
    print(f"main path: {len(all_requests)} requests equal to the CPU run; "
          f"peak device memory {peak_mb:.1f} MiB, frontier_pull layouts "
          f"{json.dumps(layouts_mb)} MiB of it")
    # every engine's root 0 (PERF.md's limit reads these), the fused view's
    # widest PRecursive request, the two weighted paths' root 0, and the
    # inbound aggregate_sum whose kernel rows are skewed (vertex 0 owns
    # 83,619 inbound edges)
    measured = {}       # (payload columns, engine) -> Exp 1-3 numbers
    for req in [Request("precursive", "outbound", 0),
                Request("precursive", "both", SPEC.num_vertices - 1),
                *(Request(engine, "outbound", 0) for engine in DENSE_ENGINES),
                Request("precursive", "outbound", 0, "shortest_path"),
                Request("bitmap", "outbound", 0, "aggregate_sum"),
                Request("bitmap", "inbound", SPEC.num_vertices - 1,
                        "aggregate_sum")]:
        prof = profile_call(str(req), lambda req=req: run_request(ds, req),
                            warm[req])
        print("profile: " + json.dumps(prof))
        if req == Request("precursive", "outbound", 0):
            # PRecursive reads no weight, so its Exp 2-3 request is this
            measured[SPEC.payload_cols, req.engine] = exp_numbers(warm[req],
                                                                  prof)

    forced = forced_plans["diropt"](expand_fn=fe_ops.frontier_expand_fused,
                                    pull_fn=fp_ops.frontier_pull_fused)

    def forced_call():
        return execute(forced, ds.context(), 0, SPEC.num_vertices)
    ms = warm_latency_ms(forced_call)
    label = "diropt forced pull root 0"
    print(f"request {label}: warm latency {ms:.3f} ms (median of 3, host "
          f"clock)")
    print("profile: " + json.dumps(profile_call(label, forced_call, ms)))

    one_p99, retrieval = recsys_requests[0], recsys_requests[-1]
    for req in (one_p99, bulk, retrieval):
        def fn(req=req):
            return serve(params, offsets, req)
        ms = warm_latency_ms(fn)
        print(f"request {req}: warm latency {ms:.3f} ms (median of 3, host "
              f"clock, the features' copy to the card included)")
        print("profile: " + json.dumps(profile_call(str(req), fn, ms)))

    def bags_call():
        return eb_ops.embedding_bag(params["table"], bag_idx, bag_seg,
                                    BULK_BATCH)
    ms = warm_latency_ms(bags_call)
    label = f"embedding_bag bags B={BULK_BATCH} I={bag_idx.shape[0]}"
    print(f"request {label}: warm latency {ms:.3f} ms (median of 3, host "
          f"clock, the wrapper's sort included)")
    print("profile: " + json.dumps(profile_call(label, bags_call, ms)))
    for engine in ("precursive", "diropt"):
        b = Batch(engine, "outbound", tuple(eight))

        def batch_call(b=b):
            return run_query_batch(query(b.engine, b.direction), ds,
                                   list(b.roots))
        print("profile: " + json.dumps({**profile_call(
            f"batch {b}", batch_call, batch_lines[str(b)]["warm_ms"]),
            "card": card}))

    t0 = time.perf_counter()
    for req in paper_requests:
        prof = profile_call(str(req), lambda req=req: run_request(ds_paper,
                                                                  req),
                            warm[req])
        print("profile: " + json.dumps({**prof, "card": card}))
        if (req.direction, req.root) == ("outbound", 0):
            measured[SPEC.payload_cols, req.engine] = exp_numbers(warm[req],
                                                                  prof)
    profiles_s = time.perf_counter() - t0

    # the paper's Exp 1-3; Exp 1 on the same tree with no payload column:
    # make_edge_table draws the payload columns last, so that table is
    # this one less them
    spec0 = SPEC._replace(payload_cols=0)
    ds0 = dataset_from_numpy({k: cols[k] for k in ("id", "from", "to",
                                                   "name")},
                             spec0.num_vertices, DEVICE)
    for name, fig, engines, payload, baseline in EXPERIMENTS:
        on = (ds0, spec0, levels, id_to_pos) if payload == 0 \
            else (ds_paper, SPEC, levels, id_to_pos)
        print(f"{name}: " + json.dumps(exp_line(
            name, fig, engines, payload, baseline, *on, card, measured)))
    del ds0
    print(f"paper engines: {paper_s:.3f} s for their path and the rows "
          f"case, {profiles_s:.3f} s for their warm and profile lines, "
          f"{time.perf_counter() - t0 - profiles_s:.3f} s for Exp 1-3 "
          f"(host clock)")

    fe.update(expand_profile(fe_call, flush))
    sp["profile"] = spmm_profile(sp_calls, flush)
    print("spmm_segment profile: " + json.dumps(sp["profile"]))
    eb_profile = bag_profile(eb_calls, flush)
    eb["kernel_device_ms"] = eb_profile["a"]["kernel_device_ms"]
    print("embedding_bag profile: " + json.dumps(
        {case: {"ms": eb_cases[case]["ms"], **p}
         for case, p in eb_profile.items()}))
    fp_profile = pull_profile(fp_calls, flush)
    fp["kernel_device_ms"] = \
        fp_profile["main"]["device_ms_by_kernel"]["frontier_pull_rows"]
    fp["device_launches_per_call"] = \
        fp_profile["main"]["device_launches_per_call"]
    print("frontier_pull profile: " + json.dumps(fp_profile))
    # the lane axis keeps one lane's device launches: 3, and 1 for the
    # pull over the outbound layout, which has no hub tile
    fe_lanes.update(expand_profile(fe_lane_call, flush))
    fp_lanes.update(pull_profile({"lanes": fp_lane_call}, flush)["lanes"])
    print("frontier_expand lanes: " + json.dumps({**fe_lanes,
                                                  "card": card}))
    print("frontier_pull lanes: " + json.dumps({**fp_lanes, "card": card}))
    sp_lanes.update(spmm_profile({"lanes": sp_lane_call}, flush)["lanes"])
    print("spmm_segment lanes: " + json.dumps({**sp_lanes, "card": card}))
    # the weighted and value-engine batches after every earlier profile
    # line, whose numbers their memory stays out of
    value_batch_phase(ds, ds_paper, cols, levels, values, id_to_pos, card,
                      by_path)
    # MS-BFS and the bucket executor last: their host and device memory
    # stay out of every earlier path's numbers
    multiquery_phase(ds_paper, paper_cols, levels, card, by_path)
    del ds_paper
    # the planner path, on the table with the weight column
    planner_phase(ds, ds_cpu, cols, levels, values, card, by_path)
    # the serving layer last, on the same table
    serving_phase(ds, ds_cpu, cols, levels, values, id_to_pos, card,
                  by_path)
    # GNN inference last: its graphs come to the card after every earlier
    # path, whose numbers their memory stays out of
    del ds, ds_cpu
    torch.cuda.empty_cache()
    sp["ogb_products"] = gnn_phase(card, by_path, flush)
    # training last: the same graphs again, at the cells' own seeds
    sp["ogb_products_backward"], lg["train_gradient"] = train_phase(
        card, by_path, flush)
    # LM serving, then LM training: their models come to the card after
    # every earlier path
    lg["lm"] = lm_phase(card, by_path, flush)
    lg["lm_train_gradient"] = train_lm_phase(card, by_path, flush)
    # the launch tooling and the examples (phase 8's graphs again)
    launch_phase(card, by_path)
    _GRAPHS.clear()
    # the distributed BFS last, on the deployment's tree again
    lg["distributed"] = distributed_phase(cols, levels, card, by_path, flush)
    for name, entry in kernels.items():
        entry["launches"] = sum(n[name] for n in by_path.values())
        entry["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
        require(entry["launches"] > 0, f"{name} was never launched")
    require(by_path["weighted"]["spmm_segment"] > 0,
            "the weighted path never launched spmm_segment")
    require(by_path["batch_values"]["spmm_segment"] > 0,
            "the weighted batches never launched spmm_segment")
    for path, n in by_path.items():
        require((n["embedding_bag"] > 0) == (path == "bags"),
                f"{path} path: embedding_bag launched {n['embedding_bag']} "
                f"times")
    print(f"script: {time.perf_counter() - t_start:.3f} s from the build "
          f"on (host clock)")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
