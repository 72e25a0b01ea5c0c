"""The paper's own workload as an arch: positional BFS over a tree.

1M-vertex tree, 8 payload columns, depth-16 traversal: the PRecursive
engine's deployment (the reference's ``src/repro/configs/posdb_bfs.py``,
whose ``frontier_cap`` is per shard of its production mesh).
"""
from .base import BFSConfig

CONFIG = BFSConfig(name="posdb-bfs", engine="precursive",
                   num_vertices=1 << 20, payload_cols=8, max_depth=16,
                   frontier_cap=1 << 15, result_cap=1 << 20)

SMOKE = BFSConfig(name="posdb-bfs-smoke", engine="precursive",
                  num_vertices=4096, payload_cols=2, max_depth=8,
                  frontier_cap=1024, result_cap=4096)
