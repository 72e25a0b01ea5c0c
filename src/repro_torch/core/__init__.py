"""Core: the paper's positional recursive-query engine, in PyTorch."""
from .table import ColumnTable, RowTable, payload_names            # noqa: F401
from .positions import (PosBlock, empty_block, compact_mask,       # noqa: F401
                        append_block, take_late, sort_positions_by_key)
from .csr import CSRIndex, build_csr, expand_frontier              # noqa: F401
from .operators import (BFSResult, Context, EngineCaps, Pipeline,  # noqa: F401
                        TraversalState, fixed_point, fixed_point_batch,
                        execute, execute_batch)
from .recursive import (precursive_bfs, trecursive_bfs,            # noqa: F401
                        rowstore_bfs, trecursive_rewrite_bfs,
                        rowstore_rewrite_bfs)
from .bitmap import bitmap_bfs, hybrid_bfs                         # noqa: F401
