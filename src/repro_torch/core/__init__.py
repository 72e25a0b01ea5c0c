"""Core: the paper's positional recursive-query engine, in PyTorch."""
from .table import ColumnTable, payload_names                      # noqa: F401
from .positions import (PosBlock, empty_block, compact_mask,       # noqa: F401
                        append_block)
from .csr import CSRIndex, build_csr, expand_frontier              # noqa: F401
