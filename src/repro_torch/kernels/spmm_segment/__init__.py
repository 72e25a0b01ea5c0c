from .ops import (Grouping, SpmmSegment, gcn_norm_spmm,  # noqa: F401
                  segments, spmm_segment, spmm_segment_sorted,
                  transpose_grouping)
from .spmm_segment import spmm_segment_cuda             # noqa: F401
from .ref import (SPMM_CASES, spmm_segment_lanes_ref,  # noqa: F401
                  spmm_segment_ref, spmm_tile_case)
