from .ops import (gcn_norm_spmm, segments, spmm_segment,  # noqa: F401
                  spmm_segment_sorted)
from .spmm_segment import spmm_segment_cuda             # noqa: F401
from .ref import SPMM_CASES, spmm_segment_ref, spmm_tile_case  # noqa: F401
