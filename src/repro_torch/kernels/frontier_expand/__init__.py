from .ops import frontier_expand_fused                  # noqa: F401
from .frontier_expand import MAX_LANES, frontier_expand_cuda  # noqa: F401
from .ref import (EXPAND_CASES, expand_case,  # noqa: F401
                  expand_lanes_case, frontier_expand_ref)
