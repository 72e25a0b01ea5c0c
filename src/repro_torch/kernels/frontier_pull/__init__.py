from .ops import frontier_pull_fused                    # noqa: F401
from .frontier_pull import MAX_LANES, frontier_pull_cuda  # noqa: F401
from .layout import PullLayout, build_pull_layout       # noqa: F401
from .ref import (PULL_CASES, frontier_pull_layout_ref,  # noqa: F401
                  frontier_pull_ref, pull_case, pull_lanes_case)
