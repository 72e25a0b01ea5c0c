from .ops import frontier_pull_fused                    # noqa: F401
from .frontier_pull import frontier_pull_cuda           # noqa: F401
from .ref import frontier_pull_ref                      # noqa: F401
