from .ops import frontier_expand_fused                  # noqa: F401
from .frontier_expand import expand_index_cuda          # noqa: F401
from .ref import frontier_expand_ref                    # noqa: F401
