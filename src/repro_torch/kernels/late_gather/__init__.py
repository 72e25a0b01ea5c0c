from .ops import late_gather                        # noqa: F401
from .late_gather import late_gather_cuda           # noqa: F401
from .ref import late_gather_ref                    # noqa: F401
