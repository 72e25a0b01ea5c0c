from .ops import late_gather, late_gather_columns     # noqa: F401
from .late_gather import late_gather_cuda           # noqa: F401
from .ref import late_gather_columns_ref, late_gather_ref  # noqa: F401
