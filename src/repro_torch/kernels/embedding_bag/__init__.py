from .ops import (embedding_bag, embedding_bag_sorted,  # noqa: F401
                  fixed_hot_lookup)
from .embedding_bag import bag_layout, embedding_bag_cuda  # noqa: F401
from .ref import embedding_bag_ref                    # noqa: F401
