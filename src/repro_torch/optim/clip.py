"""Global-norm gradient clipping (the reference's ``optim/clip.py``)."""
from __future__ import annotations

from typing import Any

import torch

from .tree import leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """``tree`` scaled by min(1, max_norm / its global norm), each leaf in
    its own dtype, and the norm before scaling."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                    tree), g
