"""Optimizers, schedules and gradient clipping over parameter trees (the
reference's ``src/repro/optim``), with the tree helpers they share."""
from .adamw import AdamW, sgd_momentum                                # noqa: F401
from .clip import clip_by_global_norm, global_norm                    # noqa: F401
from .schedule import constant, cosine_decay, linear_warmup_cosine    # noqa: F401
from .tree import (leaves, make_train_step, tree_map,  # noqa: F401
                   value_and_grad)
