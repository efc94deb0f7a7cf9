"""Optimizers -- counterpart of `repro.optim`."""
from repro_torch.optim.optimizers import (
    BlockSplit, OptConfig, clip_by_global_norm, get_optimizer, global_norm,
    jax_leaves, lr_at,
)

__all__ = ["OptConfig", "get_optimizer", "clip_by_global_norm",
           "global_norm", "lr_at", "jax_leaves", "BlockSplit"]
