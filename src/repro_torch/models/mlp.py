"""Gated-linear-unit MLP (SwiGLU / GeGLU) -- counterpart of
`repro.models.mlp`, used by every transformer arch.

Inside a model split (`repro_torch.sharding.tensor`) a rank whose
``w_gate`` holds its block of the mlp columns computes those:
``w_gate`` and ``w_up`` column-parallel on `tensor.to_model`'s input,
``w_down`` row-parallel, its partial output summed by
`tensor.from_model` (`partial` is the part between the two, which MoE's
shared experts share with the routed ones)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ModelConfig, ParamInit, param
from repro_torch.sharding import tensor

__all__ = ["MLP", "gelu"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, init: ParamInit, *,
                 d_ff: int | None = None):
        super().__init__()
        d = cfg.d_model
        f = d_ff or cfg.d_ff
        self.d_ff = f
        self.w_gate = param(init, (d, f), cfg.param_dtype)
        self.w_up = param(init, (d, f), cfg.param_dtype)
        self.w_down = param(init, (f, d), cfg.param_dtype)

    def split(self) -> bool:
        """Whether this rank holds a block of the mlp columns."""
        return tensor.share(self.w_gate.shape[1], self.d_ff,
                            "mlp") is not None

    def partial(self, x: torch.Tensor, act=F.silu) -> torch.Tensor:
        """The product on this rank's columns (all of them when whole)."""
        dt = x.dtype
        g = x @ self.w_gate.to(dt)
        u = x @ self.w_up.to(dt)
        return (act(g) * u) @ self.w_down.to(dt)

    def forward(self, x: torch.Tensor, act=F.silu) -> torch.Tensor:
        if not self.split():
            return self.partial(x, act)
        return tensor.from_model(self.partial(tensor.to_model(x), act))
