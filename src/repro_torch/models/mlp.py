"""Gated-linear-unit MLP (SwiGLU / GeGLU) -- counterpart of
`repro.models.mlp`, used by every transformer arch."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ModelConfig, ParamInit, param

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
        self.w_gate = param(init, (d, f), cfg.param_dtype)
        self.w_up = param(init, (d, f), cfg.param_dtype)
        self.w_down = param(init, (f, d), cfg.param_dtype)

    def forward(self, x: torch.Tensor, act=F.silu) -> torch.Tensor:
        dt = x.dtype
        g = x @ self.w_gate.to(dt)
        u = x @ self.w_up.to(dt)
        return (act(g) * u) @ self.w_down.to(dt)
