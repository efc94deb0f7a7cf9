"""Transformer / SSM / hybrid blocks -- counterpart of `repro.models.blocks`.

A block is the unit that `repro_torch.models.model` stacks, one
``nn.Module`` per layer.  Every block's ``forward`` returns ``(x,
new_cache, aux)``: new_cache is None unless prefill/decode, aux a dict of
auxiliary scalars (the MoE balance loss).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.common import ModelConfig, ParamInit, param, rmsnorm
from repro_torch.models.mlp import MLP, gelu
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM

__all__ = ["DenseBlock", "MoEBlock", "SSMBlock", "CrossBlock",
           "EncoderBlock", "XDecBlock"]


class DenseBlock(nn.Module):
    """attn + GLU mlp."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.attn_norm = param(init, (d,), cfg.param_dtype)
        self.attn = Attention(cfg, init)
        self.mlp_norm = param(init, (d,), cfg.param_dtype)
        self.mlp = MLP(cfg, init)

    def forward(self, x, *, mode="train", window=0, positions=None,
                cache=None, cache_pos=None):
        eps = self.cfg.norm_eps
        h, new_cache = self.attn(
            rmsnorm(self.attn_norm, x, eps), mode=mode, window=window,
            positions=positions, cache=cache, cache_pos=cache_pos)
        x = x + h
        x = x + self.mlp(rmsnorm(self.mlp_norm, x, eps))
        return x, new_cache, {}


class MoEBlock(nn.Module):
    """attn + mixture of experts (optional shared experts)."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.attn_norm = param(init, (d,), cfg.param_dtype)
        self.attn = Attention(cfg, init)
        self.mlp_norm = param(init, (d,), cfg.param_dtype)
        self.moe = MoE(cfg, init)

    def forward(self, x, *, mode="train", window=0, positions=None,
                cache=None, cache_pos=None):
        eps = self.cfg.norm_eps
        h, new_cache = self.attn(
            rmsnorm(self.attn_norm, x, eps), mode=mode, window=window,
            positions=positions, cache=cache, cache_pos=cache_pos)
        x = x + h
        h, aux = self.moe(rmsnorm(self.mlp_norm, x, eps))
        return x + h, new_cache, aux


class SSMBlock(nn.Module):
    """mamba2."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        self.norm = param(init, (cfg.d_model,), cfg.param_dtype)
        self.ssm = SSM(cfg, init)

    def forward(self, x, *, mode="train", cache=None):
        h, new_cache = self.ssm(
            rmsnorm(self.norm, x, self.cfg.norm_eps),
            mode=mode if mode in ("prefill", "decode") else "train",
            cache=cache)
        return x + h, new_cache, {}


class CrossBlock(nn.Module):
    """llama-3.2-vision style: gated cross-attn + gated mlp."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        d, pd = cfg.d_model, cfg.param_dtype
        self.xattn_norm = param(init, (d,), pd)
        self.xattn = Attention(cfg, init)
        self.xattn_gate = param(init, (1,), pd, zeros=True)
        self.mlp_norm = param(init, (d,), pd)
        self.mlp = MLP(cfg, init)
        self.mlp_gate = param(init, (1,), pd, zeros=True)

    def forward(self, x, *, memory):
        eps = self.cfg.norm_eps
        h, _ = self.xattn(rmsnorm(self.xattn_norm, x, eps), mode="cross",
                          memory=memory)
        x = x + torch.tanh(self.xattn_gate.to(x.dtype)) * h
        h = self.mlp(rmsnorm(self.mlp_norm, x, eps))
        return x + torch.tanh(self.mlp_gate.to(x.dtype)) * h, None, {}


class EncoderBlock(DenseBlock):
    """whisper encoder: bidirectional attn + GELU mlp."""

    def forward(self, x):
        eps = self.cfg.norm_eps
        h, _ = self.attn(rmsnorm(self.attn_norm, x, eps), mode="encoder")
        x = x + h
        return x + self.mlp(rmsnorm(self.mlp_norm, x, eps), act=gelu)


class XDecBlock(nn.Module):
    """whisper decoder: causal self-attn, cross-attn, GELU mlp."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        d, pd = cfg.d_model, cfg.param_dtype
        self.attn_norm = param(init, (d,), pd)
        self.attn = Attention(cfg, init)
        self.xattn_norm = param(init, (d,), pd)
        self.xattn = Attention(cfg, init)
        self.mlp_norm = param(init, (d,), pd)
        self.mlp = MLP(cfg, init)

    def forward(self, x, *, memory, mode="train", positions=None,
                cache=None, cache_pos=None):
        eps = self.cfg.norm_eps
        h, new_cache = self.attn(
            rmsnorm(self.attn_norm, x, eps), mode=mode, positions=positions,
            cache=cache, cache_pos=cache_pos)
        x = x + h
        h, _ = self.xattn(rmsnorm(self.xattn_norm, x, eps), mode="cross",
                          memory=memory)
        x = x + h
        x = x + self.mlp(rmsnorm(self.mlp_norm, x, eps), act=gelu)
        return x, new_cache, {}
