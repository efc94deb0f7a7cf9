"""Mixture-of-Experts layer -- counterpart of `repro.models.moe`: top-k
routing, capacity-based dispatch, optional shared experts (qwen2-moe).

Each token-expert assignment gets a slot = its rank within its expert
(an exclusive cumsum of the flattened (n*k, e) one-hot, token-major then
k, the JAX order), the tokens are written into an (E, C, d) buffer, a
batched expert GLU runs, and the outputs are combined back with the
router weights.  Assignments past the capacity C are dropped (combine
weight 0).  JAX scatter-adds with ``mode="drop"``; here every kept
(expert, slot) pair is unique, so a plain indexed write gives the same
buffer: the dropped assignments are sent to a spare slot C that is cut
off before the experts run (no accumulate, so no atomics on the card, and
no host sync to compact the kept ones).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ModelConfig, ParamInit, param
from repro_torch.models.mlp import MLP

__all__ = ["MoE", "capacity"]


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    c = min(max(c, 1), n_tokens)
    # a multiple of 256 from 256 tokens on, as in the JAX package
    return -(-c // 256) * 256 if n_tokens >= 256 else c


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        d, e = cfg.d_model, cfg.n_experts
        f = cfg.d_ff_expert or cfg.d_ff
        self.router = param(init, (d, e), torch.float32)
        self.we_gate = param(init, (e, d, f), cfg.param_dtype)
        self.we_up = param(init, (e, d, f), cfg.param_dtype)
        self.we_down = param(init, (e, f, d), cfg.param_dtype)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, init, d_ff=f * cfg.n_shared_experts)

    def route(self, xt: torch.Tensor):
        """(gates (n, e) f32, top-k weights renormalised, top-k experts)."""
        gates = torch.softmax(xt.float() @ self.router, dim=-1)
        topw, topi = torch.topk(gates, self.cfg.top_k, dim=-1)
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
        return gates, topw, topi

    def forward(self, x: torch.Tensor):
        """x (B, T, d) -> ((B, T, d), {"moe_balance": aux})."""
        cfg = self.cfg
        b, t, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        n = b * t
        xt = x.reshape(n, d)
        # decode (t == 1): dropless, as serving never drops a live token
        c = capacity(cfg, n) if t > 1 else n

        gates, topw, topi = self.route(xt)
        onehot = F.one_hot(topi, e).to(torch.int32)          # (n, k, e)
        flat = onehot.reshape(n * k, e)
        ranks = torch.cumsum(flat, dim=0) - flat             # exclusive
        slot = (ranks * flat).sum(-1).reshape(n, k)          # (n, k)
        keep = slot < c
        w = topw * keep.to(topw.dtype)

        si = torch.where(keep, slot, c)                      # c: dropped
        buf = torch.zeros((e, c + 1, d), dtype=x.dtype, device=x.device)
        tok = torch.arange(n, device=x.device).repeat_interleave(k)
        buf = buf.index_put((topi.reshape(-1), si.reshape(-1)), xt[tok])
        ex_in = buf[:, :c]                                   # (e, c, d)

        dt = x.dtype
        g = torch.bmm(ex_in, self.we_gate.to(dt))
        u = torch.bmm(ex_in, self.we_up.to(dt))
        ex_out = torch.bmm(F.silu(g) * u, self.we_down.to(dt))

        gathered = ex_out[topi.reshape(-1),
                          torch.clamp(si, max=c - 1).reshape(-1)]
        out = (gathered.reshape(n, k, d) * w[..., None].to(dt)).sum(dim=1)

        if cfg.n_shared_experts:
            out = out + self.shared(x).reshape(n, d)

        # load-balancing aux (Switch-style): mean gate x mean assignment
        me = gates.mean(0)
        ce = onehot.sum(1).float().mean(0)
        aux = {"moe_balance": (me * ce).sum() * e}
        return out.reshape(b, t, d), aux
