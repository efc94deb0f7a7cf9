"""Mamba2 (SSD -- state-space duality, arXiv:2405.21060) layer --
counterpart of `repro.models.ssm`.

The chunked SSD algorithm: within a chunk of Q tokens the output is a
masked, decay-weighted attention-like contraction; across chunks one
recurrent state (nh, hp, state) is carried by a loop over the chunks.
Train and prefill cost O(T*Q); decode is an O(1) recurrence.

Layer structure: in_proj -> [z | x | B | C | dt], causal depthwise conv
on [x|B|C], SSD with per-head scalar decay A, skip D, gated RMSNorm,
out_proj.

Decode cache: {"conv": (B, d_conv-1, convdim), "ssm": (B, nh, hp, state)},
updated in place by a decode step.  Served on a grid
(`repro_torch.sharding.serving`), a rank holds its blocks of both as the
rules split them on "model" while the layer runs whole on the model
line: a decode step gathers the blocks over the line, computes alike on
every rank and writes back the rank's blocks; prefill keeps them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ModelConfig, ParamInit, param, rmsnorm
from repro_torch.sharding import serving

__all__ = ["SSM", "ssm_cache_spec"]


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    nh = cfg.nh_ssm
    hp = d_in // nh
    g = cfg.ssm_groups
    st = cfg.ssm_state
    convdim = d_in + 2 * g * st
    proj = 2 * d_in + 2 * g * st + nh
    return d_in, nh, hp, g, st, convdim, proj


def _split_proj(zxbcdt, cfg):
    d_in, _, _, _, _, convdim, _ = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + convdim]
    dt = zxbcdt[..., d_in + convdim:]
    return z, xbc, dt


def _split_xbc(xbc, cfg):
    d_in, _, _, g, st, _, _ = _dims(cfg)
    x = xbc[..., :d_in]
    bmat = xbc[..., d_in:d_in + g * st]
    cmat = xbc[..., d_in + g * st:]
    return x, bmat, cmat


def _conv_full(xbc, w, b):
    """Causal depthwise conv over time; xbc (B, T, C), w (K, C)."""
    k = w.shape[0]
    t = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + t, :] * w[i]
    return F.silu(out + b)


def _ssd_chunk(h, xq, bq, cq, dtq, A, rep: int):
    """One chunk of the scan: (h', y) from the carried state ``h``."""
    a = dtq * A                                   # (B,q,nh) log-decay <= 0
    cum = torch.cumsum(a, dim=1)                  # (B,q,nh)
    total = cum[:, -1]                            # (B,nh)
    bh = torch.repeat_interleave(bq, rep, dim=2)  # (B,q,nh,st)
    ch = torch.repeat_interleave(cq, rep, dim=2)
    xdt = xq * dtq[..., None].to(xq.dtype)        # (B,q,nh,hp)
    q = xq.shape[1]

    # intra-chunk: masked decay attention  L[i,j] = exp(cum_i - cum_j), j<=i
    scores = torch.einsum("bihs,bjhs->bhij", ch.float(), bh.float())
    ldiff = cum[:, :, None, :] - cum[:, None, :, :]          # (B,i,j,nh)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=xq.device))
    # mask BEFORE exp: the masked entries are exp(-inf) = 0 with a zero
    # gradient; exp(ldiff) overflows for j > i (0 * inf = NaN)
    decay = torch.exp(torch.where(causal[None, :, :, None], ldiff,
                                  -torch.inf))
    w = scores * decay.permute(0, 3, 1, 2)                   # (B,nh,i,j)
    y_intra = torch.einsum("bhij,bjhp->bihp", w.to(xq.dtype), xdt)

    # inter-chunk: the carried state's contribution
    y_inter = torch.einsum(
        "bihs,bhps->bihp",
        (ch.float() * torch.exp(cum)[..., None]).to(xq.dtype), h)

    # state: h' = h exp(total) + sum_j exp(total - cum_j) B_j xdt_j^T
    wj = torch.exp(total[:, None] - cum)                      # (B,q,nh)
    dh = torch.einsum("bjhs,bjhp->bhps",
                      (bh.float() * wj[..., None]).to(xq.dtype), xdt)
    h = h * torch.exp(total)[..., None, None].to(h.dtype) + dh
    return h, y_intra + y_inter


def _ssd_chunked(x, bmat, cmat, dt, A, cfg):
    """Chunked SSD scan.

    x (B,T,nh,hp), bmat/cmat (B,T,g,st) broadcast to heads, dt (B,T,nh) f32,
    A (nh,) negative.  Returns (y (B,T,nh,hp), h_final (B,nh,hp,st)).
    Each chunk is recomputed in the backward (not saved) when gradients
    flow, as the JAX scan body's checkpoint does.
    """
    _, nh, hp, g, st, _, _ = _dims(cfg)
    b_sz, t = x.shape[:2]
    q = min(cfg.ssm_chunk, t)
    nc = -(-t // q)
    pad = nc * q - t
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    rep = nh // g
    h = torch.zeros((b_sz, nh, hp, st), dtype=x.dtype, device=x.device)
    remat = torch.is_grad_enabled() and x.requires_grad
    ys = []
    for i in range(nc):
        sl = slice(i * q, (i + 1) * q)
        args = (h, x[:, sl], bmat[:, sl], cmat[:, sl], dt[:, sl], A, rep)
        h, y = (checkpoint(_ssd_chunk, *args, use_reentrant=False) if remat
                else _ssd_chunk(*args))
        ys.append(y)
    y = torch.cat(ys, dim=1)
    if pad:
        y = y[:, :t]
    return y, h


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_in, nh, _, _, _, convdim, proj = _dims(cfg)
        pd = cfg.param_dtype
        self.in_proj = param(init, (d, proj), pd)
        self.conv_w = param(init, (cfg.ssm_conv, convdim), pd, scale=0.5)
        self.conv_b = param(init, (convdim,), pd, zeros=True)
        self.A_log = param(init, (nh,), torch.float32, scale=1.0)
        self.D = param(init, (nh,), torch.float32, zeros=True)
        self.dt_bias = param(init, (nh,), torch.float32, zeros=True)
        self.norm = param(init, (d_in,), pd, zeros=True)
        self.out_proj = param(init, (d_in, d), pd)

    def forward(self, xin, *, mode: str = "train", cache=None):
        """Returns (out (B,T,d), new_cache)."""
        cfg = self.cfg
        b, t, _ = xin.shape
        d_in, nh, hp, g, st, _, _ = _dims(cfg)
        dt_f = xin.dtype

        zxbcdt = xin @ self.in_proj.to(dt_f)
        z, xbc_raw, dtp = _split_proj(zxbcdt, cfg)
        A = -torch.exp(self.A_log)                            # (nh,)
        dt = F.softplus(dtp.float() + self.dt_bias)

        new_cache = None
        if mode == "decode":
            if cache is None or t != 1:
                raise ValueError("SSM decode takes one token and a cache")
            conv_c, ssm_c = serving.ssm_whole(cache)
            conv_hist = torch.cat([conv_c, xbc_raw], dim=1)
            w, bias = self.conv_w.to(dt_f), self.conv_b.to(dt_f)
            k = w.shape[0]
            xbc = F.silu((conv_hist[:, -k:] * w[None]).sum(1) + bias)[:, None]
            x, bmat, cmat = _split_xbc(xbc, cfg)
            xh = x.reshape(b, 1, nh, hp)
            bh = torch.repeat_interleave(bmat.reshape(b, 1, g, st)[:, 0],
                                         nh // g, dim=1)
            ch = torch.repeat_interleave(cmat.reshape(b, 1, g, st)[:, 0],
                                         nh // g, dim=1)
            dt1 = dt[:, 0]                                    # (B,nh)
            da = torch.exp(dt1 * A)                           # (B,nh)
            xdt = xh[:, 0] * dt1[..., None].to(dt_f)
            h = (ssm_c * da[..., None, None].to(dt_f)
                 + torch.einsum("bhp,bhs->bhps", xdt, bh.to(dt_f)))
            y = torch.einsum("bhs,bhps->bhp", ch.to(dt_f), h)[:, None]
            serving.ssm_write(cache, conv_hist[:, -(k - 1):], h)
            new_cache = cache
        else:
            xbc = _conv_full(xbc_raw, self.conv_w.to(dt_f),
                             self.conv_b.to(dt_f))
            x, bmat, cmat = _split_xbc(xbc, cfg)
            xh = x.reshape(b, t, nh, hp)
            y, h = _ssd_chunked(xh, bmat.reshape(b, t, g, st),
                                cmat.reshape(b, t, g, st), dt, A, cfg)
            if mode == "prefill":
                k = self.conv_w.shape[0]
                new_cache = serving.ssm_block(
                    {"conv": xbc_raw[:, -(k - 1):], "ssm": h})

        y = y + xh * self.D[None, None, :, None].to(dt_f)
        y = y.reshape(b, t, d_in)
        y = rmsnorm(self.norm, y * F.silu(z), cfg.norm_eps)
        return y @ self.out_proj.to(dt_f), new_cache


def ssm_cache_spec(cfg: ModelConfig, batch: int, dtype):
    """Meta tensors (no storage) of one layer's decode cache."""
    _, nh, hp, _, st, convdim, _ = _dims(cfg)
    return {
        "conv": torch.empty((batch, cfg.ssm_conv - 1, convdim), dtype=dtype,
                            device="meta"),
        "ssm": torch.empty((batch, nh, hp, st), dtype=dtype, device="meta"),
    }
