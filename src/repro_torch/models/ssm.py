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
updated in place by a decode step.

Inside a model split (`repro_torch.sharding.tensor`) whose ``out_proj``
block holds some of the heads (`tensor.ssm_splits`), the layer computes
those heads: the rank's columns of the whole ``in_proj`` (its heads' z,
x and dt, and the whole B / C of the one group), the conv on its channels,
the scan on its heads, the gated norm's sum of squares summed over the
model line (`tensor.sum_model`) and its ``out_proj`` rows, whose partial
output `tensor.from_model` sums.  Served on a grid
(`repro_torch.sharding.serving`) the rank's block of the state cache is
its heads, updated in place and never exchanged; the conv cache's rules
block is a contiguous run of channels, so a decode step gathers the
conv blocks over the model line (one exchange) for its channels'
history, and writes its block from the new [x | B | C] columns of that
block.  Where the heads do not divide the line the layer runs whole on
every rank of it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ModelConfig, ParamInit, param, rmsnorm
from repro_torch.sharding import serving, tensor

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


def _split_proj(zxbcdt, d_in: int, gst: int):
    """[z | x B C | dt] of a projection of ``d_in`` channels and ``gst``
    columns each of B and C (the whole layer's or a rank's)."""
    convdim = d_in + 2 * gst
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + convdim]
    dt = zxbcdt[..., d_in + convdim:]
    return z, xbc, dt


def _split_xbc(xbc, d_in: int, gst: int):
    x = xbc[..., :d_in]
    bmat = xbc[..., d_in:d_in + gst]
    cmat = xbc[..., d_in + gst:]
    return x, bmat, cmat


def _runs(cols) -> list:
    """Slices ``cols`` (in order) with the adjacent ones joined."""
    out = []
    for c in cols:
        if out and out[-1].stop == c.start:
            out[-1] = slice(out[-1].start, c.stop)
        else:
            out.append(c)
    return out


def _take(t: torch.Tensor, cols) -> torch.Tensor:
    """The columns ``cols`` (slices, in order) of ``t``'s last dim, in a
    new tensor -- never a view, so that the ranks of a line save alike
    whether or not their columns are contiguous (see `SSM.forward`)."""
    return torch.cat([t[..., c] for c in _runs(cols)], dim=-1)


def _part(cfg: ModelConfig, first: int, nh_l: int):
    """A rank's share of the layer's columns, heads ``[first, first +
    nh_l)``: (its ``in_proj`` columns [z | x | B C | dt], its conv
    channels [x | B C], its slice of the ``d_inner`` channels).  Its
    heads read every group's B and C: the whole layer's, or the one
    group's of a split (`tensor.ssm_splits`)."""
    d_in, _, hp, _, _, convdim, _ = _dims(cfg)
    xs = slice(first * hp, (first + nh_l) * hp)
    conv = (xs, slice(d_in, convdim))
    proj = (xs, slice(d_in + xs.start, d_in + xs.stop),
            slice(2 * d_in, d_in + convdim),
            slice(d_in + convdim + first, d_in + convdim + first + nh_l))
    return proj, conv, xs


def _within(cols, block: slice):
    """Where ``block`` lies in the concatenation of the slices ``cols``,
    as one slice, or None where no run of them holds all of it."""
    off = 0
    for c in _runs(cols):
        if c.start <= block.start and block.stop <= c.stop:
            return slice(off + block.start - c.start,
                         off + block.stop - c.start)
        off += c.stop - c.start
    return None


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

    x (B,T,nh,hp), bmat/cmat (B,T,g,st) broadcast to heads (``nh // g``
    a group), dt (B,T,nh) f32, A (nh,) negative: the layer's heads or a
    rank's (the counts are read off the shapes).  Returns (y
    (B,T,nh,hp), h_final (B,nh,hp,st)).  Each chunk is recomputed in the
    backward (not saved) when gradients flow, as the JAX scan body's
    checkpoint does.
    """
    b_sz, t, nh, hp = x.shape
    g, st = bmat.shape[2:]
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
        """Returns (out (B,T,d), new_cache): the layer on this rank's heads
        ``[first, first + nh_l)`` of a model split, or on every head (one
        rank, or a model line the heads do not divide; see the module
        docstring)."""
        cfg = self.cfg
        b, t, _ = xin.shape
        d_in, nh, hp, g, st, convdim, _ = _dims(cfg)
        nh_l = self.out_proj.shape[0] // hp
        first = tensor.share(nh_l, nh, "ssm_heads")
        split = first is not None
        first = first or 0
        dt_f = xin.dtype
        proj, conv, chans = _part(cfg, first, nh_l)
        d_l, heads = nh_l * hp, slice(first, first + nh_l)
        if split:
            xin = tensor.to_model(xin)

        # one product a run of the rank's columns: each saves a view of
        # the (cast) whole, which the unit gather's hooks pack and gather
        # again for the backward outside a checkpoint (`sharding.fsdp`),
        # on every rank alike, as `fsdp.gather_counts` counts
        w_in = self.in_proj.to(dt_f)
        zxbcdt = torch.cat([xin @ w_in[:, c] for c in _runs(proj)], dim=-1)
        z, xbc_raw, dtp = _split_proj(zxbcdt, d_l, g * st)
        A = -torch.exp(self.A_log[heads])                     # (nh_l,)
        dt = F.softplus(dtp.float() + self.dt_bias[heads])
        w, bias = _take(self.conv_w, conv).to(dt_f), \
            _take(self.conv_b, conv).to(dt_f)
        k = w.shape[0]
        if mode != "train":
            if serving.state_block(nh) != heads:
                raise ValueError(f"the SSM state cache's block of heads "
                                 f"{serving.state_block(nh)} is not the "
                                 f"layer's {heads}")
            block = serving.conv_block(convdim)
            at = _within(conv, block)

            def fresh(tail):
                """The raw [x | B | C] of the conv cache's rules block,
                tokens ``tail``: the rank's own columns where they hold
                the block, else the block's columns of the whole
                ``in_proj``."""
                if at is not None:
                    return xbc_raw[:, tail, at]
                return xin[:, tail] @ self.in_proj[
                    :, d_in + block.start:d_in + block.stop].to(dt_f)

        new_cache = None
        if mode == "decode":
            if cache is None or t != 1:
                raise ValueError("SSM decode takes one token and a cache")
            conv_hist = torch.cat(
                [_take(serving.conv_whole(cache["conv"]), conv), xbc_raw],
                dim=1)
            xbc = F.silu((conv_hist[:, -k:] * w[None]).sum(1) + bias)[:, None]
            x, bmat, cmat = _split_xbc(xbc, d_l, g * st)
            xh = x.reshape(b, 1, nh_l, hp)
            bh = torch.repeat_interleave(bmat.reshape(b, 1, g, st)[:, 0],
                                         nh_l // g, dim=1)
            ch = torch.repeat_interleave(cmat.reshape(b, 1, g, st)[:, 0],
                                         nh_l // g, dim=1)
            dt1 = dt[:, 0]                                    # (B,nh_l)
            da = torch.exp(dt1 * A)                           # (B,nh_l)
            xdt = xh[:, 0] * dt1[..., None].to(dt_f)
            h = (cache["ssm"] * da[..., None, None].to(dt_f)
                 + torch.einsum("bhp,bhs->bhps", xdt, bh.to(dt_f)))
            y = torch.einsum("bhs,bhps->bhp", ch.to(dt_f), h)[:, None]
            cache["conv"].copy_(torch.cat([cache["conv"], fresh(slice(None))],
                                          dim=1)[:, -(k - 1):])
            cache["ssm"].copy_(h)
            new_cache = cache
        else:
            x, bmat, cmat = _split_xbc(_conv_full(xbc_raw, w, bias), d_l,
                                       g * st)
            xh = x.reshape(b, t, nh_l, hp)
            y, h = _ssd_chunked(xh, bmat.reshape(b, t, g, st),
                                cmat.reshape(b, t, g, st), dt, A, cfg)
            if mode == "prefill":
                new_cache = {"conv": fresh(slice(-(k - 1), None)), "ssm": h}

        y = y + xh * self.D[heads][None, None, :, None].to(dt_f)
        y = y.reshape(b, t, d_l)
        # the gated RMSNorm over all d_inner channels: a split rank's sum
        # of squares is summed over the model line
        y = rmsnorm(self.norm[chans], y * F.silu(z), cfg.norm_eps,
                    d_in if split else None)
        out = y @ self.out_proj.to(dt_f)
        return (tensor.from_model(out) if split else out), new_cache


def ssm_cache_spec(cfg: ModelConfig, batch: int, dtype):
    """Meta tensors (no storage) of one layer's decode cache."""
    _, nh, hp, _, st, convdim, _ = _dims(cfg)
    return {
        "conv": torch.empty((batch, cfg.ssm_conv - 1, convdim), dtype=dtype,
                            device="meta"),
        "ssm": torch.empty((batch, nh, hp, st), dtype=dtype, device="meta"),
    }
