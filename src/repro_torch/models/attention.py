"""Multi-head attention -- counterpart of `repro.models.attention`: GQA,
RoPE, optional QKV bias, sliding-window masks, KV caches (prefill /
decode), cross-attention, and the chunked (online-softmax) form for long
sequences.  Plain tensor ops, as the JAX module's einsums are: no
library attention kernel.

Modes (``mode`` argument of `Attention.forward`):
  "train"    causal self-attention over the whole sequence, no cache
  "encoder"  bidirectional self-attention (whisper encoder)
  "prefill"  causal self-attention that also RETURNS the (k, v) to cache
  "decode"   single-step: q has T=1; reads keys/values from the cache
  "cross"    queries over a fixed memory (encoder output / image tokens)

Inside a model split (`repro_torch.sharding.tensor`) a rank whose ``wq``
holds its block of the q heads projects those (and its block of the kv
heads when they divide; else the kv heads its q heads read, from the
whole ``wk`` / ``wv``), attends over them, and its ``wo`` block gives a
partial output summed over the model line (`tensor.from_model`); the
inputs come through `tensor.to_model`.

KV cache layout: {"k": (B, S, n_kv, hd), "v": (B, S, n_kv, hd)} with S the
static max length; ``cache_pos`` gives the current fill.  Decode writes
the step's keys and values into the given cache in place and returns it:
an indexed write (``index_copy_``), or, under the sharding hint
``kv_masked_write`` (`repro_torch.sharding.hints`), a one-hot masked
merge over S, the JAX package's form for a sequence-sharded cache; the
two write the same bits.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (
    ModelConfig, ParamInit, apply_rope, param, rope_freqs,
)
from repro_torch.sharding import hints, tensor

__all__ = ["Attention", "NEG_INF", "FULL_WINDOW"]

NEG_INF = -2.0 ** 30  # large-but-finite: keeps padded rows NaN-free
FULL_WINDOW = 2 ** 30  # "no sliding window" sentinel


def _repeat_kv(k: torch.Tensor, n_heads: int, heads=None) -> torch.Tensor:
    """(B, S, kvh, hd) -> (B, S, H, hd) by repeating each group; with
    ``heads`` (an index per q head into k's heads), by those."""
    if heads is not None:
        return k.index_select(2, heads)
    kvh = k.shape[2]
    if kvh == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kvh, dim=2)


def _position(pos, device) -> torch.Tensor:
    """``pos`` (an int or a 0-d tensor) as a (1,) index on ``device``, by
    a fill rather than a host-to-device copy, which would sync the card
    once a layer."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device).reshape(1)
    return torch.full((1,), pos, dtype=torch.int64, device=device)


def _keep(q_pos, k_pos, window):
    """(Tq, Tk) causal-and-window mask; ``window`` <= 0 means full."""
    w = FULL_WINDOW if window <= 0 else window
    keep = k_pos[None, :] <= q_pos[:, None]
    return keep & ((q_pos[:, None] - k_pos[None, :]) < w)


def _bias(keep):
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    return torch.where(keep, zero, NEG_INF)


def _mask_bias(mode, q_pos, k_pos, window):
    """(Tq, Tk) additive f32 bias from mode/window (None: no mask)."""
    if mode in ("encoder", "cross"):
        return None
    return _bias(_keep(q_pos, k_pos, window))


def _sdpa_full(q, k, v, bias):
    """q (B,Tq,H,hd), k/v (B,Tk,H,hd); logits and softmax in f32 (the
    operands cast up, as JAX's ``preferred_element_type``), weights cast
    to q's dtype for the value product."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float())
    logits = logits / math.sqrt(hd)
    if bias is not None:
        logits = logits + bias[None, None]
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", w, v)


def _sdpa_chunked(q, k, v, q_pos, k_pos, window, mode, chunk):
    """Online softmax over KV chunks with a running (max, sum, acc) in f32:
    O(Tq * chunk) logits instead of O(Tq * Tk).  Each chunk is
    recomputed in the backward (not saved) when gradients flow."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    n_chunks = -(-tk // chunk)
    pad = n_chunks * chunk - tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=2 ** 30)
    scale = 1.0 / math.sqrt(hd)
    masked = mode not in ("encoder", "cross")

    def body(m, s, acc, kb, vb, pb):
        logits = torch.einsum("bqhk,bshk->bhqs", q.float(), kb.float()) \
            * scale
        if masked:
            logits = logits + _bias(_keep(q_pos, pb, window))[None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(logits - m_new[..., None])
        s_new = s * alpha + pexp.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bhqs,bshk->bhqk", pexp.to(q.dtype).float(), vb.float())
        return m_new, s_new, acc_new

    m = torch.full((b, h, tq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    s = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, hd), dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and q.requires_grad
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (m, s, acc, k[:, sl], v[:, sl], k_pos[sl])
        m, s, acc = (checkpoint(body, *args, use_reentrant=False) if remat
                     else body(*args))
    out = (acc / torch.clamp(s, min=1e-30)[..., None]).to(q.dtype)
    return out.transpose(1, 2)  # (B, Tq, H, hd)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        pd = cfg.param_dtype
        self.wq = param(init, (d, h, hd), pd)
        self.wk = param(init, (d, kvh, hd), pd)
        self.wv = param(init, (d, kvh, hd), pd)
        self.wo = param(init, (h, hd, d), pd)
        if cfg.qkv_bias:
            self.bq = param(init, (h, hd), pd, zeros=True)
            self.bk = param(init, (kvh, hd), pd, zeros=True)
            self.bv = param(init, (kvh, hd), pd, zeros=True)

    def _project_q(self, x):
        q = torch.einsum("btd,dhk->bthk", x, self.wq.to(x.dtype))
        if self.cfg.qkv_bias:
            q = q + self.bq.to(x.dtype)
        return q

    def _project_kv(self, x, kv=None):
        """k and v of the kv heads ``kv`` (a slice; None: the block's)."""
        wk, wv = self.wk, self.wv
        if kv is not None:
            wk, wv = wk[:, kv], wv[:, kv]
        k = torch.einsum("btd,dhk->bthk", x, wk.to(x.dtype))
        v = torch.einsum("btd,dhk->bthk", x, wv.to(x.dtype))
        if self.cfg.qkv_bias:
            bk, bv = (self.bk, self.bv) if kv is None else (self.bk[kv],
                                                              self.bv[kv])
            k = k + bk.to(x.dtype)
            v = v + bv.to(x.dtype)
        return k, v

    def _heads(self, dev):
        """(first q head of this rank's block or None when whole, the kv
        heads it projects, each local q head's index into them or None)
        under a model split (`tensor.share`)."""
        cfg = self.cfg
        h = self.wq.shape[1]
        first = tensor.share(h, cfg.n_heads, "heads")
        if first is None or tensor.share(self.wk.shape[1], cfg.n_kv_heads,
                                         "kv_heads") is not None:
            return first, None, None
        group = cfg.n_heads // cfg.n_kv_heads
        lo, hi = first // group, (first + h - 1) // group + 1
        idx = torch.arange(first, first + h, device=dev) // group - lo
        return first, slice(lo, hi), idx

    def forward(self, x, *, mode: str = "train", window: int = 0,
                positions=None, cache=None, cache_pos=None, memory=None):
        """Returns (out, new_cache_kv).

        new_cache_kv is None except: "prefill" returns the (k, v) to
        store; "decode" returns the cache, updated in place.
        """
        cfg = self.cfg
        b, t, _ = x.shape
        dev = x.device
        first, kv, heads = self._heads(dev)
        if first is not None:
            x = tensor.to_model(x)
            if memory is not None:
                memory = tensor.to_model(memory)
        q = self._project_q(x)

        def arange(n):
            return torch.arange(n, device=dev)

        if mode == "cross":
            k, v = self._project_kv(memory, kv)
            k_pos = arange(memory.shape[1])
            q_pos = arange(t) if positions is None else positions
        else:
            k, v = self._project_kv(x, kv)
            q_pos = arange(t) if positions is None else positions
            if mode != "encoder":
                sin, cos = rope_freqs(cfg.hd, cfg.rope_theta, q_pos)
                q = apply_rope(q, sin, cos)
                k = apply_rope(k, sin, cos)
            k_pos = q_pos

        new_cache = None
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
        elif mode == "decode":
            if cache is None or cache_pos is None:
                raise ValueError("decode needs a cache and cache_pos")
            at = _position(cache_pos, dev)
            if hints.flag("kv_masked_write"):
                slot = (torch.arange(cache["k"].shape[1], device=dev)
                        == at)[None, :, None, None]
                ck = cache["k"].copy_(torch.where(
                    slot, k.to(cache["k"].dtype), cache["k"]))
                cv = cache["v"].copy_(torch.where(
                    slot, v.to(cache["v"].dtype), cache["v"]))
            else:
                ck = cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
                cv = cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
            new_cache = cache
            k, v = ck, cv
            k_pos = arange(ck.shape[1])
            if positions is None:
                q_pos = at.expand(t)

        kf = _repeat_kv(k, q.shape[2], heads)
        vf = _repeat_kv(v, q.shape[2], heads)

        if mode == "decode":
            # single-token query: a (B, H, 1, S) product, linear in S;
            # unwritten slots are masked out
            keep = (k_pos <= cache_pos)[None, :] & _keep(q_pos, k_pos,
                                                         window)
            out = _sdpa_full(q, kf, vf, _bias(keep))
        elif cfg.attn_impl == "chunked" and mode in ("train", "prefill"):
            out = _sdpa_chunked(q, kf, vf, q_pos, k_pos, window, mode,
                                cfg.attn_chunk)
        else:
            out = _sdpa_full(q, kf, vf, _mask_bias(mode, q_pos, k_pos,
                                                   window))

        o = torch.einsum("bthk,hkd->btd", out, self.wo.to(x.dtype))
        if first is not None:
            o = tensor.from_model(o)
        return o, new_cache
