"""Model assembly -- counterpart of `repro.models.model`: stacks blocks per
architecture family, with KV/SSM caches and the entry points

    init_model(cfg, generator=, device=)        -> Model (an nn.Module)
    forward(model, batch)                       -> (logits, aux)     [train]
    prefill(model, batch, max_len)              -> (logits, caches)
    decode_step(model, tokens, caches, pos)     -> (logits, caches)

(on a grid of ranks: `repro_torch.sharding.serving`'s ``mesh_prefill``
and ``mesh_decode`` run these on each rank's share)
    cache_specs(cfg, batch_size, max_len)       -> meta-tensor pytree

Families: dense | moe | ssm | encdec | vlm | hybrid.  Heterogeneous stacks
(gemma3 local:global, llama4 dense/moe interleave, vision cross-attn every
5th, zamba2 shared-attn every 6th) keep the JAX package's super-blocks:
one ``nn.ModuleList`` per stacked leading axis of the JAX parameters (two
levels for llama4's dense blocks, vision's self blocks and zamba2's SSM
blocks), so `repro_torch.models.convert` maps one tree onto the other.
Caches keep the JAX layout too: stacked tensors, nested as the JAX caches
are, so `cache_specs` compares shape for shape with the JAX one.  A decode
step writes into the caches it is given and returns them.

``cfg.remat`` in train mode recomputes each block (and each super-block)
in the backward: `torch.utils.checkpoint` where the JAX package applies
``jax.checkpoint``.

batch dict keys: "tokens" (B, T) int -- always.  Family extras:
  encdec: "frames"     (B, enc_seq, d_model)  precomputed audio embeddings (stub)
  vlm:    "img_embeds" (B, n_img_tokens, d_model) precomputed patch embeds (stub)
  any:    "memory"     precomputed encoder output (decode loops pass this to
                       avoid re-encoding every step)
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.estimators.operators.base import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.attention import _position
from repro_torch.models.common import (
    ModelConfig, ParamInit, embed_lookup, normal_init, param, rmsnorm,
    unembed,
)
from repro_torch.models.ssm import ssm_cache_spec
from repro_torch.sharding import serving

__all__ = ["Model", "init_model", "forward", "forward_hidden", "prefill",
           "decode_step", "cache_specs", "layer_windows", "model_flops",
           "count_params"]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding window (0 = full attention)."""
    n = cfg.n_layers
    if not cfg.sliding_window or not cfg.global_every:
        return np.zeros((n,), np.int32)
    w = np.full((n,), cfg.sliding_window, np.int32)
    w[cfg.global_every - 1::cfg.global_every] = 0   # every k-th layer global
    return w


def _call(cfg, mode, fn, /, *args, **kw):
    """``fn(*args, **kw)``, recomputed in the backward when ``cfg.remat``
    applies (train mode, gradients on)."""
    if cfg.remat and mode == "train" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return fn(*args, **kw)


def _index(tree, i):
    """Layer ``i`` of a stacked cache tree (views)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, i) for v in tree)
    return tree[i]


def _stack(trees):
    """Stack per-layer cache trees along a new leading axis."""
    first = trees[0] if trees else None
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[j] for t in trees]) for j in range(len(first)))
    return torch.stack(trees)


def _pad_kv(nc, pad_to):
    """Pad a block-level {"k","v"} (B, T, kvh, hd) cache along time; served
    on a grid, this rank's block of it (`sharding.serving.kv_block`)."""
    if nc is None or pad_to is None:
        return nc

    def pad(x):
        t = x.shape[1]
        if t >= pad_to:
            return x[:, :pad_to]
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad_to - t))
    return {k: serving.kv_block(pad(v)) for k, v in nc.items()}


def _sum_aux(auxs):
    if not auxs or not auxs[0]:
        return {}
    return {k: torch.stack([a[k] for a in auxs]).sum() for k in auxs[0]}


def _family_plan(cfg: ModelConfig):
    """Returns (plan_name, counts) describing the stacked structure."""
    fam = cfg.family
    if fam == "dense":
        return "uniform_dense", {"n": cfg.n_layers}
    if fam == "moe":
        if cfg.moe_every <= 1:
            return "uniform_moe", {"n": cfg.n_layers}
        if cfg.n_layers % cfg.moe_every:
            raise ValueError("n_layers must be a multiple of moe_every")
        return "pair_moe", {"n": cfg.n_layers // cfg.moe_every,
                            "dense_per": cfg.moe_every - 1}
    if fam == "ssm":
        return "uniform_ssm", {"n": cfg.n_layers}
    if fam == "encdec":
        return "encdec", {"n_enc": cfg.n_enc_layers, "n_dec": cfg.n_layers}
    if fam == "vlm":
        per = cfg.cross_attn_every
        if per <= 1 or cfg.n_layers % per:
            raise ValueError("vlm needs cross_attn_every > 1 dividing "
                             "n_layers")
        return "vlm", {"n": cfg.n_layers // per, "self_per": per - 1}
    if fam == "hybrid":
        per = cfg.shared_attn_every
        n_super = cfg.n_layers // per
        extra = cfg.n_layers - n_super * per
        return "hybrid", {"n": n_super, "per": per, "extra": extra}
    raise ValueError(f"unknown family {fam}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _blocks(cls, cfg, init, n):
    return nn.ModuleList(cls(cfg, init) for _ in range(n))


def _nested(cls, cfg, init, n, per):
    return nn.ModuleList(_blocks(cls, cfg, init, per) for _ in range(n))


class Model(nn.Module):
    """All parameters of one config, named as the JAX package's tree
    (a stacked leading axis there is a ``ModuleList`` index here)."""

    def __init__(self, cfg: ModelConfig, init: ParamInit):
        super().__init__()
        self.cfg = cfg
        plan, c = _family_plan(cfg)
        self.plan = plan
        pd = cfg.param_dtype
        self.embed = param(init, (cfg.vocab, cfg.d_model), pd, scale=0.02)
        if plan == "uniform_dense":
            self.blocks = _blocks(B.DenseBlock, cfg, init, c["n"])
        elif plan == "uniform_moe":
            self.blocks = _blocks(B.MoEBlock, cfg, init, c["n"])
        elif plan == "pair_moe":
            self.dense_blocks = _nested(B.DenseBlock, cfg, init, c["n"],
                                        c["dense_per"])
            self.moe_blocks = _blocks(B.MoEBlock, cfg, init, c["n"])
        elif plan == "uniform_ssm":
            self.blocks = _blocks(B.SSMBlock, cfg, init, c["n"])
        elif plan == "encdec":
            self.enc_blocks = _blocks(B.EncoderBlock, cfg, init, c["n_enc"])
            self.enc_norm = param(init, (cfg.d_model,), pd)
            self.dec_blocks = _blocks(B.XDecBlock, cfg, init, c["n_dec"])
        elif plan == "vlm":
            self.self_blocks = _nested(B.DenseBlock, cfg, init, c["n"],
                                       c["self_per"])
            self.cross_blocks = _blocks(B.CrossBlock, cfg, init, c["n"])
        elif plan == "hybrid":
            self.ssm_blocks = _nested(B.SSMBlock, cfg, init, c["n"],
                                      c["per"])
            self.shared_attn = B.DenseBlock(cfg, init)     # ONE copy
            if c["extra"]:
                self.extra_ssm = _blocks(B.SSMBlock, cfg, init, c["extra"])
        self.final_norm = param(init, (cfg.d_model,), pd)
        if not cfg.tie_embeddings:
            self.head = param(init, (cfg.vocab, cfg.d_model), pd)

    def unembedding(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.head


def init_model(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
               device=None) -> Model:
    """A model with the JAX package's init rule (`common.param`), drawn
    from ``generator`` (default: seed 0 on the target device), on the card
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return Model(cfg, normal_init(generator, dev))


# ---------------------------------------------------------------------------
# the stack runner (shared by train / prefill / decode)
# ---------------------------------------------------------------------------

def _run_stack(model: Model, x, *, mode, caches=None, cache_pos=None,
               positions=None, memory=None, pad_to=None):
    """Run all blocks.  Returns (x, new_caches, aux_sum): new_caches is
    None in train mode, the given caches (written in place) in decode
    mode, and the stacked prefill caches (padded to ``pad_to``)."""
    cfg = model.cfg
    _, c = _family_plan(cfg)
    plan = model.plan
    decode = caches is not None
    kv = dict(positions=positions, cache_pos=cache_pos)

    at = _index

    def finish(new):
        if mode == "train":
            return None
        return caches if decode else _stack(new)

    if plan in ("uniform_dense", "uniform_moe"):
        windows = layer_windows(cfg)
        new, auxs = [], []
        for i, blk in enumerate(model.blocks):
            x, nc, aux = _call(cfg, mode, blk, x, mode=mode,
                               window=int(windows[i]), cache=at(caches, i),
                               **kv)
            new.append(_pad_kv(nc, pad_to))
            auxs.append(aux)
        return x, finish(new), _sum_aux(auxs)

    if plan == "pair_moe":
        def inner(x_, dense, moe, dcaches, mcache):
            new_d = []
            for j, blk in enumerate(dense):
                x_, nc, _ = _call(cfg, mode, blk, x_, mode=mode, window=0,
                                  cache=at(dcaches, j), **kv)
                new_d.append(_pad_kv(nc, pad_to))
            x_, nc_m, aux = _call(cfg, mode, moe, x_, mode=mode, window=0,
                                  cache=mcache, **kv)
            return x_, (new_d, _pad_kv(nc_m, pad_to)), aux

        new, auxs = [], []
        for i in range(c["n"]):
            dc, mc = at(caches, i) if decode else (None, None)
            x, (new_d, nc_m), aux = _call(
                cfg, mode, inner, x, model.dense_blocks[i],
                model.moe_blocks[i], dc, mc)
            new.append((None if mode == "train" else _stack(new_d), nc_m))
            auxs.append(aux)
        return x, finish(new), _sum_aux(auxs)

    if plan == "uniform_ssm":
        new = []
        for i, blk in enumerate(model.blocks):
            x, nc, _ = _call(cfg, mode, blk, x, mode=mode,
                             cache=at(caches, i))
            new.append(nc)
        return x, finish(new), {}

    if plan == "encdec":
        new = []
        for i, blk in enumerate(model.dec_blocks):
            x, nc, _ = _call(cfg, mode, blk, x, memory=memory, mode=mode,
                             cache=at(caches, i), **kv)
            new.append(_pad_kv(nc, pad_to))
        return x, finish(new), {}

    if plan == "vlm":
        def inner(x_, selfs, cross, scaches):
            new_s = []
            for j, blk in enumerate(selfs):
                x_, nc, _ = _call(cfg, mode, blk, x_, mode=mode, window=0,
                                  cache=at(scaches, j), **kv)
                new_s.append(_pad_kv(nc, pad_to))
            x_, _, _ = _call(cfg, mode, cross, x_, memory=memory)
            return x_, new_s

        new = []
        for i in range(c["n"]):
            x, new_s = _call(cfg, mode, inner, x, model.self_blocks[i],
                             model.cross_blocks[i], at(caches, i))
            new.append(None if mode == "train" else _stack(new_s))
        return x, finish(new), {}

    if plan == "hybrid":
        def inner(x_, ssms, scaches, acache):
            new_s = []
            for j, blk in enumerate(ssms):
                x_, nc, _ = _call(cfg, mode, blk, x_, mode=mode,
                                  cache=at(scaches, j))
                new_s.append(nc)
            x_, nca, _ = _call(cfg, mode, model.shared_attn, x_, mode=mode,
                               window=0, cache=acache, **kv)
            return x_, new_s, _pad_kv(nca, pad_to)

        new = []
        for i in range(c["n"]):
            sc, ac = at(caches["super"], i) if decode else (None, None)
            x, new_s, nca = _call(cfg, mode, inner, x, model.ssm_blocks[i],
                                  sc, ac)
            new.append((None if mode == "train" else _stack(new_s), nca))
        new_extra = []
        for i, blk in enumerate(getattr(model, "extra_ssm", ())):
            x, nc, _ = blk(x, mode=mode,
                           cache=at(caches["extra"], i) if decode else None)
            new_extra.append(nc)
        if mode == "train" or decode:
            return x, finish(None), {}
        return x, {"super": _stack(new),
                   "extra": _stack(new_extra) if new_extra else None}, {}

    raise AssertionError(plan)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _encode(model: Model, batch):
    """Encoder side (whisper): frames (B, S, d) -> memory (B, S, d)."""
    cfg = model.cfg
    x = batch["frames"].to(cfg.dtype)
    dev = x.device
    pos = torch.arange(x.shape[1], device=dev)
    half = cfg.d_model // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=dev)
                     * math.log(10000.0) / half)
    ang = pos[:, None].float() * freq[None, :]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(cfg.dtype)
    x = x + pe[None]
    for blk in model.enc_blocks:
        x = blk(x)
    return rmsnorm(model.enc_norm, x, cfg.norm_eps)


def _memory_for(model: Model, batch):
    cfg = model.cfg
    if "memory" in batch:
        return batch["memory"].to(cfg.dtype)
    if cfg.family == "encdec":
        return _encode(model, batch)
    if cfg.family == "vlm":
        return batch["img_embeds"].to(cfg.dtype)
    return None


def forward_hidden(model: Model, batch):
    """Backbone only: final-norm hidden states (B, T, d) + aux.  The caller
    owns the unembedding."""
    cfg = model.cfg
    x = embed_lookup(model.embed, batch["tokens"], cfg.dtype, cfg.vocab)
    memory = _memory_for(model, batch)
    x, _, aux = _run_stack(model, x, mode="train", memory=memory)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return x, aux


def forward(model: Model, batch):
    """Training/teacher-forcing forward: logits (B, T, vocab) f32 + aux."""
    x, aux = forward_hidden(model, batch)
    logits = unembed(model.unembedding(), x, softcap=model.cfg.logits_softcap,
                     vocab=model.cfg.vocab)
    return logits, aux


def prefill(model: Model, batch, max_len: int):
    """Prompt processing; returns (last-token logits, caches @ max_len)."""
    cfg = model.cfg
    tokens = batch["tokens"]
    t = tokens.shape[1]
    x = embed_lookup(model.embed, tokens, cfg.dtype, cfg.vocab)
    memory = _memory_for(model, batch)
    x, caches, _ = _run_stack(model, x, mode="prefill",
                              positions=torch.arange(t, device=x.device),
                              memory=memory, pad_to=max_len)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = unembed(model.unembedding(), x[:, -1:],
                     softcap=cfg.logits_softcap, vocab=cfg.vocab)
    return logits, caches


def decode_step(model: Model, tokens, caches, pos, batch_extras=None):
    """One decoding step.  tokens (B, 1); ``pos`` (an int or a 0-d tensor)
    is the index into the caches, which are written in place and
    returned."""
    cfg = model.cfg
    x = embed_lookup(model.embed, tokens, cfg.dtype, cfg.vocab)
    memory = None
    if batch_extras is not None:
        memory = _memory_for(model, batch_extras)
    positions = _position(pos, x.device)
    x, new_caches, _ = _run_stack(model, x, mode="decode", caches=caches,
                                  cache_pos=pos, positions=positions,
                                  memory=memory)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = unembed(model.unembedding(), x, softcap=cfg.logits_softcap,
                     vocab=cfg.vocab)
    return logits, new_caches


# ---------------------------------------------------------------------------
# cache specs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------

def _attn_cache_spec(cfg, batch, max_len, dtype):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


def _spec_stack(spec, n):
    if isinstance(spec, dict):
        return {k: _spec_stack(v, n) for k, v in spec.items()}
    return torch.empty((n,) + tuple(spec.shape), dtype=spec.dtype,
                       device="meta")


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    plan, c = _family_plan(cfg)
    dt = cfg.dtype
    attn = (_attn_cache_spec(cfg, batch, max_len, dt)
            if cfg.n_heads else None)
    ssm = ssm_cache_spec(cfg, batch, dt) if cfg.ssm_state else None
    st = _spec_stack

    if plan in ("uniform_dense", "uniform_moe"):
        return st(attn, c["n"])
    if plan == "pair_moe":
        return (st(st(attn, c["dense_per"]), c["n"]), st(attn, c["n"]))
    if plan == "uniform_ssm":
        return st(ssm, c["n"])
    if plan == "encdec":
        return st(attn, c["n_dec"])
    if plan == "vlm":
        return st(st(attn, c["self_per"]), c["n"])
    if plan == "hybrid":
        return {"super": (st(st(ssm, c["per"]), c["n"]), st(attn, c["n"])),
                "extra": st(ssm, c["extra"]) if c["extra"] else None}
    raise AssertionError(plan)


# ---------------------------------------------------------------------------
# analytic params/FLOPs (6 N_active D)
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig, *, active_only: bool = False) -> int:
    """Approximate parameter count from the config (embeddings included)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.hd if h else 0
    attn = d * h * hd + 2 * d * kvh * hd + h * hd * d
    mlp = 3 * d * f
    fe = cfg.d_ff_expert or f
    moe_total = (cfg.n_experts + cfg.n_shared_experts) * 3 * d * fe \
        + d * cfg.n_experts
    moe_active = ((cfg.top_k + cfg.n_shared_experts) * 3 * d * fe
                  + d * cfg.n_experts)
    moe_used = moe_active if active_only else moe_total

    d_in = cfg.d_inner
    g, st, nh = cfg.ssm_groups, cfg.ssm_state, cfg.nh_ssm
    ssm = (d * (2 * d_in + 2 * g * st + nh)
           + cfg.ssm_conv * (d_in + 2 * g * st) + d_in * d + d_in + 3 * nh)

    plan, c = _family_plan(cfg)
    if plan == "uniform_dense":
        core = cfg.n_layers * (attn + mlp)
    elif plan == "uniform_moe":
        core = cfg.n_layers * (attn + moe_used)
    elif plan == "pair_moe":
        core = c["n"] * (c["dense_per"] * (attn + mlp) + attn + moe_used)
    elif plan == "uniform_ssm":
        core = cfg.n_layers * ssm
    elif plan == "encdec":
        core = cfg.n_enc_layers * (attn + mlp) + cfg.n_layers * (2 * attn + mlp)
    elif plan == "vlm":
        core = c["n"] * (c["self_per"] * (attn + mlp) + attn + mlp)
    elif plan == "hybrid":
        core = cfg.n_layers * ssm + (attn + mlp)  # shared block counted once
    else:
        raise AssertionError(plan)
    return int(core + v * d * (1 if cfg.tie_embeddings else 2))


def model_flops(cfg: ModelConfig, n_tokens: int) -> int:
    """6 * N_active * D."""
    return 6 * count_params(cfg, active_only=True) * n_tokens
