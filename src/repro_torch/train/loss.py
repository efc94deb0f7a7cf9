"""Losses -- counterpart of `repro.train.loss`: token cross-entropy and
the place where the training framework meets the paper's technique, an
optional log-determinant decorrelation auxiliary on a hidden-state
covariance, computed with the condensation core.

The logdet-reg term maximizes ``logdet(Cov(h) + eps I) - tr(Cov(h))``
(a soft-whitening objective); ``TrainConfig.logdet_reg > 0`` adds it to
every arch's loss.  Its logdet is serial rank-1 condensation
(`repro_torch.core.condense.slogdet_condense`, K1 launched d - 1 times
on the card), wrapped in the exact VJP
(`repro_torch.estimators.grad.exact_slogdet_vjp`): the condensation's
in-place steps carry no autograd graph, and the backward is one
``inv_ex``.  The JAX package differentiates through the condensation's
ops instead; the pivot argmax has a zero gradient there, so both compute
``g * inv(A)^T`` and differ in rounding only.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.condense import slogdet_condense
from repro_torch.estimators.grad import exact_slogdet_vjp

__all__ = ["cross_entropy", "chunked_cross_entropy", "logdet_decorrelation"]

_slogdet = exact_slogdet_vjp(slogdet_condense)


def _ce_terms(logits, targets, z_loss: float, reduce):
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, targets[..., None].long(),
                              dim=-1)[..., 0]
    out = reduce(lse - ll)
    if z_loss:
        out = out + z_loss * reduce(lse ** 2)
    return out


def cross_entropy(logits, targets, *, z_loss: float = 1e-4):
    """Mean token NLL (+ z-loss for logit drift control), in f32."""
    return _ce_terms(logits.to(torch.float32), targets, z_loss, torch.mean)


def _chunk_loss(h, y, table, softcap: float, z_loss: float):
    logits = torch.einsum("btd,vd->btv", h.to(torch.float32), table)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return _ce_terms(logits, y, z_loss, torch.sum)


def chunked_cross_entropy(hidden, embed_or_head, targets, *,
                          softcap: float = 0.0, z_loss: float = 1e-4,
                          chunk: int = 512):
    """CE computed sequence-chunk-wise, so that the (B, T, V) f32 logits
    never materialize: each chunk runs under ``torch.utils.checkpoint``
    (the JAX ``jax.checkpoint``), so its (B, chunk, V) logits are
    recomputed in the backward and never held for all chunks.  The
    chunks are a Python loop (JAX: ``lax.scan``; its ``unroll`` has no
    counterpart here), then the remainder chunk."""
    b, t, _ = hidden.shape
    chunk = min(chunk, t)
    n_chunks = t // chunk
    rem = t - n_chunks * chunk
    table = embed_or_head.to(torch.float32)

    def one(h, y):
        if torch.is_grad_enabled():
            return checkpoint(_chunk_loss, h, y, table, softcap, z_loss,
                              use_reentrant=False)
        return _chunk_loss(h, y, table, softcap, z_loss)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        cut = slice(i * chunk, (i + 1) * chunk)
        total = total + one(hidden[:, cut], targets[:, cut])
    if rem:
        total = total + one(hidden[:, -rem:], targets[:, -rem:])
    return total / (b * t)


def logdet_decorrelation(h, *, eps: float = 1e-3):
    """``tr(Cov)/d - logdet(Cov + eps I)/d`` on features ``h`` (..., d),
    the covariance over all leading axes, in f32.  The logdet goes
    through ``exact_slogdet_vjp(slogdet_condense)``: K1 d - 1 times on
    the card, one ``inv_ex`` in the backward."""
    d = h.shape[-1]
    flat = h.reshape(-1, d).to(torch.float32)
    mu = flat.mean(dim=0)
    xc = flat - mu
    cov = xc.T @ xc / flat.shape[0] + eps * torch.eye(
        d, dtype=torch.float32, device=h.device)
    _, ld = _slogdet(cov)
    return torch.trace(cov) / d - ld / d
