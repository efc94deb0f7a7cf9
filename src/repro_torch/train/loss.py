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

Inside a data split (`repro_torch.sharding.split`) each rank holds a
share of the batch: the cross-entropy divides by the global token count,
and the aux's mean and covariance are over all ranks' rows, so every
rank runs the same condensation on the same covariance.  Inside a model
split (`repro_torch.sharding.tensor`) a vocab-parallel unembedding gives
each rank its logits columns: the cross-entropy takes the global
log-sum-exp from every rank's maximum and sum of exponentials, and the
target logit from the rank that holds it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.condense import slogdet_condense
from repro_torch.estimators.grad import exact_slogdet_vjp
from repro_torch.sharding import split, tensor

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


def _chunk_loss_split(h, y, table, softcap: float, z_loss: float,
                      first: int):
    """`_chunk_loss` on this rank's vocab rows ``[first, first + len)`` of
    ``table``: one exchange over the model line (`tensor.each`) of every
    rank's logits maximum, sum of exponentials below it and target logit
    (zero where another rank holds the target).  The global log-sum-exp
    is ``max + log(sum of each rank's sum x exp(its max - max))`` and the
    target logit the sum of the ranks' (in rank order: the same bits on
    every rank); this rank's own terms enter it as ``x - x.detach()``
    (zero forward), so the backward reaches its logits alone: ``exp(l -
    lse)``, and one at its targets."""
    logits = torch.einsum("btd,vd->btv", tensor.to_model(
        h.to(torch.float32)), table)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    mx = logits.detach().amax(dim=-1)
    s = torch.exp(logits - mx[..., None]).sum(dim=-1)
    at = y.long() - first
    mine = (at >= 0) & (at < table.shape[0])
    ll = torch.take_along_dim(logits, torch.where(mine, at, 0)[..., None],
                              dim=-1)[..., 0]
    ll = torch.where(mine, ll, torch.zeros_like(ll))
    stack = tensor.each(torch.stack([mx, s, ll]))
    top = stack[:, 0].amax(dim=0)
    own = s * torch.exp(mx - top)
    total = split.ordered_sum(stack[:, 1] * torch.exp(stack[:, 0] - top))
    lse = top + torch.log(total + (own - own.detach()))
    ll = split.ordered_sum(stack[:, 2]) + (ll - ll.detach())
    out = torch.sum(lse - ll)
    if z_loss:
        out = out + z_loss * torch.sum(lse ** 2)
    return out


def chunked_cross_entropy(hidden, embed_or_head, targets, *,
                          softcap: float = 0.0, z_loss: float = 1e-4,
                          chunk: int = 512, vocab: Optional[int] = None):
    """CE computed sequence-chunk-wise, so that the (B, T, V) f32 logits
    never materialize: each chunk runs under ``torch.utils.checkpoint``
    (the JAX ``jax.checkpoint``), so its (B, chunk, V) logits are
    recomputed in the backward and never held for all chunks.  The
    chunks are a Python loop (JAX: ``lax.scan``; its ``unroll`` has no
    counterpart here), then the remainder chunk.  In a data split the sum
    is divided by the global token count: this rank's share of the global
    mean.  In a model split a table of fewer rows than ``vocab`` is this
    rank's block (`_chunk_loss_split`; a chunk's exchange runs again in
    its recomputation, in the same order on every rank)."""
    b, t, _ = hidden.shape
    chunk = min(chunk, t)
    n_chunks = t // chunk
    rem = t - n_chunks * chunk
    table = embed_or_head.to(torch.float32)
    first = (None if vocab is None
             else tensor.share(table.shape[0], vocab, "vocab"))
    fn, extra = ((_chunk_loss, ()) if first is None
                 else (_chunk_loss_split, (first,)))

    def one(h, y):
        if torch.is_grad_enabled():
            return checkpoint(fn, h, y, table, softcap, z_loss, *extra,
                              use_reentrant=False)
        return fn(h, y, table, softcap, z_loss, *extra)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        cut = slice(i * chunk, (i + 1) * chunk)
        total = total + one(hidden[:, cut], targets[:, cut])
    if rem:
        total = total + one(hidden[:, -rem:], targets[:, -rem:])
    return total / (split.rows(b) * t)


def logdet_decorrelation(h, *, eps: float = 1e-3):
    """``tr(Cov)/d - logdet(Cov + eps I)/d`` on features ``h`` (..., d),
    the covariance over all leading axes, in f32.  The logdet goes
    through ``exact_slogdet_vjp(slogdet_condense)``: K1 d - 1 times on
    the card, one ``inv_ex`` in the backward.  In a data split the mean
    and the covariance are the global batch's (`split.total`); the mean
    is taken as a constant there, as its exact gradient through the
    centred covariance is zero (the centred rows sum to zero)."""
    d = h.shape[-1]
    flat = h.reshape(-1, d).to(torch.float32)
    eye = eps * torch.eye(d, dtype=torch.float32, device=h.device)
    if split.current() is None:
        mu = flat.mean(dim=0)
        xc = flat - mu
        cov = xc.T @ xc / flat.shape[0] + eye
    else:
        n = split.rows(flat.shape[0])
        xc = flat - split.whole(flat.detach().sum(dim=0)) / n
        cov = split.total(xc.T @ xc) / n + eye
    _, ld = _slogdet(cov)
    return torch.trace(cov) / d - ld / d
