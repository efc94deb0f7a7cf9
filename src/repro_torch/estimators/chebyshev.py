"""Stochastic Chebyshev expansion for log-determinant (Han-Malioutov-Shin).

Counterpart of `repro.estimators.chebyshev`.  For SPD ``A`` with spectrum
inside ``[lmin, lmax]``:

    logdet(A) = tr(log A) ~= sum_{j=0}^{deg} c_j tr(T_j(B)),
    B = (2A - (lmax + lmin) I) / (lmax - lmin)           (spectrum in [-1, 1])

with ``c_j`` the Chebyshev coefficients of ``log`` mapped to [-1, 1] and
each trace estimated with Hutchinson probes through the three-term
recurrence ``w_0 = v, w_1 = B v, w_{j+1} = 2 B w_j - w_{j-1}``: O(deg *
num_probes) matvecs, no factorization.

A dense operator runs the recurrence through the fused step (K6 on the
card, `repro_torch.kernels.ops.fused_cheb_step`): one pass over A per
degree.  ``center``, ``width`` and the coefficients stay device tensors,
so the degree loop never waits on the host.  A `BatchedOperator` stack
carries a leading batch axis through everything: probes (B, n, k), bounds
and estimates (B,), coefficients (B, degree + 1).
"""
from __future__ import annotations

import math

import torch

from repro_torch.estimators.hutchinson import (
    TraceEstimate, make_probes, mean_sem,
)
from repro_torch.estimators.operators import DenseOperator, operator_on
from repro_torch.estimators.operators.base import device_of, resolve_device
from repro_torch.kernels import ops as _kops
from repro_torch.obs import telemetry as _telemetry

__all__ = ["spectral_bounds", "chebyshev_coeffs_log", "logdet_chebyshev",
           "default_generator"]


def default_generator(device, seed: int) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def spectral_bounds(op, generator: torch.Generator, *, iters: int = 32,
                    safety: float = 1.05):
    """(lmin, lmax) bracket for an SPD operator, by matvecs alone, as 0-d
    tensors on the operator's device.

    Power iteration from a Gaussian start vector (drawn from
    ``generator``) gives ``lmax``; a second power iteration on the shifted
    operator ``lmax I - A`` gives ``lmin``.  ``safety`` widens the bracket.
    Costs ``2 (iters + 1)`` single-column products; a stack's bounds are
    (B,), one per matrix.
    """
    n = op.shape[-1]
    batch = getattr(op, "batch", None)
    shape = (batch, n, 1) if batch else (n, 1)
    v0 = torch.randn(shape, generator=generator, device=generator.device,
                     dtype=op.dtype).to(device_of(op))

    def power(mv_fn):
        v = v0
        for _ in range(iters):
            w = mv_fn(v)
            v = w / torch.linalg.vector_norm(w, dim=-2, keepdim=True)
        w = mv_fn(v)
        return (v * w).sum((-2, -1)) / (v * v).sum((-2, -1))

    lmax = power(op.mm) * safety
    lmax_b = lmax[..., None, None]
    shifted = power(lambda v: lmax_b * v - op.mm(v))
    lmin = (lmax - shifted) / safety
    return torch.maximum(lmin, lmax * 1e-12), lmax


def chebyshev_coeffs_log(lmin, lmax, degree: int, dtype, device=None):
    """(degree+1,) Chebyshev coefficients of log(x) mapped to [-1, 1].

    Chebyshev-Gauss quadrature at the deg+1 nodes x_q = cos(theta_q):
    ``c_j = 2/(deg+1) * sum_q log(x(x_q)) cos(j theta_q)`` (halved for
    j=0), with no host read of the bounds, on ``device``: by default that
    of ``lmin`` when it is a tensor, else the card (`resolve_device`).
    """
    if device is None and torch.is_tensor(lmin):
        device = lmin.device
    else:
        device = resolve_device(device)
    q = degree + 1
    theta = (torch.arange(q, dtype=dtype, device=device) + 0.5) * (math.pi / q)
    xq = torch.cos(theta)                                      # (q,)
    lmin = torch.as_tensor(lmin, dtype=dtype, device=device)[..., None]
    lmax = torch.as_tensor(lmax, dtype=dtype, device=device)[..., None]
    g = torch.log(0.5 * (lmax - lmin) * xq + 0.5 * (lmax + lmin))   # (q,)
    tjk = torch.cos(torch.arange(q, dtype=dtype, device=device)[:, None]
                    * theta)                                   # (j, q)
    c = (2.0 / q) * torch.einsum("jq,...q->...j", tjk, g)
    c[..., 0] *= 0.5
    return c


def logdet_chebyshev(a, *, degree: int = 64, num_probes: int = 32,
                     generator: torch.Generator = None, seed: int = 0,
                     lmin=None, lmax=None, probe_kind: str = "rademacher",
                     probes=None, mesh=None, device=None) -> TraceEstimate:
    """Estimate ``log|det(A)|`` of an SPD matrix or operator on ``device``
    (`operator_on`: ``None`` is the card, ``"cpu"`` the plain versions).

    Returns a `TraceEstimate`: ``est`` the estimate, ``sem`` its
    Monte-Carlo standard error (which does not include the truncation
    bias of the degree).  Randomness comes from ``generator`` (default: a
    fresh one on the operator's device seeded with ``seed``): first the
    probe slab, unless ``probes`` supplies one, then the start vector of
    `spectral_bounds`, unless ``lmin`` and ``lmax`` are both given.
    """
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    op = operator_on(a, device, mesh=mesh)
    n = op.shape[-1]
    dtype = op.dtype
    dev = device_of(op)
    batch = getattr(op, "batch", None)
    if generator is None:
        generator = default_generator(dev, seed)

    if probes is None:
        v = make_probes(generator, n, num_probes, kind=probe_kind,
                        dtype=dtype, device=dev,
                        batch_shape=(batch,) if batch else ())
    else:
        v = torch.as_tensor(probes).to(device=dev, dtype=dtype).contiguous()
        if v.shape[-2] != n:
            raise ValueError(
                f"probes rows {tuple(v.shape)} do not match operator n={n}")
    if lmin is None or lmax is None:
        lo, hi = spectral_bounds(op, generator)
        lmin = lo if lmin is None else lmin
        lmax = hi if lmax is None else lmax
    lmin = torch.as_tensor(lmin, dtype=dtype, device=dev)
    lmax = torch.as_tensor(lmax, dtype=dtype, device=dev)
    if batch:                          # one bracket per matrix
        lmin, lmax = lmin.expand(batch), lmax.expand(batch)
    c = chebyshev_coeffs_log(lmin, lmax, degree, dtype, dev)   # (..., deg+1)

    center = (lmax + lmin)[..., None, None]
    width = (lmax - lmin)[..., None, None]

    def mv_b(v):                       # spectrum-normalized operator B
        return (2.0 * op.mm(v) - center * v) / width

    w_prev, w = v, mv_b(v)
    samples = (c[..., 0, None] * (v * v).sum(-2)
               + c[..., 1, None] * (v * w).sum(-2))              # (..., k)
    if isinstance(op, DenseOperator):
        # shifted matvec, axpy and probe dot in one pass over A (K6)
        a_mat = op.a.contiguous()
        for j in range(2, degree + 1):
            w_next, dots = _kops.fused_cheb_step(a_mat, w, w_prev, v,
                                                 center, width)
            samples = samples + c[..., j, None] * dots
            w_prev, w = w, w_next
    else:
        for j in range(2, degree + 1):
            w_next = 2.0 * mv_b(w) - w_prev
            samples = samples + c[..., j, None] * (v * w_next).sum(-2)
            w_prev, w = w, w_next
    est, sem = mean_sem(samples)
    if _telemetry.enabled():
        # REPRO_OBS=trace: the sem-vs-probes curve to the host buffer
        _telemetry.emit_curve("chebyshev.sem", _telemetry.running_sem(samples))
    return TraceEstimate(est, sem, samples)
