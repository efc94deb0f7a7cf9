"""Stochastic Lanczos Quadrature for log-determinant (Ubaru-Chen-Saad).

Counterpart of `repro.estimators.slq`.  Per unit probe ``u``, ``m``
Lanczos steps on SPD ``A`` build a tridiagonal ``T (m, m)`` whose Gauss
quadrature rule gives ``u^T log(A) u ~= e_1^T log(T) e_1 = sum_k tau_k^2
log(theta_k)``; the probe-norm-weighted average estimates ``tr(log A)``.

Every Lanczos step is one slab product through the operator backend (K8
for a `StencilOperator`; `torch.matmul` for a dense one, as the JAX
package leaves it to XLA), with full re-orthogonalization against the
stored basis; the final eigendecompositions batch over probes in one
`torch.linalg.eigh` call.  A `BatchedOperator` stack carries a leading
batch axis (probes (B, n, k), estimates (B,)): one batched product a
step, one `eigh` over every matrix and probe.  There is no kernel of
this module's own.
"""
from __future__ import annotations

import torch

from repro_torch.estimators.chebyshev import default_generator
from repro_torch.estimators.hutchinson import (
    TraceEstimate, make_probes, mean_sem,
)
from repro_torch.estimators.operators import operator_on
from repro_torch.estimators.operators.base import device_of
from repro_torch.obs import telemetry as _telemetry

__all__ = ["lanczos", "logdet_slq", "beta_pad"]


def lanczos(mm, v0: torch.Tensor, num_steps: int):
    """Blocked Lanczos with full re-orthogonalization.

    ``mm`` maps (..., n, k) -> (..., n, k); ``v0`` is a slab of k starting
    vectors (normalized here).  Returns ``(alpha, beta)`` of shapes
    (..., k, m) and (..., k, m-1): per-column tridiagonal coefficients.
    On exact breakdown (beta ~ 0) the recurrence continues with a zero
    vector, whose zero block carries no e_1 weight.
    """
    m = num_steps
    q = v0 / torch.linalg.vector_norm(v0, dim=-2, keepdim=True)
    shape = q.shape                                      # (..., n, k)
    cols = (*shape[:-2], shape[-1])
    basis = torch.zeros((m, *shape), dtype=q.dtype, device=q.device)
    alpha = torch.zeros((m, *cols), dtype=q.dtype, device=q.device)
    beta = torch.zeros((m, *cols), dtype=q.dtype, device=q.device)
    eps = torch.finfo(q.dtype).eps
    q_prev = torch.zeros_like(q)
    b_prev = torch.zeros(cols, dtype=q.dtype, device=q.device)
    for j in range(m):
        basis[j] = q
        w = mm(q)
        a_j = (q * w).sum(-2)                            # (..., k)
        w = w - a_j[..., None, :] * q - b_prev[..., None, :] * q_prev
        # full re-orthogonalization against the basis so far (rows > j
        # are zero and project out nothing)
        proj = (basis * w).sum(-2)                       # (m, ..., k)
        w = w - (basis * proj[..., None, :]).sum(0)
        b_j = torch.linalg.vector_norm(w, dim=-2)        # (..., k)
        big = b_j > eps
        safe = torch.where(big, b_j, torch.ones_like(b_j))
        q_next = torch.where(big[..., None, :], w / safe[..., None, :],
                             torch.zeros_like(w))
        alpha[j] = a_j
        beta[j] = b_j
        q_prev, q, b_prev = q, q_next, b_j
    return alpha.movedim(0, -1), beta[:-1].movedim(0, -1)


def beta_pad(beta: torch.Tensor, m: int) -> torch.Tensor:
    """(..., k, m-1) off-diagonals -> (..., k, m) padded for placement."""
    return torch.nn.functional.pad(beta, (0, m - beta.shape[-1]))


def logdet_slq(a, *, num_steps: int = 25, num_probes: int = 32,
               generator: torch.Generator = None, seed: int = 0,
               probes=None, mesh=None, device=None) -> TraceEstimate:
    """Estimate ``log|det(A)|`` of an SPD matrix or operator via SLQ, on
    ``device`` (`operator_on`: ``None`` is the card, ``"cpu"`` the plain
    versions).

    Returns a `TraceEstimate` ((B,) fields for a stack).  ``probes``
    supplies a pre-drawn (..., n, k) slab instead of ``num_probes``
    Rademacher probes from ``generator``
    (default: a fresh one on the operator's device seeded with ``seed``).
    Each sample is weighted by its probe's squared norm, so any isotropic
    probe distribution is weighted correctly.
    """
    op = operator_on(a, device, mesh=mesh)
    n = op.shape[-1]
    m = min(num_steps, n)
    dtype = op.dtype
    dev = device_of(op)
    batch = getattr(op, "batch", None)
    if probes is None:
        if generator is None:
            generator = default_generator(dev, seed)
        v0 = make_probes(generator, n, num_probes, dtype=dtype, device=dev,
                         batch_shape=(batch,) if batch else ())
    else:
        v0 = torch.as_tensor(probes).to(device=dev, dtype=dtype).contiguous()
        if v0.shape[-2] != n:
            raise ValueError(
                f"probes rows {tuple(v0.shape)} do not match operator n={n}")
    alpha, beta = lanczos(op.mm, v0, m)

    # tridiagonal T per probe -> Gauss quadrature nodes/weights, batched eigh
    eye = torch.eye(m, dtype=dtype, device=dev)
    shift = torch.diag(torch.ones(m - 1, dtype=dtype, device=dev), 1)
    diag = alpha[..., None] * eye
    upper = beta_pad(beta, m)[..., None] * shift
    t = diag + upper + upper.transpose(-1, -2)
    theta, u = torch.linalg.eigh(t)
    tau2 = u[..., 0, :] ** 2                             # (..., k, m)
    # zero-block eigenvalues from early breakdown arrive as theta ~ 0 with
    # tau ~ 0; clip so log stays finite before the weight kills the term
    tiny = torch.finfo(dtype).tiny
    quad = (tau2 * torch.log(theta.clamp_min(tiny))).sum(-1)    # (..., k)
    samples = (v0 * v0).sum(-2) * quad
    est, sem = mean_sem(samples)
    if _telemetry.enabled():
        # REPRO_OBS=trace: the sem-vs-probes curve to the host buffer
        _telemetry.emit_curve("slq.sem", _telemetry.running_sem(samples))
    return TraceEstimate(est, sem, samples)
