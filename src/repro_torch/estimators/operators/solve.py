"""Matrix-free conjugate gradient on the `LinearOperator` protocol.

Counterpart of `repro.estimators.operators.solve`.  Solves ``A X = B``
for SPD ``A`` touching the operator only through ``mm``: one slab product
per iteration, batched over the columns of ``B (n, k)`` -- and over the
matrices of a `BatchedOperator` stack, ``B (B, n, k)``, each column of
each matrix with its own step length.  Jacobi preconditioning from
``op.diag()`` divides out diagonal disparity.

All columns iterate in lockstep: the loop stops when EVERY column's
residual passes ``||r|| <= tol * ||b|| + atol``, or at ``maxiter``;
converged columns take guarded no-op steps.  A dense operator, when not
transposed, takes the fused matvec-and-axpy kernel (K7 on the card,
`repro_torch.kernels.ops.fused_cg_step`); every other operator runs the
same chain inline.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.estimators.operators import DenseOperator, operator_on
from repro_torch.estimators.operators.base import device_of
from repro_torch.kernels import ops as _kops
from repro_torch.obs import telemetry as _telemetry

__all__ = ["CGResult", "cg_solve"]


class CGResult(NamedTuple):
    """Solution with convergence evidence."""
    x: torch.Tensor           # (..., n, k) solution slab (or (..., n))
    iters: int                # iterations taken
    resnorm: torch.Tensor     # (..., k) final residual 2-norms per column
    converged: torch.Tensor   # () all columns under tolerance?


def _safe_div(num, den):
    """num / den with 0/0 -> 0 (converged columns have vanishing den)."""
    tiny = torch.finfo(den.dtype).tiny
    big = den.abs() > tiny
    safe = torch.where(big, den, torch.ones_like(den))
    return torch.where(big, num / safe, torch.zeros_like(num))


def cg_solve(a, b, *, tol: float = 1e-10, atol: float = 0.0,
             maxiter: Optional[int] = None, precondition: bool = True,
             x0=None, transpose: bool = False, device=None) -> CGResult:
    """Preconditioned conjugate gradient: solve SPD ``a @ x = b``.

    ``a`` is anything `as_operator` accepts: an (n, n) tensor or array, a
    (B, n, n) stack, or any `LinearOperator`; ``b`` is a slab (n, k) or a
    vector (n,), with a leading (B,) for a stack.  All of
    them are moved to ``device`` (`operator_on`): ``None`` is the card,
    and raises when there is none; ``"cpu"`` runs the plain versions.
    ``precondition`` uses Jacobi scaling from ``op.diag()`` when the
    backend provides it.  ``transpose=True`` solves
    ``a^T x = b`` through the operator's ``rmm``.  Zero right-hand-side
    columns are solved by ``x = 0`` up front, overriding ``x0``.

    The loop's stopping test needs the residual norms on the host: the
    JAX package keeps the loop on the device (``lax.while_loop``), which
    has no PyTorch counterpart, so each iteration makes exactly one
    device-to-host read (one ``.item()``).  With ``REPRO_OBS=trace`` the
    worst column's residual of each step (``cg.resnorm``, the JAX
    package's stream) rides on that read.  Returns a `CGResult`; check
    ``converged`` (or ``resnorm``) rather than assuming ``maxiter``
    sufficed.
    """
    op = operator_on(a, device)
    mm = op.rmm if transpose else op.mm
    fused_a = op.a.contiguous() if (isinstance(op, DenseOperator)
                                    and not transpose) else None
    n = op.shape[-1]
    if maxiter is None:
        maxiter = 10 * n
    dev = device_of(op)
    b = torch.as_tensor(b).to(device=dev, dtype=op.dtype)
    lead = 0 if getattr(op, "batch", None) is None else 1
    if b.dim() not in (1 + lead, 2 + lead):
        raise ValueError(
            f"cg_solve: right-hand side {tuple(b.shape)} for an operator "
            f"{'with' if lead else 'without'} a batch axis; expected "
            f"{'(B, n) or (B, n, k)' if lead else '(n,) or (n, k)'}")
    vec = b.dim() == 1 + lead
    b2 = (b[..., :, None] if vec else b).contiguous()
    if b2.shape[-2] != n:
        raise ValueError(f"rhs rows {tuple(b2.shape)} do not match "
                         f"operator n={n}")

    d = op.diag() if precondition else None
    if d is None:
        def apply_minv(r):
            return r
    else:
        tiny = torch.finfo(op.dtype).tiny
        dinv = torch.where(d.abs() > tiny, 1.0 / d,
                           torch.ones_like(d))[..., :, None]

        def apply_minv(r):
            return dinv * r

    bnorm = torch.linalg.vector_norm(b2, dim=-2)              # (..., k)
    zero_rhs = bnorm == 0                                    # x = 0 exactly
    thresh = tol * bnorm + atol

    if x0 is None:
        x = torch.zeros_like(b2)
        r = b2
    else:
        x = torch.as_tensor(x0).to(device=dev, dtype=op.dtype)
        x = (x[..., :, None] if vec else x).contiguous()
        r = b2 - mm(x)
    z = apply_minv(r)
    p = z
    rz = (r * z).sum(-2)                                     # (..., k)

    def resnorm(r):
        return torch.linalg.vector_norm(r, dim=-2)

    trace = _telemetry.enabled()
    it = 0
    while it < maxiter:
        rn = resnorm(r)
        live = (rn > thresh) & ~zero_rhs
        if trace and it:
            # the previous step's worst residual, in the same host read
            more, worst = torch.stack([live.any().to(rn.dtype),
                                       rn.amax()]).tolist()
            _telemetry.emit_point("cg.resnorm", worst, it - 1)
        else:
            more = live.any().item()         # the one host read per step
        if not more:
            break
        if fused_a is not None:
            x, r = _kops.fused_cg_step(fused_a, p, x, r, rz)
        else:
            ap = mm(p)
            alpha = _safe_div(rz, (p * ap).sum(-2))[..., None, :]
            x = x + alpha * p
            r = r - alpha * ap
        z = apply_minv(r)
        rz_new = (r * z).sum(-2)
        beta = _safe_div(rz_new, rz)[..., None, :]
        p = z + beta * p
        rz = rz_new
        it += 1
    if trace and it and it == maxiter:
        _telemetry.emit_point("cg.resnorm", resnorm(r).amax(), it - 1)
    x = torch.where(zero_rhs[..., None, :], torch.zeros_like(x), x)
    rn = torch.where(zero_rhs, torch.zeros_like(bnorm), resnorm(r))
    out = x[..., :, 0] if vec else x
    return CGResult(out, it, rn, torch.all((rn <= thresh) | zero_rhs))
