"""Stochastic log-determinant estimators (matrix-free, SPD input).

Counterpart of `repro.estimators`:

  hutchinson   probe generation + trace estimation with variance tracking
  chebyshev    stochastic Chebyshev expansion of log on a spectral interval
               (dense operators through the fused step K6)
  slq          stochastic Lanczos quadrature (no spectral bounds needed)
  operators    the `LinearOperator` protocol, the dense, batched-stack,
               stencil (K8), mesh-sharded (K5), Kronecker and Toeplitz
               backends, and conjugate gradient `cg_solve` (dense: K7)
  grad         the autograd rules: `estimate_logdet` (differentiable
               dispatch), `exact_slogdet_vjp`, `hutchinson_pullback` and
               the operator registry (`register_operator_grad`)

Randomness comes from explicit `torch.Generator`s (``generator=``) or a
``seed``.  `logdet_batched` is the entry point for a (B, n, n) stack of
SPD matrices (GMM covariances).
"""
import torch

from repro_torch.estimators.chebyshev import (
    chebyshev_coeffs_log, logdet_chebyshev, spectral_bounds,
)
from repro_torch.estimators.grad import (
    ESTIMATOR_METHODS, OperatorGradInfo, estimate_logdet, exact_slogdet_vjp,
    hutchinson_pullback, operator_grad_info, register_operator_grad,
    shared_probes, stencil_apply,
)
from repro_torch.estimators.hutchinson import (
    TraceEstimate, hutchinson_trace, make_probes, mean_sem,
)
from repro_torch.estimators.operators import (
    BatchedOperator, CGResult, DenseOperator, KroneckerOperator,
    LinearOperator, PlanHints, ShardedOperator, StencilOperator,
    ToeplitzOperator, as_operator, cg_solve, is_operator, operator_on,
)
from repro_torch.estimators.slq import beta_pad, lanczos, logdet_slq

__all__ = [
    "TraceEstimate", "hutchinson_trace", "make_probes", "mean_sem",
    "logdet_chebyshev", "chebyshev_coeffs_log", "spectral_bounds",
    "logdet_slq", "lanczos", "beta_pad",
    "LinearOperator", "PlanHints", "DenseOperator", "StencilOperator",
    "BatchedOperator", "KroneckerOperator", "ToeplitzOperator",
    "ShardedOperator", "as_operator", "operator_on", "is_operator",
    "CGResult", "cg_solve",
    "ESTIMATOR_METHODS", "estimate_logdet", "logdet_batched",
    "shared_probes",
    "exact_slogdet_vjp", "hutchinson_pullback", "stencil_apply",
    "OperatorGradInfo", "register_operator_grad", "operator_grad_info",
]


def logdet_batched(stack, *, method: str = "chebyshev", device=None, **kw):
    """``log|det|`` of every matrix of an SPD (B, n, n) stack -> (B,), on
    ``device`` (``None`` is the card, ``"cpu"`` the plain versions).

    ``stack`` is a (B, n, n) tensor or array, or a batched operator (one
    with a ``batch`` axis, such as `BatchedOperator`), which needs an
    estimator method.  ``method`` is an estimator name or an exact route
    of one device (``"exact"`` with ``schedule=``/``update=``/``k=``...,
    or ``"ge"``), run on the whole stack through a plan
    (`repro_torch.plan`, which also raises for the mesh routes).  The
    other keywords go to the estimator or the plan (``num_probes``,
    ``degree`` / ``num_steps``, ``seed``, ``generator``, ``probes``, ...).
    Counterpart of `repro.estimators.logdet_batched`.
    """
    if is_operator(stack):
        if getattr(stack, "batch", None) is None:
            raise ValueError(
                "logdet_batched needs a batched operator (with a .batch "
                "axis); use estimate_logdet for a single operator")
        if method not in ESTIMATOR_METHODS:
            raise TypeError(
                f"method {method!r} needs a materialized (B, n, n) stack; "
                "operator inputs require an estimator method "
                f"{ESTIMATOR_METHODS}")
        return estimate_logdet(stack, method=method, device=device, **kw).est
    stack = torch.as_tensor(stack)
    if stack.dim() != 3 or stack.shape[1] != stack.shape[2]:
        raise ValueError(f"expected (B, n, n) stack, got {tuple(stack.shape)}")
    if method not in ESTIMATOR_METHODS:
        from repro_torch.core.plan import plan as _make_plan
        p = _make_plan(stack, method=method, device=device, validate=False,
                       **kw)
        return p.logdet(stack)
    return estimate_logdet(stack, method=method, device=device, **kw).est
