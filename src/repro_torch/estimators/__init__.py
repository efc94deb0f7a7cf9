"""Stochastic log-determinant estimators (matrix-free, SPD input).

Counterpart of `repro.estimators`:

  hutchinson   probe generation + trace estimation with variance tracking
  chebyshev    stochastic Chebyshev expansion of log on a spectral interval
               (dense operators through the fused step K6)
  slq          stochastic Lanczos quadrature (no spectral bounds needed)
  operators    the `LinearOperator` protocol, the dense, stencil (K8)
               and mesh-sharded (K5) backends, and conjugate gradient
               `cg_solve` (dense: K7)
  grad         the autograd rules: `estimate_logdet` (differentiable
               dispatch), `exact_slogdet_vjp`, `hutchinson_pullback` and
               the operator registry (`register_operator_grad`)

Randomness comes from explicit `torch.Generator`s (``generator=``) or a
``seed``.  Not ported yet: the batched, Kronecker and Toeplitz backends
(and their gradient registrations), and `logdet_batched`.
"""
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
    "ESTIMATOR_METHODS", "estimate_logdet", "shared_probes",
    "exact_slogdet_vjp", "hutchinson_pullback", "stencil_apply",
    "OperatorGradInfo", "register_operator_grad", "operator_grad_info",
]
