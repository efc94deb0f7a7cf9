"""Stochastic log-determinant estimators (matrix-free, SPD input).

Counterpart of `repro.estimators`:

  hutchinson   probe generation + trace estimation with variance tracking
  chebyshev    stochastic Chebyshev expansion of log on a spectral interval
               (dense operators through the fused step K6)
  slq          stochastic Lanczos quadrature (no spectral bounds needed)
  operators    the `LinearOperator` protocol, the dense, stencil (K8)
               and mesh-sharded (K5) backends, and conjugate gradient
               `cg_solve` (dense: K7)
  grad         `estimate_logdet`, the forward half of the JAX package's
               differentiable dispatch

Randomness comes from explicit `torch.Generator`s (``generator=``) or a
``seed``.  Not ported yet: the batched, Kronecker and Toeplitz backends,
the gradients and `hutchinson_pullback`, and `logdet_batched`.
"""
from repro_torch.estimators.chebyshev import (
    chebyshev_coeffs_log, logdet_chebyshev, spectral_bounds,
)
from repro_torch.estimators.grad import (
    ESTIMATOR_METHODS, estimate_logdet, shared_probes,
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
]
