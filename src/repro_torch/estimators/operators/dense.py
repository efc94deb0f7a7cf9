"""Dense backend: wraps an in-memory (n, n) matrix.

Counterpart of `repro.estimators.operators.dense`.  ``mm`` is one
`torch.matmul` (cuBLAS on the card, in full f32: the port never enables
TF32), as the JAX package leaves ``a @ v`` to XLA outside any Pallas
kernel.  The estimators' dense hot loops do not call ``mm``: Chebyshev
and CG recognize a `DenseOperator` and take the fused kernels K6 / K7.
"""
from __future__ import annotations

import torch

from repro_torch.estimators.operators.base import (
    LinearOperator, PlanHints, check_square,
)

__all__ = ["DenseOperator"]


class DenseOperator(LinearOperator):
    """Wraps an in-memory (n, n) tensor."""

    def __init__(self, a: torch.Tensor):
        a = torch.as_tensor(a)
        check_square(a.shape)
        self.a = a
        self.shape = tuple(a.shape)
        self.dtype = a.dtype
        self.device = a.device

    def to(self, device) -> "DenseOperator":
        """The same operator on ``device`` (this one is left alone)."""
        return DenseOperator(self.a.to(device))

    def mm(self, v):
        return self.a @ v

    def mv(self, v):
        return self.a @ v

    def rmm(self, v):
        return self.a.T @ v

    def rmv(self, v):
        return self.a.T @ v

    def diag(self):
        return torch.diagonal(self.a)

    def trace_hint(self):
        return torch.trace(self.a)

    def to_dense(self):
        return self.a

    def plan_hints(self):
        n = self.n
        return PlanHints(structure="dense", matvec_flops=2.0 * n * n,
                         materializable=True)
