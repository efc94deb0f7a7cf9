"""Kronecker backend: ``A (nA, nA) ⊗ B (nB, nB)`` without materializing it.

Counterpart of `repro.estimators.operators.kron`.  Separable covariances
-- spatio-temporal grids, matrix-normal models, per-axis kernels -- factor
as ``Sigma = A ⊗ B`` with ``n = nA * nB``; the factors take O(nA^2 +
nB^2) memory where Sigma would take O(n^2).

The product uses the reshape identity (row-major flattening, index
``i = i1 * nB + i2``):

    (A ⊗ B) x = vec( A X B^T ),   X = reshape(x, (nA, nB))

-- two reshaped products per slab, ``A @ (nA, nB k)`` and ``B`` over the
``(nA, nB, k)`` view, O(n (nA + nB)) FLOPs per probe column.  The JAX
package leaves them to XLA (``einsum``), so here they are `torch.matmul`
(cuBLAS on the card), no kernel of the port.

``tr(A ⊗ B) = tr(A) tr(B)``, ``diag(A ⊗ B) = diag(A) ⊗ diag(B)`` and
``logdet(A ⊗ B) = nB logdet(A) + nA logdet(B)`` (the closed form the
checks use).
"""
from __future__ import annotations

import torch

from repro_torch.estimators.operators.base import (
    LinearOperator, PlanHints, check_square,
)

__all__ = ["KroneckerOperator"]


class KroneckerOperator(LinearOperator):
    """Implicit ``A ⊗ B`` for square factors A (nA, nA), B (nB, nB).

    The dtype is the factors' `torch.result_type`; the operator lives on
    ``device``, else on the left factor's device (the CPU for an array).
    """

    def __init__(self, a, b, *, device=None):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        check_square(a.shape, "left factor")
        check_square(b.shape, "right factor")
        self.dtype = torch.result_type(a, b)
        self.device = torch.device(device) if device is not None \
            else a.device
        self.a = a.to(device=self.device, dtype=self.dtype)
        self.b = b.to(device=self.device, dtype=self.dtype)
        self.na = a.shape[0]
        self.nb = b.shape[0]
        n = self.na * self.nb
        self.shape = (n, n)

    def to(self, device) -> "KroneckerOperator":
        """The same operator on ``device`` (this one is left alone)."""
        return KroneckerOperator(self.a, self.b, device=device)

    def _check_slab(self, v):
        if v.dim() != 2 or v.shape[0] != self.n:
            raise ValueError(f"expected ({self.n}, k) slab, got "
                             f"{tuple(v.shape)}")

    def _apply(self, a, b, v):
        """``(a ⊗ b) v`` as two reshaped products."""
        self._check_slab(v)
        k = v.shape[1]
        t = a @ v.reshape(self.na, self.nb * k)           # a over the left
        y = torch.matmul(b, t.view(self.na, self.nb, k))  # b over the right
        return y.reshape(self.n, k)

    def mm(self, v):  # (n, k) -> (n, k)
        return self._apply(self.a, self.b, v)

    def rmm(self, v):  # (n, k) -> (n, k): (A ⊗ B)^T = A^T ⊗ B^T
        return self._apply(self.a.T, self.b.T, v)

    def diag(self):
        d = self.a.diagonal()[:, None] * self.b.diagonal()[None, :]
        return d.reshape(self.n)

    def trace_hint(self):
        return torch.trace(self.a) * torch.trace(self.b)

    def to_dense(self):
        return torch.kron(self.a, self.b)

    def plan_hints(self):
        # two reshaped GEMMs: O(n (na + nb)) per column, never materialized
        return PlanHints(structure="kron",
                         matvec_flops=2.0 * self.n * (self.na + self.nb),
                         materializable=False)
