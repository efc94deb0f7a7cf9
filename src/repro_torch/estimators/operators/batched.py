"""Batched backend: a (B, n, n) stack driven as one operator.

Counterpart of `repro.estimators.operators.batched`.  One estimator or
CG call drives the whole stack: every polynomial, Lanczos or CG step is
ONE batched product (`torch.matmul` on the batch, cuBLAS's batched GEMM
on the card), never B small ones.  Probe and right-hand-side slabs carry
a leading batch axis (B, n, k); estimates, bounds and CG's per-column
quantities (B,) / (B, k).  The JAX package computes these products
outside any Pallas kernel, so no kernel of the port runs here (the dense
fused steps K6/K7 take one matrix).
"""
from __future__ import annotations

import torch

from repro_torch.estimators.operators.base import LinearOperator, PlanHints

__all__ = ["BatchedOperator"]


class BatchedOperator(LinearOperator):
    """Wraps a (B, n, n) stack; slabs carry a leading batch axis (B, n, k).

    ``shape`` is one matrix's (n, n) and ``batch`` the stack size B.
    """

    def __init__(self, stack: torch.Tensor):
        stack = torch.as_tensor(stack)
        if stack.dim() != 3 or stack.shape[1] != stack.shape[2]:
            raise ValueError(f"expected (B, n, n) stack, got "
                             f"{tuple(stack.shape)}")
        self.stack = stack
        self.shape = tuple(stack.shape[1:])
        self.batch = stack.shape[0]
        self.dtype = stack.dtype
        self.device = stack.device

    def to(self, device) -> "BatchedOperator":
        """The same operator on ``device`` (this one is left alone)."""
        return BatchedOperator(self.stack.to(device))

    def mm(self, v):            # (B, n, k) -> (B, n, k)
        return torch.matmul(self.stack, v)

    def mv(self, v):            # (B, n) -> (B, n)
        return torch.matmul(self.stack, v[..., None])[..., 0]

    def rmm(self, v):           # (B, n, k) -> (B, n, k): A_b^T v_b
        return torch.matmul(self.stack.mT, v)

    def rmv(self, v):           # (B, n) -> (B, n)
        return torch.matmul(self.stack.mT, v[..., None])[..., 0]

    def diag(self):             # (B, n)
        return torch.diagonal(self.stack, dim1=-2, dim2=-1)

    def trace_hint(self):       # (B,)
        return self.diag().sum(-1)

    def to_dense(self):
        return self.stack

    def plan_hints(self):
        # per-matrix dense cost; the stack is resident, so the exact
        # engine runs on it too
        n = self.shape[-1]
        return PlanHints(structure="batched", matvec_flops=2.0 * n * n,
                         materializable=True)
